"""The port's SMPL-family body models against the JAX package on the CPU:
every model type's synthetic draw, ``load`` from ``.pkl`` / ``.npz`` with
SMPL-H's mean hands, ``load_mano`` and ``load_flame`` (full and reduced
shape spaces), the forwards (axis-angle, matrices, MANO's PCA, FLAME's
expressions) and their gradients, and ``convert.body_model_from_jax``.

Sizes: the JAX default of 128 vertices (40 for the MANO and FLAME file
fixtures), 4 frames.  Tolerances, norm-wise relative, float32 on both sides: joints and
vertices 1e-5, gradients 1e-4 (``jax.grad`` against autograd through the
chain of 4 x 4 products).  The JAX forward takes the model's arrays as
arguments, so it compiles once per kinematic chain and shape, with its
gradient, and every case of that chain shares it.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import body_model_from_jax
from ladiff_torch.smpl import body_model as port
from ladiff_tpu.smpl import body_model as ref
from test_torch_slice import relerr

FWD_TOL, GRAD_TOL, T = 1e-5, 1e-4, 4
MODEL_TYPES = ("smpl", "smplh", "smplx", "mano", "flame")
ARRAYS = ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
          "hand_components", "hand_mean", "expr_dirs")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _same_arrays(ours, theirs):
    for name in ARRAYS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    np.testing.assert_array_equal(ours.parents, theirs.parents)
    if theirs.hands_mean is None:
        assert ours.hands_mean is None
    else:
        np.testing.assert_array_equal(ours.hands_mean, theirs.hands_mean)


def _inputs(J, seed=0, scale=0.4):
    rng = np.random.RandomState(seed)
    return ((scale * rng.randn(T, J, 3)).astype(np.float32),
            (0.5 * rng.randn(10)).astype(np.float32),
            rng.randn(T, 3).astype(np.float32),
            rng.randn(10).astype(np.float32))


_JAX_COMPILED = {}


def _jax_forward(theirs, *inputs):
    """((sum of squared joints and sin(vertices), (joints, vertices)), its
    gradient in (pose, betas, trans, expression)) of the JAX ``forward``.
    The model's arrays are arguments, so the function compiles once per
    kinematic chain and shape, at XLA's lowest backend optimization level
    (it is a reference, and the unrolled chain of 52 or 55 joints takes
    seconds to optimize)."""
    parents = tuple(int(p) for p in theirs.parents)
    arrays = {k: getattr(theirs, k) for k in (
        "v_template", "shapedirs", "posedirs", "J_regressor", "weights",
        "expr_dirs")}
    args = (arrays,) + tuple(jnp.asarray(x) for x in inputs)
    key = (parents, str(jax.tree_util.tree_map(jnp.shape, args)))
    if key not in _JAX_COMPILED:
        def loss(arrays, aa, betas, trans, expr):
            model = ref.SMPLModel(parents=np.asarray(parents), **arrays)
            j, v = model.forward(aa, betas, trans, return_vertices=True,
                                 expression=expr)
            return jnp.sum(j ** 2) + jnp.sum(jnp.sin(v)), (j, v)

        _JAX_COMPILED[key] = jax.jit(jax.value_and_grad(
            loss, argnums=(1, 2, 3, 4), has_aux=True)).lower(*args).compile(
                {"xla_backend_optimization_level": 0})
    return _JAX_COMPILED[key](*args)


def _forward_agrees(ours, theirs, seed=0):
    J = len(theirs.parents)
    aa, betas, trans, expr = _inputs(J, seed)
    (_, (jj, jv)), _ = _jax_forward(theirs, aa, betas, trans, expr)
    tj, tv = ours.forward(_t(aa), _t(betas), _t(trans), return_vertices=True,
                          expression=_t(expr))
    assert tj.shape == (T, J, 3) and tv.shape == jv.shape
    assert relerr(tj.numpy(), jj) <= FWD_TOL
    assert relerr(tv.numpy(), jv) <= FWD_TOL


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_synthetic_draw_and_forward(model_type):
    """``synthetic(model_type=)`` draws the JAX body tensor for tensor (MANO's
    basis and FLAME's expressions before the blendshapes); the forward's
    joints and vertices, with translation and expression, agree."""
    ours = port.SMPLModel.synthetic(seed=3, model_type=model_type)
    theirs = ref.SMPLModel.synthetic(seed=3, model_type=model_type)
    _same_arrays(ours, theirs)
    assert ours.num_joints == len(ref.SMPLModel.synthetic(
        model_type=model_type).parents)
    _forward_agrees(ours, theirs)


def test_parent_tables():
    for name in ("SMPL_PARENTS", "SMPLH_PARENTS", "SMPLX_PARENTS",
                 "MANO_PARENTS", "FLAME_PARENTS"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), name)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_gradients_match_jax(model_type):
    """d(sum of squared joints and vertices) / d(pose, betas, trans,
    expression) against ``jax.grad``."""
    theirs = ref.SMPLModel.synthetic(seed=5, model_type=model_type)
    ours = port.SMPLModel.synthetic(seed=5, model_type=model_type)
    aa, betas, trans, expr = _inputs(len(theirs.parents), 7)
    _, want = _jax_forward(theirs, aa, betas, trans, expr)
    leaves = [_t(x).requires_grad_(True) for x in (aa, betas, trans, expr)]
    j, v = ours.forward(*leaves[:3], return_vertices=True,
                        expression=leaves[3])
    (torch.sum(j ** 2) + torch.sum(torch.sin(v))).backward()
    for name, leaf, w in zip(("pose", "betas", "trans", "expression"),
                             leaves, want):
        if model_type != "flame" and name == "expression":
            assert not np.asarray(w).any() and leaf.grad is None
            continue
        assert relerr(leaf.grad.numpy(), w) <= GRAD_TOL, name


def _layout(src, hands=False, mano=False, shape_cols=None):
    """A model's arrays in the on-disk layout: posedirs [V, 3, (J-1) 9], a
    kintree table, optional mean hands / MANO PCA / a wide shape space."""
    V = np.asarray(src.v_template).shape[0]
    J = len(src.parents)
    d = {"v_template": np.asarray(src.v_template, np.float64),
         "shapedirs": np.asarray(src.shapedirs, np.float64),
         "posedirs": np.asarray(src.posedirs, np.float64).T.reshape(V, 3, -1),
         "J_regressor": np.asarray(src.J_regressor, np.float64),
         "weights": np.asarray(src.weights, np.float64),
         "kintree_table": np.stack([
             np.concatenate([[2 ** 32 - 1], np.asarray(src.parents[1:],
                                                        np.int64)]),
             np.arange(J)])}
    rng = np.random.RandomState(J)
    if hands:
        d["hands_meanl"] = 0.1 * rng.randn(45)
        d["hands_meanr"] = 0.1 * rng.randn(45)
    if mano:
        d["hands_components"] = np.linalg.qr(rng.randn(45, 45))[0]
        d["hands_mean"] = 0.05 * rng.randn(45)
    if shape_cols:
        d["shapedirs"] = 0.01 * rng.randn(V, 3, shape_cols)
    return d


def _write(d, path):
    if path.endswith(".npz"):
        np.savez(path, **d)
    else:
        with open(path, "wb") as f:
            pickle.dump(d, f)
    return path


@pytest.mark.parametrize("ext", [".pkl", ".npz"])
def test_load_smplh_with_hands_mean(tmp_path, ext):
    """``load`` of an SMPL-H file: posedirs transposed, the kintree's
    parents, the mean hands [30, 3] (left then right); a missing file
    gives None."""
    src = ref.SMPLModel.synthetic(seed=1, model_type="smplh")
    path = _write(_layout(src, hands=True), str(tmp_path / f"SMPLH{ext}"))
    ours, theirs = port.SMPLModel.load(path), ref.SMPLModel.load(path)
    assert ours.hands_mean.shape == (30, 3)
    _same_arrays(ours, theirs)
    _forward_agrees(ours, theirs, seed=2)
    assert port.SMPLModel.load(str(tmp_path / f"absent{ext}")) is None


@pytest.mark.parametrize("use_pca,flat_hand_mean,n_pca",
                         [(True, False, 6), (True, True, 12),
                          (False, False, 45)])
def test_load_mano_and_forward(tmp_path, use_pca, flat_hand_mean, n_pca):
    """``load_mano`` keeps the 45 x 45 PCA basis and the mean hand;
    ``forward_mano`` maps PCA coordinates (or raw axis-angle) and adds the
    mean unless ``flat_hand_mean``."""
    src = ref.SMPLModel.synthetic(n_verts=40, seed=2, model_type="mano")
    path = _write(_layout(src, mano=True), str(tmp_path / "MANO_RIGHT.pkl"))
    ours, theirs = port.SMPLModel.load_mano(path), ref.SMPLModel.load_mano(
        path)
    _same_arrays(ours, theirs)
    rng = np.random.RandomState(3)
    go = (0.2 * rng.randn(T, 3)).astype(np.float32)
    hand = (0.3 * rng.randn(T, n_pca)).astype(np.float32)
    betas = (0.5 * rng.randn(10)).astype(np.float32)
    kw = dict(use_pca=use_pca, flat_hand_mean=flat_hand_mean,
              return_vertices=True)
    jj, jv = jax.jit(lambda *a: theirs.forward_mano(*a, **kw))(go, hand,
                                                               betas)
    tj, tv = ours.forward_mano(_t(go), _t(hand), _t(betas), **kw)
    assert tj.shape == (T, 16, 3)
    assert relerr(tj.numpy(), jj) <= FWD_TOL
    assert relerr(tv.numpy(), jv) <= FWD_TOL
    assert port.SMPLModel.load_mano(str(tmp_path / "absent.pkl")) is None


@pytest.mark.parametrize("shape_cols,n_expr", [(400, 10), (400, 50),
                                               (20, 10), (20, 4)])
def test_load_flame_and_forward(tmp_path, shape_cols, n_expr):
    """``load_flame``: the expression block of a 300 + 100 shape space, or
    columns 10 to 20 of a reduced 10 + 10 one; ``forward_flame`` blends the
    expression coefficients."""
    src = ref.SMPLModel.synthetic(n_verts=40, seed=3, model_type="flame")
    path = _write(_layout(src, shape_cols=shape_cols),
                  str(tmp_path / "FLAME.pkl"))
    ours = port.SMPLModel.load_flame(path, num_expression_coeffs=n_expr)
    theirs = ref.SMPLModel.load_flame(path, num_expression_coeffs=n_expr)
    _same_arrays(ours, theirs)
    rng = np.random.RandomState(4)
    rots = [(0.2 * rng.randn(T, 3)).astype(np.float32) for _ in range(5)]
    betas = (0.5 * rng.randn(10)).astype(np.float32)
    expr = rng.randn(ours.expr_dirs.shape[-1]).astype(np.float32)
    jj, jv = jax.jit(lambda *a: theirs.forward_flame(
        *a[:6], expression=a[6], return_vertices=True))(*rots, betas, expr)
    tj, tv = ours.forward_flame(*map(_t, rots), _t(betas),
                                expression=_t(expr), return_vertices=True)
    assert tj.shape == (T, 5, 3)
    assert relerr(tj.numpy(), jj) <= FWD_TOL
    assert relerr(tv.numpy(), jv) <= FWD_TOL
    assert port.SMPLModel.load_flame(str(tmp_path / "absent.pkl")) is None


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_body_model_from_jax(model_type):
    """``convert.body_model_from_jax`` carries every array across; the
    matrix forward of the converted model (on the matrices of the poses)
    agrees with the JAX forward of the axis-angle poses."""
    theirs = ref.SMPLModel.synthetic(seed=9, model_type=model_type)
    ours = body_model_from_jax(theirs)
    _same_arrays(ours, theirs)
    J = len(theirs.parents)
    aa, betas, trans, expr = _inputs(J, 11)
    from ladiff_torch.transforms.geometry import axis_angle_to_matrix
    rot = axis_angle_to_matrix(aa).astype(np.float32)
    (_, (jj, jv)), _ = _jax_forward(theirs, aa, betas, trans, expr)
    tj, tv = ours.forward_matrices(_t(rot), _t(betas), _t(trans),
                                   return_vertices=True,
                                   expression=_t(expr))
    assert relerr(tj.numpy(), jj) <= FWD_TOL
    assert relerr(tv.numpy(), jv) <= FWD_TOL


def test_buffers_follow_the_module():
    """The arrays are non-persistent float32 buffers (``.to`` moves them,
    the state dict carries none); absent optional ones stay None."""
    m = port.SMPLModel.synthetic(model_type="flame").to(torch.float64)
    assert m.v_template.dtype == torch.float64
    assert m.expr_dirs.dtype == torch.float64 and m.hand_components is None
    assert not m.state_dict()
