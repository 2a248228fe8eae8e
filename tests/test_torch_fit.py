"""The port's SMPL fitting against the JAX package on the CPU: the priors
(``ladiff_torch.smpl.prior`` against ``ladiff_tpu.smpl.prior``) and
``create_prior``'s fallbacks, ``fit_sequence`` against the root ``fit.py``'s
with the L2 and the GMM prior, and ``python -m ladiff_torch.fit`` on the
HumanML3D and KIT branches, with ``--save_folder``, a malformed file and a
missing body, against the root script's ``.npz`` files.

Sizes: the synthetic 128-vertex SMPL body, 8 frames, a 6-Gaussian mixture
over 69 dimensions, 20 Adam steps (5 through the entry points).
Tolerances: the priors 1e-5 relative; after 20 steps the loss within 1e-4
relative and every parameter within 1e-4 absolute (torch's Adam against
optax's, both float32; the same update formula, rounded in another
order); the entry points' files within 1e-4 absolute.
"""
import importlib.util
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import body_model_from_jax, gmm_prior_from_jax
from ladiff_torch.smpl import prior as port
from ladiff_tpu.smpl import prior as ref
from ladiff_tpu.smpl.body_model import SMPLModel as JaxSMPL
from test_torch_slice import relerr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIOR_TOL, LOSS_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-4


def _root_fit():
    """The root ``fit.py``, loaded by path (a bare ``import fit`` can find
    another module of that name on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(
        "ladiff_root_fit_for_port", os.path.join(REPO, "fit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gmm_dir(tmp_path, seed=0):
    with open(tmp_path / "gmm_06.pkl", "wb") as f:
        pickle.dump(port.synthetic_gmm(seed), f)
    return str(tmp_path)


# -- priors ------------------------------------------------------------------

def test_angle_l2_and_gmof_match_jax():
    rng = np.random.RandomState(1)
    pose = rng.randn(5, 69).astype(np.float32)
    x = (50 * rng.randn(4, 24, 3)).astype(np.float32)
    t = torch.from_numpy
    assert relerr(port.angle_prior(t(pose)).numpy(),
                  ref.angle_prior(jnp.asarray(pose))) <= PRIOR_TOL
    assert relerr(port.l2_prior(t(pose)).numpy(),
                  ref.l2_prior(jnp.asarray(pose))) <= PRIOR_TOL
    assert relerr(port.gmof(t(x), 100.0).numpy(),
                  ref.gmof(jnp.asarray(x), 100.0)) <= PRIOR_TOL


class _SklearnLike:
    def __init__(self, d):
        self.means_, self.covars_, self.weights_ = (
            d["means"], d["covars"], d["weights"])


@pytest.mark.parametrize("source", ["dict_pkl", "sklearn_pkl", "arrays",
                                    "from_jax"])
def test_gmm_prior_matches_jax(tmp_path, source):
    """``MaxMixturePrior`` from a ``gmm_06.pkl`` (a dict or a scikit-learn
    mixture), from arrays, or converted: its buffers and the min-mixture
    NLL against the JAX prior (the NLL compared, not which mixture won)."""
    gmm = port.synthetic_gmm(2)
    theirs = ref.MaxMixturePrior.from_arrays(gmm["means"], gmm["covars"],
                                             gmm["weights"])
    if source == "arrays":
        ours = port.MaxMixturePrior.from_arrays(gmm["means"], gmm["covars"],
                                                gmm["weights"])
    elif source == "from_jax":
        ours = gmm_prior_from_jax(theirs)
    else:
        obj = gmm if source == "dict_pkl" else _SklearnLike(gmm)
        with open(tmp_path / "gmm_06.pkl", "wb") as f:
            pickle.dump(obj, f)
        ours = port.MaxMixturePrior.load(str(tmp_path))
        assert port.MaxMixturePrior.load(str(tmp_path / "gmm_06.pkl")
                                         ) is not None
    for name in ("means", "precisions", "log_nll_weights"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)))
    pose = np.random.RandomState(3).randn(16, 69).astype(np.float32) * 0.3
    assert relerr(ours(torch.from_numpy(pose)).numpy(),
                  theirs(jnp.asarray(pose))) <= PRIOR_TOL
    assert not ours.state_dict()  # buffers move with .to, saved nowhere


def test_create_prior_fallbacks(tmp_path):
    """A missing GMM folder gives the L2 prior, as in the JAX package;
    "l2", "angle" and "none"; an unknown type raises."""
    assert port.create_prior("gmm", str(tmp_path / "missing")) is \
        port.l2_prior
    assert isinstance(port.create_prior("gmm", _gmm_dir(tmp_path)),
                      port.MaxMixturePrior)
    assert port.create_prior("l2") is port.l2_prior
    assert port.create_prior("angle") is port.angle_prior
    assert port.create_prior("none")(torch.zeros(2, 69)) == 0.0
    assert ref.create_prior("none")(np.zeros((2, 69))) == 0.0
    with pytest.raises(ValueError):
        port.create_prior("vposer")


# -- fit_sequence ------------------------------------------------------------

def _target(seed=0, T=8, J=22):
    """The JAX body and the joints of a random pose through it (made by the
    port's copy of the body: the target is data, not a comparison)."""
    body = JaxSMPL.synthetic()
    rng = np.random.RandomState(seed)
    pose = (0.2 * rng.randn(T, 24, 3)).astype(np.float32)
    trans = (0.3 * rng.randn(T, 3)).astype(np.float32)
    with torch.no_grad():
        joints = body_model_from_jax(body)(
            torch.from_numpy(pose), torch.zeros(10),
            torch.from_numpy(trans)).numpy()
    return body, joints[:, :J]


@pytest.mark.parametrize("prior", ["l2", "gmm"])
def test_fit_sequence_matches_root_fit(tmp_path, prior):
    """20 Adam steps from the same start: the loss of the last step (before
    its update, as ``value_and_grad`` gives it) and every parameter."""
    gmm_dir = (_gmm_dir(tmp_path, 4) if prior == "gmm"
               else str(tmp_path / "no_gmm"))
    body, target = _target()
    from ladiff_torch.fit import fit_sequence
    want, want_loss = _root_fit().fit_sequence(body, target, iters=20,
                                               gmm_dir=gmm_dir)
    got, got_loss = fit_sequence(body_model_from_jax(body), target, iters=20,
                                 gmm_dir=gmm_dir, device="cpu")
    assert abs(got_loss - want_loss) <= LOSS_TOL * abs(want_loss)
    for k in ("pose", "betas", "trans"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=k)
    # the returned loss is the one before the last update: the loss at the
    # returned parameters is the 21st step's, not the 20th's
    from ladiff_torch.fit import fit_loss
    model = body_model_from_jax(body)
    after = float(fit_loss(model, {k: torch.from_numpy(v)
                                   for k, v in got.items()},
                           torch.tensor(target),
                           port.create_prior("gmm", gmm_dir), 1e-3))
    _, loss21 = fit_sequence(model, target, iters=21, gmm_dir=gmm_dir,
                             device="cpu")
    assert after != got_loss and abs(after - loss21) <= 1e-6 * abs(loss21)


def test_fit_sequence_recovers_joints(tmp_path):
    """The fit brings the joints towards the target (the prior keeps a floor
    on the loss)."""
    from ladiff_torch.fit import fit_sequence
    jbody, target = _target(5, T=3, J=24)
    body = body_model_from_jax(jbody)
    params, loss = fit_sequence(body, target, iters=150, device="cpu",
                                gmm_dir=_gmm_dir(tmp_path, 6))
    assert np.isfinite(loss)
    fitted = body(*(torch.from_numpy(params[k]) for k in
                    ("pose", "betas", "trans")))
    start = body(torch.zeros(3, 24, 3), torch.zeros(10),
                 torch.tensor(target[:, 0]))
    err0 = np.abs(start.numpy() - target).mean()
    assert np.abs(fitted.numpy() - target).mean() < 0.5 * err0


# -- the entry point ---------------------------------------------------------

@pytest.fixture()
def smpl_pkl(tmp_path):
    """A small SMPL asset in the release's layout (kintree [2, J], posedirs
    [V, 3, (J-1) 9], 16 shape columns)."""
    rs = np.random.RandomState(0)
    V, J = 40, 24
    kintree = np.zeros((2, J), np.int64)
    kintree[0] = np.concatenate(
        [[2 ** 32 - 1], [rs.randint(0, j) for j in range(1, J)]])
    d = {"v_template": rs.randn(V, 3) * 0.1,
         "shapedirs": rs.randn(V, 3, 16) * 0.01,
         "posedirs": rs.randn(V, 3, (J - 1) * 9) * 0.01,
         "J_regressor": np.abs(rs.rand(J, V)),
         "weights": np.abs(rs.rand(V, J)), "kintree_table": kintree}
    d["J_regressor"] /= d["J_regressor"].sum(1, keepdims=True)
    d["weights"] /= d["weights"].sum(1, keepdims=True)
    path = str(tmp_path / "SMPL_NEUTRAL.pkl")
    with open(path, "wb") as f:
        pickle.dump(d, f)
    return path


def _run_both(monkeypatch, tmp_path, argv, name):
    """The root script and the port's entry point on the same files, each
    writing to a folder of its own; the port's printout."""
    from ladiff_torch import fit
    root = _root_fit()
    monkeypatch.setattr(sys, "argv", ["fit.py"] + argv + [
        "--save_folder", str(tmp_path / f"root_{name}")])
    root.main()
    fit.main(argv + ["--save_folder", str(tmp_path / f"port_{name}"),
                     "--cpu"])


def _same_npz(a, b):
    want, got = np.load(a), np.load(b)
    assert sorted(got.files) == sorted(want.files) == ["betas", "pose",
                                                       "trans"]
    for k in want.files:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("branch", ["humanml3d", "kit"])
def test_entry_point_matches_root_script(tmp_path, smpl_pkl, monkeypatch,
                                         capsys, branch):
    """22 joints pass through; 21 (KIT's MMM joints) are decimated 100 ->
    12.5 fps and scaled into SMPL-H units first.  A malformed file in the
    folder is skipped with a message; the outputs equal the root
    script's."""
    rs = np.random.RandomState(1)
    data = tmp_path / "in"
    data.mkdir()
    if branch == "kit":
        joints = (rs.randn(40, 21, 3) * 50.0).astype(np.float32)
        argv = ["--num_joints", "21"]
    else:
        joints = (rs.randn(6, 22, 3) * 0.05).astype(np.float32)
        argv = []
    np.save(data / "sample_000.npy", joints)
    np.save(data / "bad.npy", np.zeros((5, 3), np.float32))
    _run_both(monkeypatch, tmp_path, argv + [
        "--dir", str(data), "--iters", "5", "--smpl", smpl_pkl,
        "--gmm", str(tmp_path / "no_gmm")], branch)
    out = capsys.readouterr().out
    assert out.count("skipping") == 2 and "final loss" in out
    got = tmp_path / f"port_{branch}" / "sample_000_smpl.npz"
    frames = 5 if branch == "kit" else 6
    assert np.load(got)["pose"].shape == (frames, 24, 3)
    _same_npz(tmp_path / f"root_{branch}" / "sample_000_smpl.npz", got)
    assert not (tmp_path / f"port_{branch}" / "bad_smpl.npz").exists()


def test_entry_point_synthetic_body_and_default_output(tmp_path,
                                                       monkeypatch, capsys):
    """Without the SMPL ``.pkl`` both scripts warn and fit the synthetic
    body; with no ``--save_folder`` the file lands next to its input."""
    from ladiff_torch import fit
    joints = (np.random.RandomState(2).randn(4, 22, 3) * 0.1).astype(
        np.float32)
    npy = tmp_path / "s.npy"
    np.save(npy, joints)
    argv = ["--npy", str(npy), "--iters", "3", "--smpl",
            str(tmp_path / "absent.pkl"), "--gmm", str(tmp_path / "no_gmm")]
    monkeypatch.setattr(sys, "argv", ["fit.py"] + argv)
    _root_fit().main()
    os.rename(tmp_path / "s_smpl.npz", tmp_path / "root.npz")
    fit.main(argv + ["--cpu"])
    assert capsys.readouterr().out.count("WARNING: SMPL model not found") == 2
    _same_npz(tmp_path / "root.npz", tmp_path / "s_smpl.npz")
    with pytest.raises(SystemExit):
        fit.main(["--cpu"])


def test_module_runs_and_defaults_to_the_card(tmp_path):
    """``python -m ladiff_torch.fit`` parses the root script's flags; with
    no GPU and no ``--cpu`` it refuses instead of fitting on the CPU (with
    a GPU it fits there)."""
    np.save(tmp_path / "s.npy", np.zeros((3, 22, 3), np.float32))
    cmd = [sys.executable, "-m", "ladiff_torch.fit", "--npy",
           str(tmp_path / "s.npy"), "--iters", "2", "--smpl",
           str(tmp_path / "absent.pkl"), "--gmm", str(tmp_path)]
    res = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    if torch.cuda.is_available():
        assert res.returncode == 0, res.stderr
        assert np.load(tmp_path / "s_smpl.npz")["pose"].shape == (3, 24, 3)
    else:
        assert res.returncode != 0 and "CUDA device" in res.stderr
        assert not (tmp_path / "s_smpl.npz").exists()
