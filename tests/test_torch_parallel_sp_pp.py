"""The port's sequence and pipeline parallelism against the JAX package's,
on the CPU: ``sp_vae_reconstruct`` at 2 and 4 ranks (34 tokens, so 4 is the
uneven split) against ``ladiff_tpu.parallel.sp.sp_vae_reconstruct``, and its
gradient; ``pipeline_encoder_forward`` at (L, S, n_micro) in {(9, 3, 4),
(3, 3, 2), (9, 1, 2)} and unmasked against
``ladiff_tpu.parallel.pp.pipeline_encoder_forward``, and its gradient.  The
SP and PP training steps are held to the JAX step in
``tests/test_torch_parallel.py``.

Every port run is one spawn of 4 ranks (``tests/torch_parallel_ranks.py``);
the JAX side runs here on conftest's 8 virtual CPU devices.  Tolerances:
forwards within 1e-5 (absolute and relative); gradients within 1e-5 of
their largest element, as the JAX package's own SP test bounds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ladiff_torch.convert import flax_state_dict
from test_torch_modules import randomize

FWD_TOL = 1e-5
SP_VAE = dict(nfeats=19, latent_dim=(5, 64), ff_size=256, num_layers=3,
              num_heads=4, frame_per_latent=8)
PP_CASES = {"9-3-4": (9, 3, 4, True), "3-3-2": (3, 3, 2, True),
            "9-1-2": (9, 1, 2, True), "3-3-4-unmasked": (3, 3, 4, False)}
PP_D, PP_H, PP_F = 64, 4, 96


def _np_tree(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _grads_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        tol = 1e-5 * max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(got[name], w, atol=tol, rtol=1e-5,
                                   err_msg=name)


def _sp_setup():
    from ladiff_tpu.models.vae import LAVae
    rng = np.random.RandomState(0)
    feats = rng.randn(4, 24, 19).astype(np.float32)
    lengths = rng.randint(12, 25, size=(4,)).astype(np.int32)
    vae = LAVae(dropout=0.0, **SP_VAE)
    key = jax.random.PRNGKey(3)
    params = randomize(jax.eval_shape(vae.init, jax.random.PRNGKey(0), feats,
                                      lengths, key)["params"], 8)
    eps = np.asarray(jax.random.normal(key, (4, 5, 64), jnp.float32))
    return vae, params, feats, lengths, key, eps


def _pp_setup(L, B=8, T=7, seed=0):
    from ladiff_tpu.ops.stylization import MDSkipTransformerEncoder
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, T, PP_D) * 0.5).astype(np.float32)
    xf = rng.randn(B, 1, PP_D).astype(np.float32)
    emb = rng.randn(B, PP_D).astype(np.float32)
    valid = rng.randint(1, T + 1, size=(B, 1)) > np.arange(T)[None, :]
    w = rng.randn(B, T, PP_D).astype(np.float32)
    enc = MDSkipTransformerEncoder(PP_D, PP_D, PP_H, L, ffn_dim=PP_F,
                                   dropout=0.0)
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(0), x, xf, emb,
                            valid)["params"]
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.random.RandomState(a.size % 613).randn(
            *a.shape).astype(np.float32)) * 0.05, shapes)
    return enc, params, x, xf, emb, valid, w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and one 4-rank spawn of every port run."""
    from ladiff_tpu.parallel.pp import (make_pipe_mesh,
                                        pipeline_encoder_forward)
    from ladiff_tpu.parallel.sp import make_seq_mesh, sp_vae_reconstruct
    want, inputs, jobs = {}, {}, []

    vae, params, feats, lengths, key, eps = _sp_setup()
    sp_in = {"state": _np_tree(flax_state_dict(params)), "features": feats,
             "lengths": lengths, "eps": eps}
    vae_kw = dict(SP_VAE, latent_dim=list(SP_VAE["latent_dim"]))
    for n in (2, 4):
        out = sp_vae_reconstruct(vae, params, feats, lengths, key,
                                 mesh=make_seq_mesh(n))
        want[f"sp{n}"] = dict(zip(("feats", "z", "mu", "logvar", "valid"),
                                  map(np.asarray, out)))
        inputs[f"sp{n}"] = sp_in
        jobs.append((f"sp{n}", "sp_reconstruct", {"n_seq": n,
                                                  "vae": vae_kw}))

    def sp_loss(p):
        out = sp_vae_reconstruct(vae, p, feats, lengths, key,
                                 mesh=make_seq_mesh(4))
        return jnp.sum(out[0] ** 2) + jnp.sum(out[2] ** 2)

    want["sp_grad"] = _np_tree(flax_state_dict(
        jax.jit(jax.grad(sp_loss))(params)))

    for name, (L, S, n_micro, masked) in PP_CASES.items():
        enc, p, x, xf, emb, valid, w = _pp_setup(L, seed=5 if masked else 6)
        valid = valid if masked else None
        fwd = lambda q: pipeline_encoder_forward(
            enc, q, x, xf, emb, valid, mesh=make_pipe_mesh(S),
            n_micro=n_micro)
        want[f"pp{name}"] = {"y": np.asarray(jax.jit(fwd)(p))}
        if name == "3-3-2":
            g = jax.jit(jax.grad(lambda q: jnp.sum(fwd(q) * w)))(p)
            want[f"pp{name}"]["grads"] = _np_tree(flax_state_dict(g))
        inputs[f"pp{name}"] = {
            "state": _np_tree(flax_state_dict(p)), "x": x, "xf": xf,
            "emb": emb, "w": w, **({"valid": valid} if masked else {})}
        jobs.append((f"pp{name}", "pp_encoder", {
            "stages": S, "n_micro": n_micro,
            "encoder": {"d_model": PP_D, "text_latent_dim": PP_D,
                        "num_heads": PP_H, "num_layers": L,
                        "ffn_dim": PP_F}}))

    got = ranks.spawn(4, jobs, inputs, tmp_path_factory.mktemp("sp_pp"))
    return want, got


# -- sequence parallelism ---------------------------------------------------

@pytest.mark.parametrize("output", ["feats", "z", "mu", "logvar", "valid"])
@pytest.mark.parametrize("n_seq", [2, 4])
def test_sp_reconstruct_matches_jax(runs, n_seq, output):
    want, got = runs[0][f"sp{n_seq}"][output], runs[1][f"sp{n_seq}"]["out"]
    np.testing.assert_allclose(got[output].astype(np.float32),
                               want.astype(np.float32), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_sp_gradient_matches_jax(runs):
    """The VAE's gradient through the 4-way split (the uneven one),
    averaged over the group as the data-parallel mean takes it."""
    _grads_close(runs[1]["sp4"]["grads"], runs[0]["sp_grad"])


# -- pipeline parallelism ---------------------------------------------------

@pytest.mark.parametrize("case", list(PP_CASES))
def test_pipeline_forward_matches_jax(runs, case):
    """S stages x n_micro microbatches, the U-Net skips carried across
    stages, equal to the JAX GPipe program's output on every stage."""
    got = runs[1][f"pp{case}"]["y"]
    want = runs[0][f"pp{case}"]["y"]
    assert not np.allclose(got, 0.0)
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_pipeline_gradient_matches_jax(runs):
    """The explicit backward schedule's gradient (each stage's layers, the
    skip GEMMs, summed over the stages) equals ``jax.grad`` through the
    JAX schedule, leaf for leaf."""
    got = runs[1]["pp3-3-2"]["grads"]
    want = runs[0]["pp3-3-2"]["grads"]
    missing = set(want) - set(got)
    # leaves the graph never reaches (the collapsed cross-attention's query,
    # key and norm with one text token) get no gradient in the port
    assert all(np.abs(want[n]).max() == 0 for n in missing)
    _grads_close(got, {n: w for n, w in want.items() if n in got})


def test_stack_stage_params_identity_extension():
    """Layers without a skip GEMM get [I | 0] (cat(x, skip) -> x, exactly);
    output blocks carry their ``linear_blocks`` parameters themselves."""
    from ladiff_torch.ops.stylization import MDSkipTransformerEncoder
    from ladiff_torch.parallel.pp import stack_stage_params
    enc = MDSkipTransformerEncoder(16, 16, 2, 3, ffn_dim=32)
    staged = stack_stage_params(enc, 3)
    eye = torch.cat([torch.eye(16), torch.zeros(16, 16)], dim=1)
    for s in (0, 1):
        assert torch.equal(staged["wlin"][s][0], eye)
        assert not staged["blin"][s][0].any()
    assert staged["wlin"][2][0] is enc.linear_blocks[0].weight
    x, skip = torch.randn(4, 16), torch.randn(4, 16)
    assert torch.equal(torch.nn.functional.linear(torch.cat([x, skip], -1),
                                                  eye), x)
    with pytest.raises(ValueError, match="must divide"):
        stack_stage_params(MDSkipTransformerEncoder(16, 16, 2, 9), 2)
