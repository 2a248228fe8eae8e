"""The port's kernels K1..K4: each plain PyTorch version against the JAX
package's Pallas kernel it replaces, run in interpret mode on the CPU (as
tests/test_pallas_fused.py runs them).  The CUDA kernels themselves are
held to these plain versions by tests/test_torch_cuda.py on a GPU.

Tolerance for the plain-vs-Pallas tests: 1e-4 norm-wise relative error.
Both compute in float32; the Pallas kernels use an Abramowitz-Stegun erf
(1.5e-7) and their own sum order, ~1e-6 per layer.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_modules import port, randomize, relerr, rnd, t

TOL = 1e-4
D, H, FF = 128, 2, 256


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _lengths_mask(lengths, n):
    return np.arange(n)[None, :] < np.asarray(lengths)[:, None]


def _md_setup(seed, B=6, T=5, E=2):
    from ladiff_torch.ops.stylization import MDTransformerLayer as TL
    from ladiff_tpu.ops.stylization import MDTransformerLayer as JL
    rng = np.random.RandomState(seed)
    x = rnd(rng, B, T, D, scale=0.5)
    xf, emb = rnd(rng, B, 1, D), rnd(rng, B, D)
    jl = JL(D, D, FF, H, 0.0)
    p = randomize(jl.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(xf), jnp.asarray(emb))["params"],
                  seed + 1)
    tl = port(TL(D, D, FF, H), p)
    # mixed lengths 16..196 -> 1..5 active latent rows of 5
    kvalid = _lengths_mask(-(-np.array([16, 60, 100, 150, 196, 40][:B])
                             // 48), T).astype(np.float32)
    extra = rnd(rng, B * E, D)
    value = rnd(rng, B, D)
    return rng, p, tl, x.reshape(B * T, D), extra, kvalid.reshape(-1), value


@pytest.mark.parametrize("shared_rows", [True, False])
def test_md_layer_plain_matches_pallas(interpret, shared_rows):
    """K1: the sampling layout (one AdaLN row shared by every sample) and
    the per-sample layout."""
    from ladiff_torch.ops.md_layer import md_layer_plain
    from ladiff_tpu.ops.pallas_md_layer import fused_md_layer
    rng, p, tl, x, extra, kvalid, value = _md_setup(30)
    R = 1 if shared_rows else value.shape[0]
    ca_ss, ffn_ss = rnd(rng, R, 2 * D, scale=0.3), rnd(rng, R, 2 * D,
                                                        scale=0.3)
    want = fused_md_layer(
        jnp.asarray(x), jnp.asarray(extra), jnp.asarray(kvalid[:, None]),
        jnp.asarray(value), jnp.asarray(ca_ss[:, :D]),
        jnp.asarray(ca_ss[:, D:]), jnp.asarray(ffn_ss[:, :D]),
        jnp.asarray(ffn_ss[:, D:]), p["sa_block"], p["ca_block"]["proj_out"],
        p["ffn"], T=5, E=2, H=H)
    with torch.no_grad():
        got = md_layer_plain(t(x), t(extra), t(kvalid), t(value), t(ca_ss),
                             t(ffn_ss), tl.kernel_params(), T=5, E=2, H=H)
    assert relerr(got, want) <= TOL


def _decoder_layer_case(activation, T, lengths, frames_per_latent):
    """K2's plain version against the Pallas kernel on one batch: B =
    len(lengths) samples of T frames, 5 latent rows of which
    ceil(length / frames_per_latent) are valid."""
    from ladiff_torch.ops.decoder_layer import decoder_layer_plain
    from ladiff_torch.ops.transformer import TransformerDecoderLayer as TL
    from ladiff_tpu.ops.pallas_decoder_layer import fused_decoder_layer
    from ladiff_tpu.ops.transformer import TransformerDecoderLayer as JL
    rng = np.random.RandomState(31)
    B, L = len(lengths), 5
    x = rnd(rng, B, T, D, scale=0.5)
    mem = rnd(rng, B, L, D)
    kv = _lengths_mask(lengths, T).astype(np.float32)
    mv = _lengths_mask(-(-lengths // frames_per_latent), L).astype(np.float32)
    jl = JL(D, H, FF, 0.0, activation)
    p = randomize(jl.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(mem))["params"], 32)
    want = fused_decoder_layer(
        jnp.asarray(x.reshape(B * T, D)), jnp.asarray(kv.reshape(-1, 1)),
        jnp.asarray(mem), jnp.asarray(mv), p, T=T, L=L, H=H,
        activation=activation)
    tl = port(TL(D, H, FF, activation), p)
    with torch.no_grad():
        got = decoder_layer_plain(t(x.reshape(B * T, D)), t(kv.reshape(-1)),
                                  t(mem), t(mv), tl.kernel_params(), T=T,
                                  H=H, activation=activation)
    assert relerr(got, want) <= TOL


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_decoder_layer_plain_matches_pallas(interpret, activation):
    """K2 with mixed lengths: padded frames are masked keys."""
    _decoder_layer_case(activation, 24, np.array([24, 13, 5]), 6)


def test_decoder_layer_plain_matches_pallas_three_samples_a_block(
        interpret):
    """K2 at 3 x 40 frames (the CUDA tail's first 64-row block holds rows
    of two samples, its second a partial block of two), one sample seeing
    one valid latent row."""
    _decoder_layer_case("gelu", 40, np.array([40, 23, 7]), 8)


def _clip_weights(rng, Wd, Fd):
    """JAX-layout [in, out] weights and the port's [out, in] dict."""
    j = {"wq": rnd(rng, Wd, Wd, scale=Wd ** -0.5),
         "wk": rnd(rng, Wd, Wd, scale=Wd ** -0.5),
         "wv": rnd(rng, Wd, Wd, scale=Wd ** -0.5),
         "wo": rnd(rng, Wd, Wd, scale=Wd ** -0.5),
         "w1": rnd(rng, Wd, Fd, scale=Wd ** -0.5),
         "w2": rnd(rng, Fd, Wd, scale=Fd ** -0.5)}
    for b, n in (("bq", Wd), ("bk", Wd), ("bv", Wd), ("bo", Wd), ("b1", Fd),
                 ("b2", Wd), ("ln_b", Wd)):
        j[b] = rnd(rng, n, scale=0.05)
    j["ln_w"] = 1.0 + rnd(rng, Wd, scale=0.1)
    tp = {k: (t(v.T.copy()) if v.ndim == 2 else t(v)) for k, v in j.items()}
    return j, tp


def test_ln_qkv_plain_matches_pallas(interpret):
    """K3 at the 32-token bucket (B * S = 96 rows), CLIP width 128."""
    from ladiff_torch.ops.clip_layer import ln_qkv_plain
    from ladiff_tpu.ops.pallas_clip_layer import fused_ln_qkv
    rng = np.random.RandomState(33)
    Wd = 128
    x = rnd(rng, 3 * 32, Wd)
    j, tp = _clip_weights(rng, Wd, 4 * Wd)
    scale = 1.0 / math.sqrt(Wd // 2)
    want = fused_ln_qkv(jnp.asarray(x), j["wq"], j["bq"], j["wk"], j["bk"],
                        j["wv"], j["bv"], j["ln_w"], j["ln_b"], scale=scale)
    got = ln_qkv_plain(t(x), tp, scale=scale)
    for g, w in zip(got, want):
        assert relerr(g, w) <= TOL


def test_proj_mlp_plain_matches_pallas(interpret):
    """K4 at the 32-token bucket, CLIP width 128, MLP 512."""
    from ladiff_torch.ops.clip_layer import proj_mlp_plain
    from ladiff_tpu.ops.pallas_clip_layer import fused_proj_mlp
    rng = np.random.RandomState(34)
    Wd = 128
    att, x = rnd(rng, 3 * 32, Wd), rnd(rng, 3 * 32, Wd)
    j, tp = _clip_weights(rng, Wd, 4 * Wd)
    want = fused_proj_mlp(jnp.asarray(att), jnp.asarray(x), j["wo"], j["bo"],
                          j["w1"], j["b1"], j["w2"], j["b2"], j["ln_w"],
                          j["ln_b"])
    assert relerr(proj_mlp_plain(t(att), t(x), tp), want) <= TOL


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors a wrapper returns its plain version and counts no
    launch."""
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.ops.clip_layer import fused_proj_mlp, proj_mlp_plain
    rng = np.random.RandomState(35)
    _, tp = _clip_weights(rng, 64, 256)
    att, x = t(rnd(rng, 8, 64)), t(rnd(rng, 8, 64))
    before = cc.launch_counts()
    assert set(before) >= {"fused_md_layer", "fused_decoder_layer",
                           "fused_ln_qkv", "fused_proj_mlp"}
    assert torch.equal(fused_proj_mlp(att, x, tp), proj_mlp_plain(att, x, tp))
    assert cc.launch_counts() == before
