"""The port's VQ-VAE stack, ``MldVaeT2m`` and ``VPosert`` against the JAX
package on the CPU, on converted weights: ``Resnet1D`` for each norm and
activation, ``Encoder1D`` / ``Decoder1D`` (at a frame count that 2^down_t
does not divide: the port keeps the JAX output length), ``nearest_code``,
``perplexity``, ``ema_init`` / ``ema_update`` (reset on and off) with the
JAX draws replayed, ``VQVae`` in the ``orig`` and EMA flavours (output,
loss, perplexity, indices, and the straight-through gradients against
``jax.grad``), ``HumanVQDiff`` at its published width, ``MldVaeT2m``, and
``VPosert`` (the mean and a replayed sample; its BatchNorms on their running
statistics).  The JAX package's torch converters
(``convert_torch_mld_vae_t2m``, ``convert_torch_encdec``,
``convert_torch_vposert``) applied to the port's ``state_dict()`` give back
the JAX params bit for bit, which ties the port's names to the reference
layout.

The port computes in ``[B, C, T]``; the JAX package channels-last.
Tolerances (PERF.md section 2): forwards and gradients 1e-4 norm-wise, the
EMA state 1e-6, codes and code counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch import convert
from ladiff_torch.models import mld_vae_t2m as port_t2m
from ladiff_torch.models import vposert_vae as port_vp
from ladiff_torch.models import vq as port
from ladiff_tpu.models import mld_vae_t2m as ref_t2m
from ladiff_tpu.models import vposert_vae as ref_vp
from ladiff_tpu.models import vq as ref
from torch_alt_helpers import (TOL, flat_tree, jitted, loaded, noise_tree,
                               relerr, shapes, t)

SMALL = dict(down_t=2, width=64, depth=2, dilation_growth_rate=3)


def _ct(a):
    """channels-last [B, T, C] numpy -> [B, C, T] tensor."""
    return t(a).transpose(1, 2)


def _assert_same_tree(got, want):
    got, want = flat_tree(got), flat_tree(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("norm", [None, "LN", "GN"])
@pytest.mark.parametrize("activation", ["relu", "silu", "gelu"])
def test_resnet1d_matches_jax(norm, activation):
    jm = ref.Resnet1D(2, 3, activation=activation, norm=norm)
    x = np.random.RandomState(0).randn(2, 11, 64).astype(np.float32)
    params = noise_tree(shapes(jm, x), 1)["params"]
    want = jitted(jm)({"params": params}, x)
    tree = {"model": {k.split("_")[1]: v for k, v in params.items()}}
    m = loaded(port.Resnet1D(64, 2, 3, activation=activation, norm=norm),
               convert.flax_state_dict(tree))
    with torch.no_grad():
        got = m(_ct(x)).transpose(1, 2)
    assert relerr(got.numpy(), want) <= TOL


@pytest.mark.parametrize("frames", [16, 18])
def test_encoder_decoder_match_jax(frames):
    enc_j = ref.Encoder1D(output_emb_width=64, **SMALL)
    dec_j = ref.Decoder1D(out_feats=12, **SMALL)
    x = np.random.RandomState(2).randn(2, frames, 12).astype(np.float32)
    pe = noise_tree(shapes(enc_j, x), 3)["params"]
    z = jitted(enc_j)({"params": pe}, x)
    pd = noise_tree(shapes(dec_j, z), 4)["params"]
    y = jitted(dec_j)({"params": pd}, z)
    enc = loaded(port.Encoder1D(12, 64, **SMALL), convert.flax_state_dict(
        convert._encdec_tree(pe, "encoder")))
    dec = loaded(port.Decoder1D(12, 64, **SMALL), convert.flax_state_dict(
        convert._encdec_tree(pd, "decoder")))
    with torch.no_grad():
        zt = enc(_ct(x))
        yt = dec(zt)
    assert zt.shape == (2, 64, frames // 4) and yt.shape[2] == y.shape[1]
    assert relerr(zt.transpose(1, 2).numpy(), z) <= TOL
    assert relerr(yt.transpose(1, 2).numpy(), y) <= TOL


def test_nearest_code_and_perplexity_match_jax():
    rng = np.random.RandomState(5)
    cb = rng.randn(16, 8).astype(np.float32)
    x = rng.randn(3, 7, 8).astype(np.float32)
    idx = port.nearest_code(t(cb), t(x))
    want = np.asarray(ref.nearest_code(jnp.asarray(cb), jnp.asarray(x)))
    np.testing.assert_array_equal(idx.numpy(), want)
    assert abs(float(port.perplexity(idx, 16))
               - float(ref.perplexity(jnp.asarray(want), 16))) <= 1e-5


@pytest.mark.parametrize("reset", [True, False])
def test_ema_init_and_update_match_jax(reset):
    """Both packages' EMA steps from the same batch, the JAX normal draws
    passed to the port as ``noise``; a code that no row picks falls below
    a count of 1 and is reset (where ``reset``)."""
    rng = np.random.RandomState(6)
    K, C = 24, 8
    x = rng.randn(2, 5, C).astype(np.float32)
    k0, k1 = jax.random.split(jax.random.PRNGKey(7))
    st_j = ref.ema_init(jnp.asarray(x), K, k0)
    noise0 = jax.random.normal(k0, (-(-K // 10) * 10, C))
    st_t = port.ema_init(t(x), K, noise=t(noise0))
    for a, b in zip((st_t.codebook, st_t.code_sum, st_t.code_count),
                    (st_j.codebook, st_j.code_sum, st_j.code_count)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    x2 = rng.randn(2, 5, C).astype(np.float32)
    idx = np.asarray(ref.nearest_code(st_j.codebook, jnp.asarray(x2)))
    up_j = ref.ema_update(st_j, jnp.asarray(x2), jnp.asarray(idx), 0.9, k1,
                          reset=reset)
    up_t = port.ema_update(st_t, t(x2), torch.from_numpy(idx.astype(np.int64)),
                           0.9, reset=reset,
                           noise=t(jax.random.normal(k1, (K, C))))
    assert (np.asarray(up_j.code_count) < 1.0).any()
    for a, b in zip((up_t.codebook, up_t.code_sum, up_t.code_count),
                    (up_j.codebook, up_j.code_sum, up_j.code_count)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _vq(quantizer):
    kw = dict(nfeats=12, nb_code=16, code_dim=64, output_emb_width=64,
              quantizer=quantizer, beta=0.25, **SMALL)
    jm = ref.VQVae(**kw)
    x = np.random.RandomState(8).randn(2, 16, 12).astype(np.float32)
    cb = (None if quantizer == "orig"
          else np.random.RandomState(9).randn(16, 64).astype(np.float32))
    params = noise_tree(shapes(jm, x, None if cb is None
                               else jnp.asarray(cb)), 10)["params"]
    if quantizer == "orig":  # codes near the encoder's outputs
        z = jitted(jm, method=lambda m, x: m.encoder(x))({"params": params},
                                                         x)
        rows = np.asarray(z).reshape(-1, 64)
        params["codebook"] = rows[np.arange(16) % len(rows)] + 0.05 * (
            rows.std() * np.random.RandomState(11).randn(16, 64)
        ).astype(np.float32)
    tm = loaded(port.VQVae(device="cpu", **kw), convert.vq_state_dict(params))
    return jm, params, tm, x, cb


@pytest.mark.parametrize("quantizer", ["orig", "ema_reset"])
def test_vqvae_matches_jax(quantizer):
    """Output, loss, perplexity and indices; then every parameter's
    gradient (the straight-through estimator carries the decoder's to the
    encoder) against ``jax.grad``, within 1e-4 of the gradients' scale."""
    jm, params, tm, x, cb = _vq(quantizer)
    out_j, loss_j, ppl_j, idx_j = jitted(jm)({"params": params}, x, cb)
    cbt = None if cb is None else t(cb)
    w = np.random.RandomState(12).randn(*out_j.shape).astype(np.float32)

    def loss(p):
        out, l, _, _ = jm.apply({"params": p}, x,
                                None if cb is None else jnp.asarray(cb))
        return jnp.sum(out * w) + 10.0 * l

    grads = convert.vq_state_dict(jax.jit(jax.grad(loss))(params))
    out, l, ppl, idx = tm(t(x), cbt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert len(np.unique(idx.numpy())) > 1
    assert relerr(out.detach().numpy(), out_j) <= TOL
    assert abs(float(l) - float(loss_j)) <= TOL * abs(float(loss_j))
    assert abs(float(ppl) - float(ppl_j)) <= 1e-5
    ((out * t(w)).sum() + 10.0 * l).backward()
    scale = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
    for name, p in tm.named_parameters():
        g = grads[name].numpy()
        assert np.linalg.norm(p.grad.numpy() - g) <= TOL * max(
            np.linalg.norm(g), 1e-3 * scale), name
    with torch.no_grad():
        codes = tm.encode(t(x), cbt)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(idx_j))
        dec = tm.decode_codes(codes, cbt)
    want = jitted(jm, method=jm.decode_codes)({"params": params}, idx_j, cb)
    assert relerr(dec.numpy(), want) <= TOL


def test_human_vq_diff_matches_jax():
    """The published width (512 channels, 512 codes), ``orig``: encode,
    forward and ``forward_decoder`` on one clip."""
    jm = ref.HumanVQDiff(nfeats=20)
    x = np.random.RandomState(13).randn(1, 16, 20).astype(np.float32)
    params = noise_tree(shapes(jm, x), 14)["params"]

    @jax.jit
    def run(p, x):
        v = {"params": p}
        out = jm.apply(v, x)
        return out, jm.apply(v, out[3], method=jm.forward_decoder)

    (out_j, loss_j, _, idx_j), dec_j = run(params, x)
    tm = loaded(port.HumanVQDiff(nfeats=20, device="cpu"),
                convert.vq_state_dict(params))
    with torch.no_grad():
        out, l, _, idx = tm(t(x))
        codes = tm.encode(t(x))
        dec = tm.forward_decoder(codes)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(idx_j))
    assert relerr(out.numpy(), out_j) <= TOL
    assert relerr(dec.numpy(), dec_j) <= TOL
    assert abs(float(l) - float(loss_j)) <= TOL * abs(float(loss_j))


def test_mld_vae_t2m_matches_jax():
    """``encode`` ([L, B, 512], None), ``decode`` and ``forward`` at 196
    frames (the JAX output length: 24 latents, 192 frames), and the
    reference converters on the port's state dict."""
    jm = ref_t2m.MldVaeT2m(nfeats=20)
    x = np.random.RandomState(15).randn(2, 196, 20).astype(np.float32)
    params = noise_tree(shapes(jm, x), 16)["params"]
    rec_j, z_j, dist_j = jitted(jm)({"params": params}, x)
    tm = loaded(port_t2m.MldVaeT2m(20, device="cpu"),
                convert.mld_vae_t2m_state_dict(params))
    with torch.no_grad():
        rec, z, dist = tm(t(x))
        dec = tm.decode(t(z_j))
    assert dist is None and dist_j is None
    assert z.shape == (24, 2, 512) and rec.shape == rec_j.shape == (2, 192, 20)
    assert relerr(z.numpy(), z_j) <= TOL
    assert relerr(rec.numpy(), rec_j) <= TOL
    assert relerr(dec.numpy(), rec_j) <= TOL
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    _assert_same_tree(ref_t2m.convert_torch_mld_vae_t2m(sd)["params"],
                      params)
    _assert_same_tree(ref_t2m.convert_torch_encdec(sd, "encoder.", "encoder"),
                      params["encoder"])


@pytest.mark.parametrize("sample", [False, True])
def test_vposert_matches_jax(sample):
    """(feats_rst, z, (mu, scale)) with the mean, or a sample whose JAX
    normal draw is passed to the port as ``eps``; the BatchNorms read their
    running statistics; ``convert_torch_vposert`` on the port's state
    dict gives back params and batch_stats bit for bit."""
    kw = dict(frames=8, nfeats=6, num_neurons=32, latent_dim=16)
    jm = ref_vp.VPosert(**kw)
    x = np.random.RandomState(17).randn(4, 8, 6).astype(np.float32)
    variables = noise_tree(shapes(jm, x), 18)
    key = jax.random.PRNGKey(19) if sample else None
    rec_j, z_j, (mu_j, sc_j) = jax.jit(
        lambda v, x, k: jm.apply(v, x, rng=k))(variables, x, key)
    tm = loaded(port_vp.VPosert(device="cpu", **kw),
                convert.vposert_state_dict(variables["params"],
                                           variables["batch_stats"]))
    eps = t(jax.random.normal(key, (4, 16))) if sample else None
    with torch.no_grad():
        rec, z, (mu, sc) = tm(t(x), eps=eps)
    for got, want in ((rec, rec_j), (z, z_j), (mu, mu_j), (sc, sc_j)):
        assert got.shape == want.shape
        assert relerr(got.numpy(), want) <= TOL
    back = ref_vp.convert_torch_vposert(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    _assert_same_tree(back["params"], variables["params"])
    _assert_same_tree(back["batch_stats"], variables["batch_stats"])
    tm.train()  # BatchNorm keeps its running statistics in training mode
    before = tm.encoder_net[1].running_mean.clone()
    tm(t(x), generator=torch.Generator().manual_seed(0))
    assert torch.equal(tm.encoder_net[1].running_mean, before)
