"""The float32 chains of kernels 6, 7 and 11 (``ladiff_torch/ops/
f32_layer.py`` ``stylized_ffn_f32``, ``broadcast_stylize_f32``,
``md_stack_f32``) on the CPU, their launches emulated at pointer level
(``tests/torch_f32_emulation.py``), against their plain versions and the
JAX package's Pallas kernels run in float32 in interpret mode.

  * Kernel 6 (the stylized FFN) and kernel 7 (the one-token stylize) at
    37 x 7 and 3 x 5 rows (the bf16 kernels' row groups split those
    samples; a row's AdaLN row is that of its sample, r // T) at D 64, 128,
    192 and 256, with one AdaLN row shared by every sample and one per
    sample; kernel 7 also at 40 x 1 rows, each with a fractional mask
    (the first sample wholly masked) and an all-zero mask (each row's
    LayerNorm is then its bias).
  * Kernel 11 (the whole MD stack) at 3 and 9 layers, 5 samples with 1 to
    5 valid latents and without a mask.

Each chain makes ``CHAIN_LAUNCHES`` launches (kernel 11:
``md_stack_launches(L)``) and agrees with its plain version within 1e-5
norm-wise (float32 sums in another order) and with the JAX kernel within
1e-4 (see test_torch_modules.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_modules import port, randomize, relerr, rnd, t
from torch_f32_emulation import emulated  # noqa: F401 (a fixture)

TOL = 1e-5       # the chain against its plain version
JAX_TOL = 1e-4   # against the JAX Pallas kernel in float32


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _weights(rng, shapes):
    """Torch-layout weights: matrices ~ N(0, 1 / fan_in), LayerNorm weights
    ~ 1 + N(0, 0.1), other vectors ~ N(0, 0.05)."""
    out = []
    for name, s in shapes:
        r = rng.randn(*s)
        r = (r / np.sqrt(s[1]) if len(s) == 2 else
             1 + 0.1 * r if name == "ln_w" else 0.05 * r)
        out.append(torch.tensor(r, dtype=torch.float32))
    return out


def _rows(ss, M, T):
    """AdaLN rows [1 or M / T, 2D] expanded to one (scale, shift) per row,
    as the JAX kernels take them."""
    ss = ss.numpy()
    D = ss.shape[1] // 2
    full = ss[np.arange(M) // T if ss.shape[0] > 1 else np.zeros(M, int)]
    return jnp.asarray(full[:, :D]), jnp.asarray(full[:, D:])


# -- kernels 6 and 7 ---------------------------------------------------------

SHAPES = [(D, n, T) for D in (64, 128, 192, 256)
          for n, T in ((37, 7), (3, 5))]


@pytest.mark.parametrize("D,n,T", SHAPES)
def test_stylized_ffn_chain(emulated, interpret, D, n, T):
    """Kernel 6's chain: W1 + GELU, W2, LN + AdaLN + SiLU, projection +
    residual, against ``stylized_ffn_plain`` and the JAX kernel."""
    from ladiff_torch.ops.f32_layer import CHAIN_LAUNCHES, stylized_ffn_f32
    from ladiff_torch.ops.stylized_ffn import stylized_ffn_plain
    from ladiff_tpu.ops.pallas_fused_ffn import fused_stylized_ffn
    rng = np.random.RandomState(D + n)
    F = 4 * D
    w = _weights(rng, [("w1", (F, D)), ("b1", (F,)), ("w2", (D, F)),
                       ("b2", (D,)), ("ln_w", (D,)), ("ln_b", (D,)),
                       ("w3", (D, D)), ("b3", (D,))])
    M = n * T
    x = t(rnd(rng, M, D))
    for rows in (n, 1):
        ss = t(rnd(rng, rows, 2 * D, scale=0.3))
        emulated.clear()
        got = stylized_ffn_f32(x, ss, *w, T=T)
        assert len(emulated) == CHAIN_LAUNCHES["fused_stylized_ffn"]
        want = stylized_ffn_plain(x, ss, *w, T=T)
        assert relerr(got, want.numpy()) <= TOL, rows
        w1, b1, w2, b2, lw, lb, w3, b3 = (jnp.asarray(v.numpy()) for v in w)
        want_k = fused_stylized_ffn(jnp.asarray(x.numpy()),
                                    *_rows(ss, M, T), w1.T, b1, w2.T, b2,
                                    lw, lb, w3.T, b3)
        assert relerr(got, np.asarray(want_k)) <= JAX_TOL, rows


@pytest.mark.parametrize("D,n,T", SHAPES + [(D, 40, 1)
                                            for D in (64, 128, 192, 256)])
def test_broadcast_stylize_chain(emulated, interpret, D, n, T):
    """Kernel 7's chain: the LayerNorm of the masked value row with AdaLN
    and SiLU, the projection + residual, against
    ``broadcast_stylize_plain`` and the JAX kernel; a fractional mask
    (the first sample wholly masked) and an all-zero one."""
    from ladiff_torch.ops.f32_layer import (CHAIN_LAUNCHES,
                                            broadcast_stylize_f32)
    from ladiff_torch.ops.stylize import broadcast_stylize_plain
    from ladiff_tpu.ops.pallas_stylize import fused_broadcast_stylize
    rng = np.random.RandomState(3 * D + n)
    w = _weights(rng, [("ln_w", (D,)), ("ln_b", (D,)), ("w", (D, D)),
                       ("b", (D,))])
    M = n * T
    x, value = t(rnd(rng, M, D)), t(rnd(rng, n, D))
    frac = rng.rand(M).astype(np.float32)
    frac[:T] = 0.0
    for mname, mask in (("fractional", frac),
                        ("zero", np.zeros(M, np.float32))):
        for rows in (n, 1):
            ss = t(rnd(rng, rows, 2 * D, scale=0.3))
            emulated.clear()
            got = broadcast_stylize_f32(x, value, t(mask), ss, *w, T=T)
            assert len(emulated) == \
                CHAIN_LAUNCHES["fused_broadcast_stylize"]
            want = broadcast_stylize_plain(x, value, t(mask), ss, *w, T=T)
            assert relerr(got, want.numpy()) <= TOL, (mname, rows)
            lw, lb, wp, bp = (jnp.asarray(v.numpy()) for v in w)
            want_k = fused_broadcast_stylize(
                jnp.asarray(x.numpy()),
                jnp.asarray(np.repeat(value.numpy(), T, 0)),
                jnp.asarray(mask[:, None]), *_rows(ss, M, T), lw, lb, wp.T,
                bp)
            assert relerr(got, np.asarray(want_k)) <= JAX_TOL, (mname, rows)


# -- kernel 11 ---------------------------------------------------------------

SD, SH, SFF = 128, 2, 256  # the stack's width, heads, FFN width


@pytest.mark.parametrize("L,masked", [(3, True), (3, False), (9, True),
                                      (9, False)])
def test_md_stack_chain(emulated, interpret, L, masked):
    """Kernel 11's chain: K1's chain per layer, each skip Linear one GEMM
    over the [x, skip] buffer the layers around it write, the final LN;
    against ``md_stack_plain`` and the JAX kernel on the JAX sampling
    path's stacked tensors and prep (the JAX encoder's weights ported)."""
    from ladiff_torch.ops.f32_layer import (CHAIN_LAUNCHES, md_stack_f32,
                                            md_stack_launches)
    from ladiff_torch.ops.md_stack import md_stack_plain
    from ladiff_torch.ops.stylization import MDSkipTransformerEncoder as TE
    from ladiff_tpu.ops.pallas_md_stack import fused_md_stack
    from ladiff_tpu.ops.stylization import MDSkipTransformerEncoder as JE
    B, T, D = 5, 5, SD
    rng = np.random.RandomState(70 + L)
    x, xf = rnd(rng, B, T, D, scale=0.5), rnd(rng, B, 1, D)
    time_row = rnd(rng, D)
    emb = np.repeat(time_row[None], B, 0)  # a sampling step's shared row
    # sample b has b + 1 valid latents: 1 to 5
    valid = (np.arange(T)[None] <= np.arange(B)[:, None] if masked
             else np.ones((B, T), bool))
    je = JE(D, D, SH, L, SFF, 0.0)
    p = randomize(je.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(xf), jnp.asarray(emb),
                          jnp.asarray(valid))["params"], 71 + L)
    te = port(TE(D, D, SH, L, SFF), p)
    jp = {"params": p}
    prep_all = je.apply(jp, jnp.asarray(xf), jnp.asarray(time_row[None]),
                        method=je.precompute_prep)
    values, ca_t, ffn_t = je.apply(jp, prep_all, method=je.stack_prep)
    kvalid = valid.astype(np.float32).reshape(B * T)
    extra = np.concatenate([xf, emb[:, None]], 1).reshape(B * 2, D)
    want_k = fused_md_stack(jnp.asarray(x.reshape(B * T, D)),
                            jnp.asarray(extra), jnp.asarray(kvalid[:, None]),
                            values, ca_t[0], ffn_t[0],
                            je.apply(jp, method=je.stacked_params), T=T,
                            E=2, H=SH)
    with torch.no_grad():
        values_t, ca_tt, ffn_tt = te.stack_prep(te.precompute_prep(
            t(xf), t(time_row[None]), with_params=False))
        st = te.stacked_params(torch.float32)
        args = (t(x.reshape(B * T, D)), t(extra), t(kvalid), values_t,
                ca_tt[0].contiguous(), ffn_tt[0].contiguous(), st)
        got = md_stack_f32(*args, T=T, E=2, H=SH)
        want = md_stack_plain(*args, T=T, E=2, H=SH)
    assert len(emulated) == md_stack_launches(L)
    if L == 9:
        assert len(emulated) == CHAIN_LAUNCHES["fused_md_stack"]
    assert relerr(got, want.numpy()) <= TOL
    assert relerr(got, np.asarray(want_k)) <= JAX_TOL
