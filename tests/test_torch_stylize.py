"""Kernel 7 (the MD layer's one-token stylize) in the PyTorch port, on the
CPU; the kernel itself runs on the card only (tests/test_torch_cuda.py).

  * ``broadcast_stylize_supported`` is the shape the wrapper takes: its
    shape check raises exactly where the gate is false, which is where D is
    not a multiple of 64 up to 256 (the cluster body's widths) or M not a
    multiple of T.
  * ``broadcast_stylize_geometry``: consecutive row groups that cover the
    rows exactly once, at most 96 rows a group and a multiple of 16 but for
    the last, one wave of clusters where the rows allow it.
  * The plain version matches the JAX package's Pallas kernel in interpret
    mode within 1e-4 (float32 on both sides, sums in another order), with
    fractional mask values and a sample whose rows are all masked, with one
    shared AdaLN row and with one per sample.
  * A one-token ``LinearTemporalCrossAttention`` in eval mode calls kernel
    7's wrapper exactly where the gate holds and runs the plain collapse
    elsewhere (the ``calls`` fixture), and matches the JAX package's module
    within 1e-4 either way.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_md_routes import calls  # noqa: F401  (a fixture)
from test_torch_modules import port, randomize, relerr, rnd, t

TOL = 1e-4


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _raises(check, *shape) -> bool:
    try:
        check(*shape)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("T", [1, 5, 7])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 192, 256, 320, 512])
def test_gate_equals_the_wrappers_check(D, T):
    """True exactly where the wrapper's check passes: D 64, 128, 192 or
    256, M a whole number of T-row samples."""
    from ladiff_torch.ops.stylize import (broadcast_stylize_supported,
                                          check_broadcast_stylize_shape)
    for B in (1, 3, 37, 512):
        for M in (B * T, B * T + 1):
            got = broadcast_stylize_supported(M, T, D)
            assert got != _raises(check_broadcast_stylize_shape, M, T, D)
            assert got == (D in (64, 128, 192, 256) and M % T == 0), (M, T)


@pytest.mark.parametrize("M", [1, 5, 15, 259, 2560, 26368])
def test_broadcast_stylize_geometry(M):
    """Row groups of consecutive rows, at most 96 a group and a multiple of
    16 but the last, every row in exactly one group, C = D / 64 CTAs a
    group; at most one group a cluster slot where M allows it."""
    from ladiff_torch.ops.stylize import broadcast_stylize_geometry
    for D, slots in ((256, 60), (256, 30), (128, 88), (64, 264), (192, 7)):
        rows, groups, C, ctas = broadcast_stylize_geometry(M, D, slots)
        assert C == D // 64 and ctas == groups * C
        assert 1 <= rows <= 96 and (rows % 16 == 0 or groups == 1)
        covered = [r for g in range(groups)
                   for r in range(g * rows, min(M, (g + 1) * rows))]
        assert covered == list(range(M))
        if M <= 96 * slots:
            assert groups <= slots
        else:
            assert rows == 96
    # 2560 rows on 60 clusters of 4: groups of 48 rows
    assert broadcast_stylize_geometry(2560, 256, 60) == (48, 54, 4, 216)


@pytest.mark.parametrize("adaln", ["per_sample", "shared"])
def test_plain_matches_pallas_with_fractional_masks(interpret, adaln):
    """The plain version against the Pallas kernel (interpret mode), which
    takes the value and AdaLN rows repeated per latent row: masks with
    fractional values, the second sample wholly masked."""
    from ladiff_torch.ops.stylize import broadcast_stylize_plain
    from ladiff_tpu.ops.pallas_stylize import fused_broadcast_stylize
    rng = np.random.RandomState(70 if adaln == "shared" else 71)
    B, T, D = 4, 7, 64
    M = B * T
    x, value = rnd(rng, M, D), rnd(rng, B, D)
    mask = rng.uniform(0.0, 1.0, M).astype(np.float32)
    mask[T:2 * T] = 0.0
    ss = rnd(rng, 1 if adaln == "shared" else B, 2 * D, scale=0.3)
    ln_w, ln_b = 1 + rnd(rng, D, scale=0.1), rnd(rng, D, scale=0.05)
    w, b = rnd(rng, D, D, scale=D ** -0.5), rnd(rng, D, scale=0.05)
    ss_rows = np.broadcast_to(np.repeat(ss, T, 0) if ss.shape[0] == B
                              else ss, (M, 2 * D))
    want = fused_broadcast_stylize(
        jnp.asarray(x), jnp.asarray(np.repeat(value, T, 0)),
        jnp.asarray(mask[:, None]), jnp.asarray(ss_rows[:, :D]),
        jnp.asarray(ss_rows[:, D:]), jnp.asarray(ln_w), jnp.asarray(ln_b),
        jnp.asarray(w.T), jnp.asarray(b))
    got = broadcast_stylize_plain(t(x), t(value), t(mask), t(ss), t(ln_w),
                                  t(ln_b), t(w), t(b), T=T)
    assert relerr(got, want) <= TOL


@pytest.mark.parametrize("D", [32, 64, 96, 128, 160, 192, 224, 256])
def test_one_token_cross_attention_routes_by_the_gate(calls, D):
    """The one-token cross-attention block at inference takes kernel 7's
    wrapper at D 64, 128, 192 and 256 and the plain collapse at D 32, 96,
    160 and 224, before any launch; the JAX package's module agrees on
    both routes."""
    from ladiff_torch.ops.stylization import \
        LinearTemporalCrossAttention as TM
    from ladiff_torch.ops.stylize import broadcast_stylize_supported
    from ladiff_tpu.ops.stylization import LinearTemporalCrossAttention as JM
    rng = np.random.RandomState(80 + D)
    B, T = 3, 5
    x, xf = rnd(rng, B, T, D, scale=0.5), rnd(rng, B, 1, D)
    emb = rnd(rng, B, D)
    valid = np.arange(T)[None] < np.array([[T], [2], [0]])
    jm = JM(D, D, 1, 0.0)
    args = tuple(map(jnp.asarray, (x, xf, emb, valid)))
    p = randomize(jm.init(jax.random.PRNGKey(0), *args)["params"], 81)
    with torch.no_grad():
        got = port(TM(D, D, 1), p).eval()(t(x), t(xf), t(emb), t(valid))
    assert relerr(got, jm.apply({"params": p}, *args)) <= TOL
    taken = broadcast_stylize_supported(B * T, T, D)
    assert taken == (D % 64 == 0)
    assert calls == ({"fused_broadcast_stylize": 1} if taken else {})
