"""The stylization kernels' shape gates and kernel 6's launch geometry in
the PyTorch port, on the CPU.

  * ``stylized_ffn_supported`` (kernel 6) and ``broadcast_stylize_supported``
    (kernel 7) are the shapes their wrappers take: each wrapper's shape
    check raises exactly where its gate is false, over a grid of widths,
    hidden widths, rows per sample and sample counts.
  * The modules choose the route from those gates before any launch: at D
    256 ``StylizedFFN`` and the one-token ``LinearTemporalCrossAttention``
    call the kernel wrappers; at D 512 and D 96 neither.
    The route is seen through the wrappers the module calls (the ``calls``
    fixture), on float32 CPU tensors and on bf16 ones taken for tensors on
    the card (``cuda_common.on_card`` patched, as
    tests/test_torch_dtype_routes.py does).  On every route the output
    matches the JAX package's module within 1e-4 on converted weights
    (float32 on both sides, sums in another order).
  * Kernel 6's row groups cover every row exactly once, at most 96 rows a
    group (a multiple of 16 but the last), and fill the card's cluster
    slots once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import port, randomize, relerr, rnd, t

TOL = 1e-4


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the stylization kernels' wrappers that the MD
    modules make."""
    from ladiff_torch.ops import stylization as st
    counts = {}
    for name in ("fused_stylized_ffn", "fused_broadcast_stylize"):
        def wrapped(*a, _fn=getattr(st, name), _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(st, name, wrapped)
    return counts


def _raises(check, *shape) -> bool:
    try:
        check(*shape)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("D", [32, 64, 96, 128, 192, 256, 320, 512])
def test_gates_equal_the_wrappers_checks(D):
    """Each gate is true exactly where its wrapper's shape check passes;
    kernel 6 takes D 64..256 in steps of 64 with F a multiple of D within
    the segment table and shared memory, kernel 7 D 64..256 in steps of
    64 (the cluster body's widths)."""
    from ladiff_torch.ops.stylize import (broadcast_stylize_supported,
                                          check_broadcast_stylize_shape)
    from ladiff_torch.ops.stylized_ffn import (check_stylized_ffn_shape,
                                               stylized_ffn_supported)
    taken = 0
    for F in (D // 2, D, 3 * D, 4 * D, 1024, 2048, 4096, 8192):
        for T in (1, 5, 7, 33, 100):
            for B in (1, 3, 37, 512):
                for M in (B * T, B * T + 1):
                    got = stylized_ffn_supported(M, T, D, F)
                    assert got != _raises(check_stylized_ffn_shape, M, T,
                                          D, F), (M, T, D, F)
                    taken += got
                    if got:
                        assert (D % 64 == 0 and 64 <= D <= 256
                                and F % D == 0 and M % T == 0)
                    k7 = broadcast_stylize_supported(M, T, D)
                    assert k7 != _raises(check_broadcast_stylize_shape, M,
                                         T, D)
                    assert k7 == (D % 64 == 0 and D <= 256 and M % T == 0)
    assert (taken > 0) == (D % 64 == 0 and D <= 256)
    # the published widths; the cluster body's shared memory and segment
    # table cap F: the FFN partials of F 2048 at D 256 do not fit
    if D == 256:
        assert stylized_ffn_supported(2560, 5, 256, 1024)
        assert not stylized_ffn_supported(2560, 5, 256, 2048)
    if D == 64:
        assert stylized_ffn_supported(40, 5, 64, 1024)
        assert not stylized_ffn_supported(40, 5, 64, 4096)


def _modules(D, H, F, seed):
    from ladiff_torch.ops.stylization import (
        LinearTemporalCrossAttention as TC, StylizedFFN as TF)
    from ladiff_tpu.ops.stylization import (
        LinearTemporalCrossAttention as JC, StylizedFFN as JF)
    rng = np.random.RandomState(seed)
    B, T = 3, 5
    x, xf = rnd(rng, B, T, D, scale=0.5), rnd(rng, B, 1, D)
    emb = rnd(rng, B, D)
    valid = np.arange(T)[None] < np.array([[T], [2], [1]])
    jf, jc = JF(D, F, 0.0), JC(D, D, H, 0.0)
    pf = randomize(jf.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(emb))["params"], seed + 1)
    args = tuple(map(jnp.asarray, (x, xf, emb, valid)))
    pc = randomize(jc.init(jax.random.PRNGKey(1), *args)["params"], seed + 2)
    want = (jf.apply({"params": pf}, jnp.asarray(x), jnp.asarray(emb)),
            jc.apply({"params": pc}, *args))
    return (port(TF(D, F), pf).eval(), port(TC(D, D, H), pc).eval(),
            (x, xf, emb, valid), want)


# D, heads, FFN width -> the wrappers the modules call
_ROUTES = {(256, 4, 1024): {"fused_stylized_ffn": 1,
                            "fused_broadcast_stylize": 1},
           (512, 8, 1024): {}, (96, 2, 192): {}}


@pytest.mark.parametrize("shape", sorted(_ROUTES))
def test_modules_route_by_shape_and_match_jax(calls, monkeypatch, shape):
    """StylizedFFN and the one-token cross-attention at inference: the
    kernels' wrappers where the gates take the shape, plain ops where they
    do not; the output matches the JAX package's modules either way, and
    bf16 on the card takes the same routes."""
    from ladiff_torch.ops import cuda_common
    D, H, F = shape
    ffn, ca, (x, xf, emb, valid), want = _modules(D, H, F, 60 + D)
    with torch.no_grad():
        got_f = ffn(t(x), t(emb))
        got_c = ca(t(x), t(xf), t(emb), t(valid))
    assert calls == _ROUTES[shape]
    assert relerr(got_f, want[0]) <= TOL
    assert relerr(got_c, want[1]) <= TOL
    calls.clear()
    monkeypatch.setattr(cuda_common, "on_card", lambda device: True)
    bf = torch.bfloat16
    with torch.no_grad():
        ffn.to(bf)(t(x).to(bf), t(emb).to(bf))
        ca.to(bf)(t(x).to(bf), t(xf).to(bf), t(emb).to(bf), t(valid))
    assert calls == _ROUTES[shape]


@pytest.mark.parametrize("M", [1, 15, 40, 259, 2560, 26368])
def test_stylized_ffn_geometry(M):
    """Kernel 6's row groups: consecutive rows, at most 96 a group and a
    multiple of 16 but the last, every row in exactly one group, C = D / 64
    CTAs a group; at most one group a cluster slot where the rows allow
    it (2560 rows on the 30 clusters of 4 an H100 holds: 27 groups of
    96)."""
    from ladiff_torch.ops.stylized_ffn import stylized_ffn_geometry
    for D, slots in ((256, 30), (128, 66), (64, 132), (192, 7)):
        rows, groups, C, ctas = stylized_ffn_geometry(M, D, slots)
        assert C == D // 64 and ctas == groups * C
        assert 1 <= rows <= 96 and (rows % 16 == 0 or groups == 1)
        covered = [r for g in range(groups)
                   for r in range(g * rows, min(M, (g + 1) * rows))]
        assert covered == list(range(M))
        assert groups <= slots or rows == 96
    assert stylized_ffn_geometry(2560, 256, 30) == (96, 27, 4, 108)
