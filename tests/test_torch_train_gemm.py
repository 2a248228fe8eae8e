"""Kernel 8's products on the GEMM block, the host-side logic, on the CPU.

  * The launch geometry of each product (``attention_gemm_geometry``): the
    tile width chosen per product, the CTAs even and within the card's
    cluster slots; a weight gradient's K ranges (``wgrad_geometry``) cover
    the rows exactly once, in order, each a multiple of 64 rows but the
    last, and with the output tiles fill the slots once.
  * The products as the kernel stages them (``train_gemm_plain``: q / k /
    v, the out-projection with its residual dropout, dctx with delta, dx,
    the weight gradients over their K ranges) give the plain forward's
    output and the plain backward's dx and gradients, within 1e-5 (float32
    on both sides, sums in another order).  dqkv comes from autograd
    through the attention core.
"""
import math

import pytest
import torch

TOL = 1e-5
ROWS = (618, 26368, 64, 1)


@pytest.mark.parametrize("D", [64, 128, 192, 256])
def test_attention_gemm_geometry(D):
    """Each product's tile width and CTAs: q / k / v from 256, 192 and
    128; the out-projection and dx from 256 and 128; dctx from those whose
    column tiles hold whole heads (D 192, head width 48: 256 only);
    weight gradients 128; CTAs in clusters of two, at most the card's
    slots."""
    from ladiff_torch.ops.clip_layer import clip_gemm_geometry
    from ladiff_torch.ops.train_attention import (attention_gemm_geometry,
                                                  dctx_widths)
    H = 4
    assert dctx_widths(D, H) == ((256,) if D == 192 else (256, 128))
    for M in ROWS:
        for slots in (66, 30, 1):
            geo = attention_gemm_geometry(M, D, H, slots)
            assert geo["qkv"]["bn"] in (256, 192, 128)
            assert geo["qkv"] == clip_gemm_geometry(M, 3 * D, D, slots=slots)
            assert geo["out"]["bn"] in (256, 128)
            assert geo["dx"]["bn"] in (256, 128)
            dh, bn = D // H, geo["dctx"]["bn"]
            assert bn in dctx_widths(D, H) and (D <= bn or bn % dh == 0)
            assert geo["dWqkv"]["bn"] == geo["dWout"]["bn"] == 128
            for g in geo.values():
                assert g["ctas"] % 2 == 0 and 2 <= g["ctas"] <= 2 * slots
    # the published shape: 128 x 206 rows at D 256
    geo = attention_gemm_geometry(26368, 256, 4, 66)
    assert [geo[k]["bn"] for k in ("qkv", "out", "dctx", "dx")] == [256] * 4
    assert geo["dWqkv"]["pairs"] == 66 and geo["dWqkv"]["splits"] == 11


@pytest.mark.parametrize("N1,N2", [(768, 256), (256, 256), (576, 192),
                                   (192, 64), (64, 64)])
def test_wgrad_geometry_ranges(N1, N2):
    """A weight gradient's K ranges cover the rows exactly once in order,
    ksplit a multiple of 64, every range non-empty; the tile pairs times
    the ranges fill the slots once (or one range where the tiles alone do
    not fit)."""
    from ladiff_torch.ops.train_attention import wgrad_geometry
    for K in ROWS + (206, 63, 65):
        for slots in (66, 7, 1):
            geo = wgrad_geometry(N1, N2, K, slots)
            r = geo["ranges"]
            assert len(r) == geo["splits"] >= 1
            assert geo["ksplit"] % 64 == 0
            assert r[0][0] == 0 and r[-1][1] == K
            assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
            assert all(k1 > k0 for k0, k1 in r)
            assert all(k1 - k0 == geo["ksplit"] for k0, k1 in r[:-1])
            base = -(-(-(-N1 // 128)) // 2) * -(-N2 // 128)
            assert geo["pairs"] == base * geo["splits"]
            assert geo["pairs"] <= max(slots, base)
            assert geo["ctas"] == 2 * min(geo["pairs"], slots)


def _core(qkv, kvalid, pm, H, S):
    """The attention core from a qkv leaf, as _attention_core has it."""
    from ladiff_torch.ops.train_attention import _heads, _mul
    from ladiff_torch.ops.cuda_common import NEG_INF
    M, D3 = qkv.shape
    D, B = D3 // 3, M // S
    q, k, v = (_heads(a, B, S, H) for a in qkv.split(D, dim=-1))
    logits = q @ k.transpose(-1, -2) / math.sqrt(D // H)
    bias = torch.where(kvalid.reshape(B, 1, 1, S) > 0.5, 0.0, NEG_INF)
    p = torch.softmax(logits + bias.to(logits.dtype), dim=-1)
    return (_mul(p, pm) @ v).transpose(1, 2).reshape(M, D)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,H", [(64, 4), (192, 4)])
def test_staged_products_match_the_plain_versions(rate, D, H):
    from ladiff_torch.ops.train_attention import (
        train_gemm_plain, train_self_attention_bwd_plain,
        train_self_attention_plain, wgrad_geometry)
    g = torch.Generator().manual_seed(D)
    B, S = 3, 40
    M = B * S
    r = lambda *s, sc=1.0: sc * torch.randn(*s, generator=g)
    x, dout = r(M, D), r(M, D, sc=0.1)
    p = {"in_w": r(3 * D, D, sc=D ** -0.5), "in_b": r(3 * D, sc=0.05),
         "out_w": r(D, D, sc=D ** -0.5), "out_b": r(D, sc=0.05)}
    kvalid = (torch.arange(S)[None] < torch.tensor([[S], [20], [1]])
              ).reshape(M).float()
    keep = lambda *s: (torch.rand(*s, generator=g) >= rate).float() / (
        1 - rate)
    pm, rm = keep(B, H, S, S), keep(M, D)
    masks = (pm, rm) if rate else None
    out = train_self_attention_plain(x, kvalid, p, masks, H=H, S=S)
    dx, grads = train_self_attention_bwd_plain(x, kvalid, dout, p, masks,
                                               H=H, S=S)
    pm, rm = masks or (None, torch.ones(M, D))
    # forward: qkv, the attention core, the out-projection's epilogue
    qkv = train_gemm_plain("qkv", x, p["in_w"], bias=p["in_b"])
    qkv.requires_grad_(True)
    ctx = _core(qkv, kvalid, pm, H, S)
    got = train_gemm_plain("out_drop", ctx, p["out_w"], bias=p["out_b"],
                           resid=x, rm=rm)
    assert (got - out).norm() / out.norm() <= TOL
    # backward: dattn, dctx and delta, dqkv (autograd through the core),
    # dx, the weight gradients over their K ranges
    dattn = dout * rm
    dctx, delta = train_gemm_plain("dctx", dattn, p["out_w"],
                                   resid=ctx.detach(), H=H)
    assert torch.allclose(dctx, dattn @ p["out_w"], atol=1e-5)
    assert torch.allclose(delta, (dctx * ctx.detach()).reshape(
        M, H, D // H).sum(-1), atol=1e-5)
    dqkv, = torch.autograd.grad(ctx, qkv, dctx)
    got_dx = train_gemm_plain("dx", dqkv, p["in_w"], resid=dout)
    assert (got_dx - dx).norm() / dx.norm() <= TOL
    for name, dy, a in (("in_w", dqkv, x), ("out_w", dattn, ctx.detach())):
        geo = wgrad_geometry(dy.shape[1], a.shape[1], M, 7)
        part = train_gemm_plain("wgrad", dy, a, ranges=geo["ranges"])
        assert part.shape == (geo["splits"], dy.shape[1], a.shape[1])
        want = grads[name]
        assert (part.sum(0) - want).norm() / want.norm() <= TOL, name
    assert torch.allclose(dqkv.sum(0), grads["in_b"], atol=1e-5)
