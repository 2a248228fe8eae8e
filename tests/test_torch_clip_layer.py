"""K3 and K4 as their CUDA kernels stage them (``ladiff_torch/ops/
clip_layer.py``): the staged plain chain, one plain function per launch
(the LayerNorm pass, each GEMM with its epilogue), against the JAX
package's Pallas kernels in interpret mode on the CPU, and the GEMM block's
launch geometry for every caption bucket and batch.  The CUDA launches
themselves are held to these plain pieces by tests/test_torch_cuda.py on a
GPU.

Tolerance for the staged chain against Pallas: 1e-4 norm-wise relative
error.  Both compute in float32; the sums run in another order (~1e-6 a
product).
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_modules import relerr, rnd, t

TOL = 1e-4
BUCKETS = (16, 32, 77)  # ladiff_torch/models/clip_text.py ClipTextEncoder


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _weights(rng, Wd, Fd):
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


SHAPES = [(128, 512, 48), (128, 512, 3 * 77), (768, 3072, 48),
          (768, 3072, 3 * 77)]


@pytest.mark.parametrize("Wd,Fd,M", SHAPES)
def test_ln_qkv_staged_matches_pallas(interpret, Wd, Fd, M):
    """K3's LayerNorm pass and q / k / v launch against ``fused_ln_qkv``."""
    from ladiff_torch.ops.clip_layer import ln_qkv_staged
    from ladiff_tpu.ops.pallas_clip_layer import fused_ln_qkv
    rng = np.random.RandomState(40 + M + Wd)
    x = rnd(rng, M, Wd)
    j, tp = _weights(rng, Wd, Fd)
    scale = 1.0 / math.sqrt(Wd // 12 if Wd == 768 else Wd // 2)
    want = fused_ln_qkv(jnp.asarray(x), j["wq"], j["bq"], j["wk"], j["bk"],
                        j["wv"], j["bv"], j["ln_w"], j["ln_b"], scale=scale)
    got = ln_qkv_staged(t(x), tp, scale=scale)
    for g, w in zip(got, want):
        assert relerr(g, w) <= TOL


@pytest.mark.parametrize("Wd,Fd,M", SHAPES)
def test_proj_mlp_staged_matches_pallas(interpret, Wd, Fd, M):
    """K4's four launches (Wo + residual into the float32 h, LN2, fc1 with
    quick-GELU, fc2 + h) against ``fused_proj_mlp``."""
    from ladiff_torch.ops.clip_layer import proj_mlp_staged
    from ladiff_tpu.ops.pallas_clip_layer import fused_proj_mlp
    rng = np.random.RandomState(50 + M + Wd)
    att, x = rnd(rng, M, Wd), rnd(rng, M, Wd)
    j, tp = _weights(rng, Wd, Fd)
    want = fused_proj_mlp(jnp.asarray(att), jnp.asarray(x), j["wo"], j["bo"],
                          j["w1"], j["b1"], j["w2"], j["b2"], j["ln_w"],
                          j["ln_b"])
    assert relerr(proj_mlp_staged(t(att), t(x), tp), want) <= TOL


def test_staged_pieces_keep_their_types():
    """Each plain piece computes in float32 and returns what its launch
    writes: bf16 where the launch stores bf16, float32 for h; the
    residual of fc2 is read in float32."""
    from ladiff_torch.ops.clip_layer import clip_gemm_plain, clip_ln_plain
    g = torch.Generator().manual_seed(3)
    bf = lambda *s: torch.randn(*s, generator=g).to(torch.bfloat16)
    a, w, b = bf(5, 64), bf(32, 64), bf(32)
    h = torch.randn(5, 32, generator=g)
    v = a.float() @ w.float().T + b.float()
    assert clip_ln_plain(h, bf(32), bf(32), torch.bfloat16).dtype == \
        torch.bfloat16
    q = clip_gemm_plain(a, w, b, epilogue="bias", scale=0.5)
    assert q.dtype == torch.bfloat16
    assert torch.equal(q, (v * 0.5).to(torch.bfloat16))
    hh = clip_gemm_plain(a, w, b, epilogue="resid_f32", resid=bf(5, 32))
    assert hh.dtype == torch.float32
    gl = clip_gemm_plain(a, w, b, epilogue="gelu")
    assert torch.equal(gl, (v * torch.sigmoid(1.702 * v)).to(torch.bfloat16))
    out = clip_gemm_plain(a, w, b, epilogue="resid_bf16", resid=h)
    assert torch.equal(out, (v + h).to(torch.bfloat16))
    with pytest.raises(ValueError, match="epilogue"):
        clip_gemm_plain(a, w, b, epilogue="relu")


def test_staged_chain_is_the_plain_version_in_float32():
    """In float32 the staged chain and the whole plain functions are the
    same function (h is float32 in both)."""
    from ladiff_torch.models.clip_text import CLIPTextLayer
    from ladiff_torch.ops.clip_layer import (ln_qkv_plain, ln_qkv_staged,
                                             proj_mlp_plain, proj_mlp_staged)
    torch.manual_seed(4)
    layer = CLIPTextLayer(64, 2)
    x, att = torch.randn(20, 64), torch.randn(20, 64)
    with torch.no_grad():
        for g, w in zip(ln_qkv_staged(x, layer.qkv_params(), scale=0.25),
                        ln_qkv_plain(x, layer.qkv_params(), scale=0.25)):
            assert relerr(g, w.numpy()) <= 1e-6
        assert relerr(proj_mlp_staged(att, x, layer.mlp_params()),
                      proj_mlp_plain(att, x, layer.mlp_params()).numpy()) \
            <= 1e-6


# the GEMM launches of K3 and K4 at CLIP's width: (N, K, weights)
GEMMS = {"qkv": (768, 768, 3), "wo": (768, 768, 1), "fc1": (3072, 768, 1),
         "fc2": (768, 3072, 1)}


@pytest.mark.parametrize("S", BUCKETS)
def test_clip_gemm_geometry_covers_every_tile(S):
    """For every caption bucket and batch 1 to 256 and each GEMM of K3 and
    K4: the tiles the clusters walk cover every row and column exactly once
    (a cluster's second CTA past M only on an odd count of row tiles), BN
    is one of the block's widths and has the least work of the busiest
    cluster, and the CTAs fill at most the card's cluster slots."""
    from ladiff_torch.ops.clip_layer import (GEMM_BM, GEMM_BNS, GEMM_CLUSTER,
                                             clip_gemm_geometry,
                                             gemm_tile_origin)
    slots = 66
    for B in range(1, 257):
        M = B * S
        for name, (N, K, mats) in GEMMS.items():
            geo = clip_gemm_geometry(M, N, K, mats=mats, slots=slots)
            bn = geo["bn"]
            assert bn in GEMM_BNS
            costs = {b: clip_gemm_geometry(M, N, K, mats=mats, slots=slots,
                                           bn=b)["cost"] for b in GEMM_BNS}
            assert costs[bn] == min(costs.values())
            assert bn == max(b for b in GEMM_BNS if costs[b] == costs[bn])
            clusters = geo["ctas"] // GEMM_CLUSTER
            assert geo["ctas"] % GEMM_CLUSTER == 0 and 0 < clusters <= slots
            assert clusters == min(geo["pairs"], slots)
            assert geo["persistent"] == (geo["pairs"] > slots)
            assert geo["waves"] == geo["pairs"] / slots
            assert geo["pairs_per_cluster"] == math.ceil(geo["pairs"] / slots)
            # the pairs the clusters walk: c, c + clusters, ...
            walked = np.sort(np.concatenate(
                [np.arange(c, geo["pairs"], clusters)
                 for c in range(clusters)]))
            assert np.array_equal(walked, np.arange(geo["pairs"]))
            tiles = [gemm_tile_origin(int(p), r, geo)
                     for p in range(geo["pairs"])
                     for r in range(GEMM_CLUSTER)]
            inside = [tt for tt in tiles if tt[1] < M]
            assert len(inside) == len(set(inside)) == geo["tiles"], \
                (S, B, name)
            assert len(tiles) - len(inside) == geo["tiles_m"] % GEMM_CLUSTER \
                * geo["tiles_n"] * mats
            rows = sorted({m0 for _, m0, _ in inside})
            cols = sorted({n0 for _, _, n0 in inside})
            assert rows == list(range(0, M, GEMM_BM))
            assert cols == list(range(0, N, bn))
            assert {mt for mt, _, _ in inside} == set(range(mats))


def test_clip_gemm_geometry_widths():
    """The width the geometry picks at the bench's 8192 rows, a forced
    width, and a refused one."""
    from ladiff_torch.ops.clip_layer import clip_gemm_geometry
    geo = clip_gemm_geometry(8192, 768, 768, mats=3)
    # 12 column tiles of 192 a row pair: 384 pairs, 5.8 waves of 66
    assert (geo["bn"], geo["pairs"], geo["ctas"]) == (192, 384, 132)
    assert clip_gemm_geometry(8192, 3072, 768)["bn"] == 256
    assert clip_gemm_geometry(48, 768, 768, bn=256)["bn"] == 256
    with pytest.raises(ValueError, match="BN"):
        clip_gemm_geometry(48, 768, 768, bn=64)
