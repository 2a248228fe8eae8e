"""Kernels K3 and K4: the two halves of a CLIP text layer around its causal
attention core.  Replace ``ladiff_tpu/ops/pallas_clip_layer.py``
``fused_ln_qkv`` (:65, ``pl.pallas_call`` at :82) and ``fused_proj_mlp``
(:113, ``pl.pallas_call`` at :129).

    K3  fused_ln_qkv:   y = LN1(x); q = (y Wq + bq) * scale;
                        k = y Wk + bk; v = y Wv + bv
    K4  fused_proj_mlp: h = x + att Wo + bo (f32);
                        out = h + fc2(quick_gelu(fc1(LN2(h))))

What bounds them on the H100: at the bench shape (256 captions x 32 tokens
= 8192 rows, width 768, MLP 3072) K3 is ~29 GFLOP and K4 ~87 GFLOP against
~15 / ~30 MB, well above the ridge: the tensor cores bound both.  The TPU
kernel fused K4's whole chain because VMEM held its three weights (10.6
MB); a CTA's shared memory holds 227 KB.  So each kernel is a chain of
launches (``csrc/clip_layer.cu``): a row LayerNorm pass (f32, rounded to
bf16) and launches of one tensor-core GEMM block (``csrc/gemm_sm90.cuh``:
TMA loads into a ring of stages, ``wgmma`` with the accumulators in
registers, clusters of two CTAs sharing the weight tile by TMA multicast,
and the bias, scale, residual and quick-GELU fused into an epilogue on
those registers that stores through shared memory with TMA).  K3: LN1,
then one GEMM over Wq, Wk and Wv.  K4: Wo with + bo + x into an f32 h,
LN2 over h, fc1 with quick-GELU into the bf16 hidden [M, F], fc2 with + b2
+ h.  h stays f32 between its launches, as the TPU kernel keeps it.
``clip_gemm_geometry`` picks each GEMM's tile width from the work of the
busiest cluster on the card.  On the H100 the products alone run 720 to
810 TFLOP/s at these shapes; the epilogues, during which the tensor cores
wait, bring the GEMMs to 580 to 630 (Wo, with its f32 output, ~300;
PERF.md §6).  Neither kernel has a backward (the tower is frozen):
on CUDA tensors they raise while a gradient is required.

The plain side has the whole functions (``ln_qkv_plain``,
``proj_mlp_plain``) and the kernels' staged chain, one plain function per
launch (``clip_ln_plain``, ``clip_gemm_plain``; ``ln_qkv_staged``,
``proj_mlp_staged``), which the tests hold launch by launch.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import (check_cuda_args, launch, library,
                                          register_kernel, require_no_grad)

__all__ = ["fused_ln_qkv", "fused_proj_mlp", "ln_qkv_plain",
           "proj_mlp_plain", "ln_qkv_staged", "proj_mlp_staged",
           "clip_ln_plain", "clip_gemm_plain", "clip_gemm_geometry",
           "gemm_tile_origin", "gemm_cluster_slots", "GEMM_BM", "GEMM_BNS",
           "GEMM_CLUSTER", "EPILOGUES"]

_QKV_ORDER = ("wq", "bq", "wk", "bk", "wv", "bv", "ln_w", "ln_b")
_MLP_ORDER = ("wo", "bo", "w1", "b1", "w2", "b2", "ln_w", "ln_b")

GEMM_BM = 128                # rows of an output tile
GEMM_BNS = (256, 192, 128)   # the tile widths the GEMM block is built for
GEMM_CLUSTER = 2             # CTAs of a cluster: row tiles sharing W
# the GEMM's epilogues (csrc/gemm_sm90.cuh sm90::Epilogue); "probe" stores
# nothing but a checksum into one float (times the products alone); "add"
# to "part" are kernel 8's (ops/train_attention.py)
EPILOGUES = {"bias": 0, "resid_f32": 1, "gelu": 2, "resid_bf16": 3,
             "probe": 4, "add": 5, "add_drop": 6, "dctx": 7, "part": 8}
# a tile's fixed cost (the ring's fill, the epilogue) in columns of work
_TILE_COST = 32


def ln_qkv_plain(x, p, *, scale: float):
    """Plain PyTorch version of K3.  x [M, D]; weights in the torch
    ``Linear`` layout [out, in]."""
    D = x.shape[1]
    w = {k: v.to(x.dtype) for k, v in p.items()}
    y = F.layer_norm(x.float(), (D,), w["ln_w"].float(), w["ln_b"].float(),
                     1e-5).to(x.dtype)
    return (F.linear(y, w["wq"], w["bq"]) * scale,
            F.linear(y, w["wk"], w["bk"]), F.linear(y, w["wv"], w["bv"]))


def proj_mlp_plain(att, x, p):
    """Plain PyTorch version of K4.  att [M, D] attention output (heads
    merged); x [M, D] the layer input (residual stream)."""
    D = x.shape[1]
    w = {k: v.to(x.dtype) for k, v in p.items()}
    h = x + F.linear(att, w["wo"], w["bo"])
    y = F.linear(F.layer_norm(h, (D,), w["ln_w"], w["ln_b"], 1e-5),
                 w["w1"], w["b1"])
    y = y * torch.sigmoid(1.702 * y)
    return h + F.linear(y, w["w2"], w["b2"])


def clip_ln_plain(x, ln_w, ln_b, dtype):
    """The LayerNorm pass: LN of the rows of x in float32, rounded to
    ``dtype`` (the kernel's bf16)."""
    return F.layer_norm(x.float(), (x.shape[1],), ln_w.float(), ln_b.float(),
                        1e-5).to(dtype)


def clip_gemm_plain(a, w, bias, *, epilogue: str, scale: float = 1.0,
                    resid=None):
    """One GEMM launch: v = a w^T + bias in float32, then the epilogue:
    ``bias`` v * scale, ``gelu`` quick_gelu(v), both in a's type;
    ``resid_f32`` v + resid in float32; ``resid_bf16`` v + resid (float32)
    in a's type."""
    v = F.linear(a.float(), w.float(), bias.float())
    if epilogue == "bias":
        return (v * scale).to(a.dtype)
    if epilogue == "gelu":
        return (v * torch.sigmoid(1.702 * v)).to(a.dtype)
    if epilogue == "resid_f32":
        return v + resid.float()
    if epilogue == "resid_bf16":
        return (v + resid.float()).to(a.dtype)
    raise ValueError(f"clip_gemm_plain: no epilogue {epilogue!r}")


def ln_qkv_staged(x, p, *, scale: float):
    """K3 as its kernel stages it: the LayerNorm pass, then the q, k, v
    products with the bias epilogue (scale on q)."""
    y = clip_ln_plain(x, p["ln_w"], p["ln_b"], x.dtype)
    return tuple(clip_gemm_plain(y, p["w" + n], p["b" + n], epilogue="bias",
                                 scale=scale if n == "q" else 1.0)
                 for n in "qkv")


def proj_mlp_staged(att, x, p):
    """K4 as its kernel stages it: Wo into the float32 h, LN2 over h, fc1
    with quick-GELU, fc2 with + h."""
    h = clip_gemm_plain(att, p["wo"], p["bo"], epilogue="resid_f32", resid=x)
    y = clip_ln_plain(h, p["ln_w"], p["ln_b"], x.dtype)
    hid = clip_gemm_plain(y, p["w1"], p["b1"], epilogue="gelu")
    return clip_gemm_plain(hid, p["w2"], p["b2"], epilogue="resid_bf16",
                           resid=h)


def clip_gemm_geometry(M: int, N: int, K: int, *, mats: int = 1,
                       slots: int = 66, bn: int = 0,
                       bns=GEMM_BNS) -> dict:
    """The launch geometry of one GEMM: [M, K] times ``mats`` weights of
    [N, K].  Output tiles are 128 rows by BN columns, a weight's columns
    cut into ceil(N / BN) tiles.  A cluster of two CTAs (one per SM) takes
    a pair of row tiles of one column tile; ``slots`` clusters fit on the
    card at once, and clusters are persistent: ``ctas`` = 2 min(pairs,
    slots), cluster c taking pairs c, c + clusters, ...  BN is the width of
    ``bns`` whose busiest cluster has the least work, ceil(pairs / slots)
    pairs of (BN + a tile's fixed cost) columns each; the wider tile on a
    tie.  ``bn`` forces a width."""
    if bn and bn not in bns:
        raise ValueError(f"clip_gemm_geometry: BN {bn} not in {bns}")
    tiles_m = -(-M // GEMM_BM)
    pairs_m = -(-tiles_m // GEMM_CLUSTER)

    def record(b):
        tiles_n = -(-N // b)
        pairs = pairs_m * tiles_n * mats
        per_cluster = -(-pairs // slots)
        return {"M": M, "N": N, "K": K, "mats": mats, "bn": b,
                "tiles_m": tiles_m, "tiles_n": tiles_n,
                "tiles": tiles_m * tiles_n * mats, "pairs": pairs,
                "ctas": GEMM_CLUSTER * min(pairs, slots),
                "persistent": pairs > slots, "waves": pairs / slots,
                "pairs_per_cluster": per_cluster,
                "cost": per_cluster * (b + _TILE_COST)}

    if bn:
        return record(bn)
    return min((record(b) for b in bns), key=lambda r: r["cost"])


def gemm_tile_origin(p: int, rank: int, geo: dict):
    """(weight, first row, first column) of the tile that CTA ``rank`` of a
    cluster computes in tile pair ``p``, in the kernel's order: columns
    fastest, so the clusters that run at once share rows."""
    per_row = geo["tiles_n"] * geo["mats"]
    nt = p % per_row
    return (nt // geo["tiles_n"],
            (p // per_row * GEMM_CLUSTER + rank) * GEMM_BM,
            nt % geo["tiles_n"] * geo["bn"])


_SLOTS = {}


def gemm_cluster_slots(device) -> int:
    """Clusters of the GEMM block resident on ``device`` at once (the
    library's occupancy query, cached; half the SM count where it fails).
    Every instantiation of the block takes a whole SM, so the count holds
    for kernels 8's and 12's products too."""
    device = torch.device(device)
    if device.index not in _SLOTS:
        fn = library("clip_layer").clip_gemm_cluster_slots
        fn.argtypes = []
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            n = fn()
        if n <= 0:
            n = torch.cuda.get_device_properties(
                device).multi_processor_count // GEMM_CLUSTER
        _SLOTS[device.index] = n
    return _SLOTS[device.index]


def _ln_rows(x, ln_w, ln_b):
    """The LayerNorm pass on the card: bf16 [M, D] from bf16 or f32 x."""
    M, D = x.shape
    y = torch.empty(M, D, dtype=torch.bfloat16, device=x.device)
    launch("clip_layer", "clip_ln_rows", x.device,
           [x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), y.data_ptr()],
           [M, D, int(x.dtype == torch.float32)])
    return y


def _gemm(a, ws, biases, outs, *, epilogue: str, scale: float = 1.0,
          resid=None, bn: int = 0) -> dict:
    """One GEMM launch: outs[i] = epilogue(a ws[i]^T + biases[i]).
    Returns its geometry."""
    M, K = a.shape
    N = ws[0].shape[0]
    geo = clip_gemm_geometry(M, N, K, mats=len(ws),
                             slots=gemm_cluster_slots(a.device), bn=bn)
    pad = [0] * (3 - len(ws))
    launch("clip_layer", "clip_gemm", a.device,
           [a.data_ptr(), *[w.data_ptr() for w in ws], *pad,
            *[b.data_ptr() for b in biases], *pad,
            *[o.data_ptr() for o in outs], *pad,
            resid.data_ptr() if resid is not None else 0],
           [M, N, K, len(ws), EPILOGUES[epilogue], geo["bn"], geo["ctas"]],
           [scale])
    return geo


def _check_width(name: str, M: int, D: int, Fd: int = 32):
    if D % 32 or Fd % 32 or D > 768:
        raise ValueError(f"{name}: unsupported shape M={M} D={D} F={Fd}")


@register_kernel("fused_ln_qkv")
def fused_ln_qkv(x, p, *, scale: float):
    """Kernel K3 on CUDA tensors (bf16), its plain version on CPU tensors.
    Returns (q, k, v), each [M, D], with ``scale`` folded into q."""
    if not x.is_cuda:
        return ln_qkv_plain(x, p, scale=scale)
    require_no_grad("fused_ln_qkv", [x, *[p[k] for k in _QKV_ORDER]])
    M, D = x.shape
    _check_width("fused_ln_qkv", M, D)
    check_cuda_args("fused_ln_qkv", {"x": x, **{k: p[k] for k in _QKV_ORDER}})
    y = _ln_rows(x, p["ln_w"], p["ln_b"])
    q, k, v = (torch.empty_like(x) for _ in range(3))
    _gemm(y, [p["wq"], p["wk"], p["wv"]], [p["bq"], p["bk"], p["bv"]],
          [q, k, v], epilogue="bias", scale=scale)
    fused_ln_qkv.launches += 1
    return q, k, v


@register_kernel("fused_proj_mlp")
def fused_proj_mlp(att, x, p):
    """Kernel K4 on CUDA tensors (bf16), its plain version on CPU tensors."""
    if not x.is_cuda:
        return proj_mlp_plain(att, x, p)
    require_no_grad("fused_proj_mlp", [att, x, *[p[k] for k in _MLP_ORDER]])
    M, D = x.shape
    Fd = p["w1"].shape[0]
    _check_width("fused_proj_mlp", M, D, Fd)
    if att.shape != x.shape:
        raise ValueError("fused_proj_mlp: att and x shapes differ")
    check_cuda_args("fused_proj_mlp",
                    {"att": att, "x": x, **{k: p[k] for k in _MLP_ORDER}})
    h = torch.empty(M, D, dtype=torch.float32, device=x.device)
    _gemm(att, [p["wo"]], [p["bo"]], [h], epilogue="resid_f32", resid=x)
    y = _ln_rows(h, p["ln_w"], p["ln_b"])
    hid = torch.empty(M, Fd, dtype=x.dtype, device=x.device)
    _gemm(y, [p["w1"]], [p["b1"]], [hid], epilogue="gelu")
    out = torch.empty_like(x)
    _gemm(hid, [p["w2"]], [p["b2"]], [out], epilogue="resid_bf16", resid=h)
    fused_proj_mlp.launches += 1
    return out
