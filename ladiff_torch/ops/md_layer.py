"""Kernel K1: one whole MD-trans denoiser layer.  Replaces
``ladiff_tpu/ops/pallas_md_layer.py`` ``fused_md_layer`` (:198,
``pl.pallas_call`` at :313).

    sa:  each sample's T latent rows attend over [its latents ; its E extra
         rows] (text and time, keys/values only, always valid; latent keys
         masked by the latent mask; keys never cross samples), H heads
         -> out-proj + residual -> LN -> ReLU FFN -> + residual -> LN
    ca:  single-text-token collapse: value row x latent mask -> LN ->
         AdaLN(scale, shift) -> SiLU -> proj + residual (a masked row is a
         zero row, whose LN is the LN bias; kept as it is)
    ffn: GELU FFN -> LN -> AdaLN -> SiLU -> proj + residual

What bounds it on the H100: at the sampling shape (2B = 512 samples x 5
rows, D 256, F 1024) one launch is ~7.7 GFLOP against 2.88 MB of bf16
weights (1.44 M parameters) and ~1.3 MB of activations: ~7.8 us of tensor
work at the bf16 peak, so the tensor cores bound it in principle.  It runs
450 times per generation batch and each launch is short, so what decides
its time is how much of the card one launch keeps busy and how often each
byte of weight is fetched.  The design (``csrc/md_body_cluster.cuh``):
one cluster of C = D / 64 CTAs per row group of whole samples (up to 96
latent rows and their extra rows), CTA c computing columns [64 c, 64 c +
64) of every product and F / C of each FFN's hidden columns, so a row
group's weights are read once per cluster, and the groups sized from B so
that the clusters fill the card once (``md_geometry``: an H100 holds 30
clusters of 4 at once, so 2B = 512 takes 29 groups of 18 samples, 116
CTAs).  H a multiple of C keeps each head in
one CTA, so the 7-key attention needs no exchange; the CTAs exchange the
next A operand, LayerNorm statistics and the FFN's second-product partials
through distributed shared memory.  Products are mma.sync bf16 tiles with
f32 register accumulators, the weight slices stream through one cp.async
ring across products, the residual stream stays in registers.  The layer
body is shared with kernel 11, which runs the whole skip stack in one
launch.  CUDA graphs for the 450 launches are a later step.

In float32 (the published configurations' type) the wrapper runs K1's
float32 chain, ``f32_layer.md_layer_f32``: 14 launches of the FFMA GEMM,
row-norm and attention kernels of ``csrc/f32_layer.cu``, at the shapes
``md_layer_supported`` takes.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ladiff_torch.ops.attention_kernel import masked_attention_plain
from ladiff_torch.ops.cuda_common import (check_cuda_args, launch, library,
                                          register_kernel, require_no_grad)
from ladiff_torch.ops.f32_layer import md_layer_f32

__all__ = ["fused_md_layer", "md_layer_plain", "md_layer_supported",
           "md_geometry", "md_launch_geometry", "md_smem_bytes"]

_PARAM_ORDER = ("sa_in_w", "sa_in_b", "sa_out_w", "sa_out_b", "ln1_w",
                "ln1_b", "w1", "b1", "w2", "b2", "ln2_w", "ln2_b",
                "ca_ln_w", "ca_ln_b", "ca_w", "ca_b", "fw1", "fb1", "fw2",
                "fb2", "f_ln_w", "f_ln_b", "fp_w", "fp_b")


# csrc/md_body_cluster.cuh: a CTA's columns, the row group's latent and
# extra rows, the FFN's hidden chunk, the weight ring, a block's shared
# memory on an H100
_CW, _ROWS, _EXTRA, _HC, _RING = 64, 96, 48, 256, 4 * 64 * 72 * 2
_SEGS, _SMEM_MAX = 48, 232448


def _align128(n: int) -> int:
    return (n + 127) & ~127


def md_smem_bytes(D: int, F1: int, F2: int) -> int:
    """Dynamic shared memory of the cluster body's CTA at width D and FFN
    widths F1, F2 (``md_cluster_layout`` in ``csrc/md_body_cluster.cuh``)."""
    C = D // _CW
    nch = max(-(-(F1 // C) // _HC), -(-(F2 // C) // _HC))
    big = max((_ROWS + 2 * (_ROWS + _EXTRA)) * (_CW + 8) * 2,
              _ROWS * (_HC + 8) * 2, _ROWS * (D + 8) * 2)
    recv = max((C - 1) * nch * _ROWS * _CW * 4, _EXTRA * (D + 8) * 2)
    n = _align128(_ROWS * (D + 8) * 2)
    n = _align128(n + big)
    n = _align128(n + recv)
    n = _align128(n + _RING)
    n = _align128(n + 4 * C * _ROWS * 8)
    n = _align128(n + _ROWS * 8)
    n = _align128(n + _ROWS * 8)
    n = _align128(n + _ROWS * 4)
    return _align128(n + _SEGS * 32)


def _nsegs(D: int, F1: int, F2: int) -> int:
    """Weight segments of one layer (``md_nsegs``)."""
    C = D // _CW
    return sum(F // C // _CW + -(-(F // C) // _HC) * C + 1
               for F in (F1, F2)) + 5


def md_layer_supported(B: int, T: int, E: int, D: int, H: int, F1: int,
                       F2: int) -> bool:
    """Whether K1 (and kernel 11, which runs K1's layer body) takes a layer
    of this shape: B samples of T latent rows and E extra rows, width D, H
    heads, FFN widths F1 (the ReLU block) and F2 (the stylized one).  A
    cluster of C = D / 64 CTAs (D a multiple of 64 up to 256) with whole
    heads in each CTA (H a multiple of C, head width a multiple of 8), at
    most 32 rows of each kind per sample, FFN widths multiples of D (at
    most 47 weight segments a layer), and the CTA's shared memory within
    the card's."""
    if not (B >= 1 and 1 <= T <= 32 and 1 <= E <= 32 and D % _CW == 0
            and _CW <= D <= 4 * _CW and H >= 1):
        return False
    C = D // _CW
    return (H % C == 0 and D % H == 0 and (D // H) % 8 == 0
            and F1 >= D and F1 % D == 0 and F2 >= D and F2 % D == 0
            and _nsegs(D, F1, F2) < _SEGS
            and md_smem_bytes(D, F1, F2) <= _SMEM_MAX)


def md_geometry(B: int, T: int, E: int, D: int, slots: int,
                spg: int = 0):
    """The launch geometry of K1 and kernel 11: (samples per row group, row
    groups, cluster size C, CTAs).  A row group holds whole samples, at
    most 96 latent and 48 extra rows; ``slots`` clusters fit on the card at
    once, and the groups are made as large as it takes for B samples to
    fill them once.  ``spg`` > 0 asks for that group size (capped)."""
    C = D // _CW
    most = min(_ROWS // T, _EXTRA // E)
    if spg <= 0:
        spg = -(-B // max(1, slots))
    spg = max(1, min(most, spg))
    groups = -(-B // spg)
    return spg, groups, C, groups * C


_SLOTS = {}


def _slots(lib_name: str, device: torch.device, D: int,
           *widths: int) -> int:
    """Clusters of a kernel that fit on ``device`` at once (the library's
    occupancy query ``<lib_name>_slots(D, *widths)``, cached; the SM count
    over C where it fails)."""
    key = (lib_name, device.index, D, *widths)
    if key not in _SLOTS:
        fn = getattr(library(lib_name), f"{lib_name}_slots")
        fn.argtypes = [ctypes.c_int] * (1 + len(widths))
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            n = fn(D, *widths)
        if n <= 0:
            n = torch.cuda.get_device_properties(
                device).multi_processor_count // (D // _CW)
        _SLOTS[key] = n
    return _SLOTS[key]


def md_launch_geometry(lib_name: str, device, B: int, T: int, E: int,
                       D: int, F1: int, F2: int, spg: int = 0) -> dict:
    """``md_geometry`` on ``device`` for the library ``lib_name`` (md_layer
    or md_stack), as a record."""
    slots = _slots(lib_name, torch.device(device), D, F1, F2)
    spg, groups, C, ctas = md_geometry(B, T, E, D, slots, spg)
    return {"samples_per_group": spg, "row_groups": groups, "cluster": C,
            "ctas": ctas, "cluster_slots": slots}


def md_layer_plain(x, extra, kvalid, value, ca_ss, ffn_ss, p, *, T: int,
                   E: int, H: int) -> torch.Tensor:
    """Plain PyTorch version.  x [B*T, D] latent rows; extra [B*E, D] text
    and time rows; kvalid [B*T] float latent validity; value [B, D] the
    collapsed text value; ca_ss / ffn_ss [1 or B, 2D] AdaLN (scale, shift)
    rows, one row shared by all samples or one per sample."""
    BT, D = x.shape
    B = BT // T
    dt = x.dtype
    w = {k: v.to(dt) for k, v in p.items()}

    def ln(a, name):
        return F.layer_norm(a, (D,), w[name + "_w"], w[name + "_b"], 1e-5)

    xb = x.reshape(B, T, D)
    kv_in = torch.cat([xb, extra.to(dt).reshape(B, E, D)], dim=1)
    q = F.linear(xb, w["sa_in_w"][:D], w["sa_in_b"][:D])
    k, v = F.linear(kv_in, w["sa_in_w"][D:], w["sa_in_b"][D:]).split(D, -1)
    lat_valid = kvalid.reshape(B, T) > 0.5
    valid = torch.cat([lat_valid, torch.ones(B, E, dtype=torch.bool,
                                             device=x.device)], dim=1)
    att = masked_attention_plain(q, k, v, valid, num_heads=H)
    h1 = ln(xb + F.linear(att, w["sa_out_w"], w["sa_out_b"]), "ln1")
    y = F.linear(F.relu(F.linear(h1, w["w1"], w["b1"])), w["w2"], w["b2"])
    x2 = ln(h1 + y, "ln2")

    ca_scale, ca_shift = ca_ss.to(dt).reshape(-1, 1, 2 * D).split(D, -1)
    f_scale, f_shift = ffn_ss.to(dt).reshape(-1, 1, 2 * D).split(D, -1)
    yv = value.to(dt).reshape(B, 1, D) * kvalid.to(dt).reshape(B, T, 1)
    h2 = F.silu(ln(yv, "ca_ln") * (1 + ca_scale) + ca_shift)
    x3 = x2 + F.linear(h2, w["ca_w"], w["ca_b"])
    y2 = F.linear(F.gelu(F.linear(x3, w["fw1"], w["fb1"])),
                  w["fw2"], w["fb2"])
    h3 = F.silu(ln(y2, "f_ln") * (1 + f_scale) + f_shift)
    return (x3 + F.linear(h3, w["fp_w"], w["fp_b"])).reshape(BT, D)


@register_kernel("fused_md_layer")
def fused_md_layer(x, extra, kvalid, value, ca_ss, ffn_ss, p, *, T: int,
                   E: int, H: int) -> torch.Tensor:
    """Kernel K1 on CUDA tensors (bf16, or float32 through its float32
    chain), its plain version on CPU tensors.  The kernel has no backward:
    on CUDA tensors it raises while a gradient is required (a training-mode
    MD layer takes its unfused route)."""
    if not x.is_cuda:
        return md_layer_plain(x, extra, kvalid, value, ca_ss, ffn_ss, p,
                              T=T, E=E, H=H)
    require_no_grad("fused_md_layer",
                    [x, extra, value, ca_ss, ffn_ss,
                     *[p[k] for k in _PARAM_ORDER]])
    BT, D = x.shape
    B = BT // T
    F1, F2 = p["w1"].shape[0], p["fw1"].shape[0]
    rows = ca_ss.shape[0], ffn_ss.shape[0]
    if (BT != B * T or extra.shape != (B * E, D) or value.shape != (B, D)
            or not md_layer_supported(B, T, E, D, H, F1, F2)
            or any(r not in (1, B) for r in rows)):
        raise ValueError(f"fused_md_layer: unsupported shape B={B} T={T} "
                         f"E={E} D={D} H={H} F={F1},{F2} ss rows={rows}")
    check_cuda_args("fused_md_layer",
                    {"x": x, "extra": extra, "kvalid": kvalid,
                     "value": value, "ca_ss": ca_ss, "ffn_ss": ffn_ss,
                     **{k: p[k] for k in _PARAM_ORDER}}, f32=("kvalid",))
    chain = md_layer_f32 if x.dtype == torch.float32 else _launch
    out = chain(x, extra, kvalid, value, ca_ss, ffn_ss, p, T=T, E=E, H=H)
    fused_md_layer.launches += 1
    return out


def _launch(x, extra, kvalid, value, ca_ss, ffn_ss, p, *, T: int, E: int,
            H: int, spg: int = 0) -> torch.Tensor:
    """K1's launch (checked by ``fused_md_layer``); ``spg`` > 0 sets the
    row group's sample count, as a sweep of the geometry does."""
    BT, D = x.shape
    B = BT // T
    F1, F2 = p["w1"].shape[0], p["fw1"].shape[0]
    g = md_launch_geometry("md_layer", x.device, B, T, E, D, F1, F2, spg)
    out = torch.empty_like(x)
    ptrs = [x.data_ptr(), extra.data_ptr(), kvalid.data_ptr(),
            value.data_ptr(), ca_ss.data_ptr(), ffn_ss.data_ptr(),
            *[p[k].data_ptr() for k in _PARAM_ORDER], out.data_ptr()]
    launch("md_layer", "md_layer_forward", x.device, ptrs,
           [B, T, E, D, H, F1, F2, 0 if ca_ss.shape[0] == 1 else 2 * D,
            0 if ffn_ss.shape[0] == 1 else 2 * D, g["samples_per_group"],
            g["row_groups"], g["cluster"]])
    return out
