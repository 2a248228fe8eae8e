"""Kernel 6: the MD layer's stylized FFN at inference.  Replaces
``ladiff_tpu/ops/pallas_fused_ffn.py`` ``fused_stylized_ffn`` (:68,
``pl.pallas_call`` at :92).

    y   = W2 gelu(W1 x + b1) + b2              (exact erf GELU)
    out = x + W3 silu(LN(y) * (1 + scale) + shift) + b3

with (scale, shift) the AdaLN row of the row's sample.  It runs where an MD
layer takes its per-block route at inference: text of more than one token
(full-context CLIP features), or a shape K1 does not take; a shape it does
not take (``stylized_ffn_supported``) runs as plain ops, as the JAX
package's gate has it.

What bounds it on the H100: at the full-context route's shape (512 samples
x 5 rows, D 256, F 1024) one launch is ~2.8 GFLOP against ~1.2 MB of
weights and ~2.6 MB of activations, so the tensor cores bound it.  The
segment is K1's last one, so the design is K1's cluster body
(``csrc/md_body_cluster.cuh`` ``md_stylized_ffn``, the same code K1 and
kernel 11 run; ``csrc/stylized_ffn.cu``): one cluster of C = D / 64 CTAs
per row group of at most 96 rows, CTA c computing columns [64 c, 64 c +
64) of each D-wide product and F / C of the hidden columns, so a group
reads each weight once; the FFN's second product is reduce-scattered over
the cluster's shared memory, the LayerNorm's statistics exchanged, the
residual kept in f32 registers, the weights streamed through a four-stage
cp.async ring of 64-deep slices, mma.sync with ldmatrix operands.  The row
groups are sized so that the clusters fill the card once
(``stylized_ffn_geometry``).  Float32 inputs (the published
configurations' type) take the float32 chain
``f32_layer.stylized_ffn_f32`` instead: four launches of the FFMA kernels,
a row's AdaLN row that of its sample.  It has no backward: on CUDA tensors
it raises while a gradient is required.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import (check_cuda_args, launch,
                                          register_kernel, require_no_grad)
from ladiff_torch.ops.f32_layer import stylized_ffn_f32
from ladiff_torch.ops.md_layer import _slots, md_smem_bytes

__all__ = ["fused_stylized_ffn", "stylized_ffn_plain",
           "stylized_ffn_supported", "check_stylized_ffn_shape",
           "stylized_ffn_geometry", "stylized_ffn_launch_geometry"]

_NAMES = ("w1", "b1", "w2", "b2", "ln_w", "ln_b", "w3", "b3")
# csrc/md_body_cluster.cuh: a CTA's columns, a row group's rows, the FFN's
# hidden chunk, the segment table, a block's shared memory on an H100
_CW, _ROWS, _HC, _SEGS, _SMEM_MAX = 64, 96, 256, 48, 232448


def stylized_ffn_plain(x, ss, w1, b1, w2, b2, ln_w, ln_b, w3, b3, *,
                       T: int) -> torch.Tensor:
    """Plain PyTorch version.  x [M, D] rows, T per sample; ss [1 or M / T,
    2D] AdaLN (scale, shift) rows, one shared by all samples or one per
    sample; torch Linear layouts (w1 [F, D], w2 [D, F], w3 [D, D])."""
    M, D = x.shape
    dt = x.dtype
    w1, b1, w2, b2, ln_w, ln_b, w3, b3 = (
        t.to(dt) for t in (w1, b1, w2, b2, ln_w, ln_b, w3, b3))
    scale, shift = ss.to(dt).reshape(-1, 1, 2 * D).split(D, -1)
    y = F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2).reshape(-1, T, D)
    h = F.silu(F.layer_norm(y, (D,), ln_w, ln_b, 1e-5) * (1 + scale) + shift)
    return x + F.linear(h, w3, b3).reshape(M, D)


def stylized_ffn_supported(M: int, T: int, D: int, F: int) -> bool:
    """Whether kernel 6 takes M rows of T-row samples at width D, hidden
    width F: the conditions of ``md_layer_supported`` that the segment
    has.  A cluster of C = D / 64 CTAs (D a multiple of 64 up to 256), F a
    multiple of D (F / C hidden columns a CTA, in 64-column passes), its
    weight segments within the CTA's table of 48 and the CTA's shared
    memory within the card's.  Row groups need not hold whole samples, so
    T is free."""
    if not (M >= 1 and T >= 1 and M % T == 0 and D % _CW == 0
            and _CW <= D <= 4 * _CW and F >= D and F % D == 0):
        return False
    C = D // _CW
    segs = F // C // _CW + -(-(F // C) // _HC) * C + 1
    return segs < _SEGS and md_smem_bytes(D, F, F) <= _SMEM_MAX


def check_stylized_ffn_shape(M: int, T: int, D: int, F: int) -> None:
    """Raises where ``stylized_ffn_supported`` is false (and only there)."""
    if not stylized_ffn_supported(M, T, D, F):
        raise ValueError(f"fused_stylized_ffn: unsupported shape M={M} "
                         f"T={T} D={D} F={F}")


def stylized_ffn_geometry(M: int, D: int, slots: int):
    """The launch geometry of kernel 6: (rows per group, row groups, cluster
    size C, CTAs).  A group takes consecutive rows, at most 96 and a
    multiple of 16 (the body's row tiles) but for the last group; ``slots``
    clusters fit on the card at once, and the groups are as large as it
    takes for M rows to fill them once."""
    C = D // _CW
    per = -(-M // max(1, slots))
    rows = min(_ROWS, -(-per // 16) * 16)
    groups = -(-M // rows)
    return rows, groups, C, groups * C


def stylized_ffn_launch_geometry(device, M: int, D: int, F: int) -> dict:
    """``stylized_ffn_geometry`` on ``device``, as a record."""
    slots = _slots("stylized_ffn", torch.device(device), D, F, F)
    rows, groups, C, ctas = stylized_ffn_geometry(M, D, slots)
    return {"rows_per_group": rows, "row_groups": groups, "cluster": C,
            "ctas": ctas, "cluster_slots": slots}


@register_kernel("fused_stylized_ffn")
def fused_stylized_ffn(x, ss, w1, b1, w2, b2, ln_w, ln_b, w3, b3, *,
                       T: int) -> torch.Tensor:
    """Kernel 6 on CUDA tensors (bf16, or float32 through its float32
    chain), its plain version on CPU tensors."""
    weights = (w1, b1, w2, b2, ln_w, ln_b, w3, b3)
    if not x.is_cuda:
        return stylized_ffn_plain(x, ss, *weights, T=T)
    require_no_grad("fused_stylized_ffn", [x, ss, *weights])
    M, D = x.shape
    Fd = w1.shape[0]
    check_stylized_ffn_shape(M, T, D, Fd)
    if (w1.shape != (Fd, D) or w2.shape != (D, Fd) or w3.shape != (D, D)
            or ss.shape[-1] != 2 * D or ss.shape[0] not in (1, M // T)):
        raise ValueError(f"fused_stylized_ffn: the weights or ss="
                         f"{tuple(ss.shape)} do not match x [{M}, {D}]")
    check_cuda_args("fused_stylized_ffn",
                    {"x": x, "ss": ss, **dict(zip(_NAMES, weights))})
    if x.dtype == torch.float32:
        out = stylized_ffn_f32(x, ss, *weights, T=T)
        fused_stylized_ffn.launches += 1
        return out
    g = stylized_ffn_launch_geometry(x.device, M, D, Fd)
    out = torch.empty_like(x)
    launch("stylized_ffn", "stylized_ffn_forward", x.device,
           [x.data_ptr(), ss.data_ptr(), *[t.data_ptr() for t in weights],
            out.data_ptr()],
           [M, D, Fd, T, 0 if ss.shape[0] == 1 else 2 * D,
            g["rows_per_group"], g["row_groups"], g["cluster"]])
    fused_stylized_ffn.launches += 1
    return out
