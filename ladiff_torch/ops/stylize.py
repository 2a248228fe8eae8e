"""Kernel 7: the MD layer's one-token cross-attention block at inference.
Replaces ``ladiff_tpu/ops/pallas_stylize.py`` ``fused_broadcast_stylize``
(:43, ``pl.pallas_call`` at :60).

With one text token the softmax-linear cross-attention collapses exactly to
the text's value row on every valid latent row (``LinearTemporalCross
Attention``), so what is left is

    out = x + W silu(LN(value_b * mask) * (1 + scale) + shift) + b

with value_b, scale and shift those of the row's sample.  The JAX kernel
takes the value and AdaLN rows repeated per latent row; this one takes one
row per sample (or one AdaLN row for all) and T, as K1 does.  It runs where
a one-token MD layer takes its per-block route at inference (a shape K1
does not take, e.g. a head width above 128); a shape it does not take
(``broadcast_stylize_supported``: D not a multiple of 64 up to 256) runs as
plain ops.

What bounds it on the H100: one D x D product per row (0.34 GFLOP at 2560
rows, D 256) against reading x and writing out (2.6 MB): bytes, ~1 us.  A
launch that short is decided by how fast it starts and how much of the card
it fills.  The design is K1's cross-attention segment on K1's cluster body
(``csrc/md_body_cluster.cuh`` ``md_value_stats``, ``md_ca_rows``,
``md_ca_project``, the code K1 and kernel 11 run; ``csrc/stylize.cu``): one
cluster of C = D / 64 CTAs per row group of at most 96 consecutive rows
(a group need not hold whole samples: a row's sample is (row0 + row) / T),
the groups sized so that the clusters fill the card once
(``broadcast_stylize_geometry``, from the library's occupancy query).  CTA
c reads its 64 columns of x straight into f32 residual registers, computes
each value row's statistics once per sample (the LayerNorm of m v is m (v -
mean) / sqrt(m^2 var + eps) for any mask value m), builds the AdaLN -> SiLU
rows of its columns, exchanges them with its peers over distributed shared
memory, and computes its 64 output columns of the projection from D / 64
weight slices streamed through the body's cp.async ring (mma.sync, f32
accumulators); a CTA's shared memory is 90 KB at D 256, so two fit on an
SM.  Float32 inputs (the published configurations' type) take the
float32 chain ``f32_layer.broadcast_stylize_f32`` instead: the collapse's
row LayerNorm, AdaLN and SiLU in one launch, the projection and residual
in a second.  It has no backward: on CUDA tensors it raises while a
gradient is required.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import (check_cuda_args, launch,
                                          register_kernel, require_no_grad)
from ladiff_torch.ops.f32_layer import broadcast_stylize_f32
from ladiff_torch.ops.md_layer import _align128, _slots
from ladiff_torch.ops.stylized_ffn import stylized_ffn_geometry

__all__ = ["fused_broadcast_stylize", "broadcast_stylize_plain",
           "broadcast_stylize_supported", "check_broadcast_stylize_shape",
           "broadcast_stylize_geometry", "broadcast_stylize_launch_geometry",
           "stylize_smem_bytes"]

# csrc/md_body_cluster.cuh: a CTA's columns, a row group's rows, the weight
# ring, the segment table, a block's shared memory on an H100
_CW, _ROWS, _RING, _SEGS, _SMEM_MAX = 64, 96, 4 * 64 * 72 * 2, 48, 232448


def stylize_smem_bytes(D: int) -> int:
    """Dynamic shared memory of kernel 7's CTA at width D (``md_ca_layout``
    in ``csrc/md_body_cluster.cuh``): the AdaLN rows, the ring, the
    per-sample statistics, the rows' mask, the segment table."""
    n = _align128(_ROWS * (D + 8) * 2)
    n = _align128(n + _RING)
    n = _align128(n + _ROWS * 8)
    n = _align128(n + _ROWS * 4)
    return _align128(n + _SEGS * 32)


def broadcast_stylize_plain(x, value, mask, ss, ln_w, ln_b, w, b, *,
                            T: int) -> torch.Tensor:
    """Plain PyTorch version.  x [M, D] rows, T per sample; value [M / T, D]
    one text value row per sample; mask [M] float row validity; ss [1 or
    M / T, 2D] AdaLN (scale, shift) rows; w [D, D] a torch Linear weight."""
    M, D = x.shape
    dt = x.dtype
    ln_w, ln_b, w, b = (t.to(dt) for t in (ln_w, ln_b, w, b))
    scale, shift = ss.to(dt).reshape(-1, 1, 2 * D).split(D, -1)
    y = value.to(dt).reshape(-1, 1, D) * mask.to(dt).reshape(-1, T, 1)
    h = F.silu(F.layer_norm(y, (D,), ln_w, ln_b, 1e-5) * (1 + scale) + shift)
    return x + F.linear(h, w, b).reshape(M, D)


def broadcast_stylize_supported(M: int, T: int, D: int) -> bool:
    """Whether kernel 7 takes M rows of T-row samples at width D: a cluster
    of C = D / 64 CTAs (D a multiple of 64 up to 256), T-row samples (row
    groups need not hold whole samples, so T is free) and the CTA's shared
    memory within the card's."""
    return (M >= 1 and T >= 1 and M % T == 0 and D % _CW == 0
            and _CW <= D <= 4 * _CW and stylize_smem_bytes(D) <= _SMEM_MAX)


def check_broadcast_stylize_shape(M: int, T: int, D: int) -> None:
    """Raises where ``broadcast_stylize_supported`` is false (and only
    there)."""
    if not broadcast_stylize_supported(M, T, D):
        raise ValueError(f"fused_broadcast_stylize: unsupported shape M={M} "
                         f"T={T} D={D}")


def broadcast_stylize_geometry(M: int, D: int, slots: int):
    """The launch geometry of kernel 7: (rows per group, row groups, cluster
    size C, CTAs), sized as kernel 6's (``stylized_ffn_geometry``):
    consecutive rows, at most 96 a group and a multiple of 16 but for the
    last group, as large as it takes for M rows to fill ``slots`` clusters
    once."""
    return stylized_ffn_geometry(M, D, slots)


def broadcast_stylize_launch_geometry(device, M: int, D: int) -> dict:
    """``broadcast_stylize_geometry`` on ``device``, as a record."""
    slots = _slots("stylize", torch.device(device), D)
    rows, groups, C, ctas = broadcast_stylize_geometry(M, D, slots)
    return {"rows_per_group": rows, "row_groups": groups, "cluster": C,
            "ctas": ctas, "cluster_slots": slots}


@register_kernel("fused_broadcast_stylize")
def fused_broadcast_stylize(x, value, mask, ss, ln_w, ln_b, w, b, *,
                            T: int) -> torch.Tensor:
    """Kernel 7 on CUDA tensors (bf16, or float32 through its float32
    chain; the mask float32), its plain version on CPU tensors."""
    if not x.is_cuda:
        return broadcast_stylize_plain(x, value, mask, ss, ln_w, ln_b, w, b,
                                       T=T)
    require_no_grad("fused_broadcast_stylize",
                    [x, value, ss, ln_w, ln_b, w, b])
    M, D = x.shape
    check_broadcast_stylize_shape(M, T, D)
    B = M // T
    if (value.shape != (B, D) or mask.shape != (M,) or w.shape != (D, D)
            or ss.shape[-1] != 2 * D or ss.shape[0] not in (1, B)):
        raise ValueError(f"fused_broadcast_stylize: value="
                         f"{tuple(value.shape)}, mask, w or ss="
                         f"{tuple(ss.shape)} do not match x [{M}, {D}]")
    check_cuda_args("fused_broadcast_stylize",
                    {"x": x, "value": value, "mask": mask, "ss": ss,
                     "ln_w": ln_w, "ln_b": ln_b, "w": w, "b": b},
                    f32=("mask",))
    chain = broadcast_stylize_f32 if x.dtype == torch.float32 else _launch
    out = chain(x, value, mask, ss, ln_w, ln_b, w, b, T=T)
    fused_broadcast_stylize.launches += 1
    return out


def _launch(x, value, mask, ss, ln_w, ln_b, w, b, *, T: int,
            rows: int = 0) -> torch.Tensor:
    """Kernel 7's launch (checked by ``fused_broadcast_stylize``); ``rows``
    > 0 sets the rows of a group (at most 96), as a sweep of the geometry
    does."""
    M, D = x.shape
    g = broadcast_stylize_launch_geometry(x.device, M, D)
    per, groups = g["rows_per_group"], g["row_groups"]
    if rows > 0:
        per = min(rows, _ROWS)
        groups = -(-M // per)
    out = torch.empty_like(x)
    launch("stylize", "stylize_forward", x.device,
           [x.data_ptr(), value.data_ptr(), mask.data_ptr(), ss.data_ptr(),
            ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr()],
           [M, D, T, 0 if ss.shape[0] == 1 else 2 * D, per, groups,
            g["cluster"]])
    return out
