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
(``broadcast_stylize_supported``) runs as plain ops.

What bounds it on the H100: one D x D product per row (0.34 GFLOP at 2560
rows, D 256) against reading x and writing out (2.6 MB): bytes.  The design
(``csrc/stylize.cu``) is K1's "ca" segment on its own: one block per 32
rows, the broadcast, LayerNorm, AdaLN and SiLU per row by one warp in f32
into a bf16 row block in shared memory, then the projection with x read
once in the epilogue.  It has no backward: on CUDA tensors it raises while
a gradient is required.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import (check_cuda_args, launch,
                                          register_kernel, require_no_grad)

__all__ = ["fused_broadcast_stylize", "broadcast_stylize_plain",
           "broadcast_stylize_supported", "check_broadcast_stylize_shape"]


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
    """Whether kernel 7 takes M rows of T-row samples at width D: D a
    multiple of 32 up to 256 (one warp's row of D / 32 values, one
    256-column product pass)."""
    return M >= 1 and T >= 1 and M % T == 0 and D % 32 == 0 and 32 <= D <= 256


def check_broadcast_stylize_shape(M: int, T: int, D: int) -> None:
    """Raises where ``broadcast_stylize_supported`` is false (and only
    there)."""
    if not broadcast_stylize_supported(M, T, D):
        raise ValueError(f"fused_broadcast_stylize: unsupported shape M={M} "
                         f"T={T} D={D}")


@register_kernel("fused_broadcast_stylize")
def fused_broadcast_stylize(x, value, mask, ss, ln_w, ln_b, w, b, *,
                            T: int) -> torch.Tensor:
    """Kernel 7 on CUDA tensors (bf16; the mask float32), its plain version
    on CPU tensors."""
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
    out = torch.empty_like(x)
    launch("stylize", "stylize_forward", x.device,
           [x.data_ptr(), value.data_ptr(), mask.data_ptr(), ss.data_ptr(),
            ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr()],
           [M, D, T, 0 if ss.shape[0] == 1 else 2 * D])
    fused_broadcast_stylize.launches += 1
    return out
