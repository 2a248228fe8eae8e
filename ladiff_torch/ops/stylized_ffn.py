"""Kernel 6: the MD layer's stylized FFN at inference.  Replaces
``ladiff_tpu/ops/pallas_fused_ffn.py`` ``fused_stylized_ffn`` (:68,
``pl.pallas_call`` at :92).

    y   = W2 gelu(W1 x + b1) + b2              (exact erf GELU)
    out = x + W3 silu(LN(y) * (1 + scale) + shift) + b3

with (scale, shift) the AdaLN row of the row's sample.  It runs where an MD
layer takes its per-block route at inference: text of more than one token
(full-context CLIP features), or a shape K1 does not take.

What bounds it on the H100: at the full-context route's shape (512 samples
x 5 rows, D 256, F 1024) one launch is ~2.8 GFLOP against ~1.2 MB of
weights and ~2.6 MB of activations, so the tensor cores bound it.  The
design (``csrc/stylized_ffn.cu``) is K1's last segment on its own: one
block per 32 rows, the GELU FFN in 256-column chunks with the hidden row
block in shared memory, LayerNorm, AdaLN and SiLU per row by one warp in
f32, then the projection and residual; no intermediate leaves shared
memory.  It has no backward: on CUDA tensors it raises while a gradient is
required.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import (check_cuda_args, launch,
                                          register_kernel, require_no_grad)

__all__ = ["fused_stylized_ffn", "stylized_ffn_plain"]

_NAMES = ("w1", "b1", "w2", "b2", "ln_w", "ln_b", "w3", "b3")


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


@register_kernel("fused_stylized_ffn")
def fused_stylized_ffn(x, ss, w1, b1, w2, b2, ln_w, ln_b, w3, b3, *,
                       T: int) -> torch.Tensor:
    """Kernel 6 on CUDA tensors (bf16), its plain version on CPU tensors."""
    weights = (w1, b1, w2, b2, ln_w, ln_b, w3, b3)
    if not x.is_cuda:
        return stylized_ffn_plain(x, ss, *weights, T=T)
    require_no_grad("fused_stylized_ffn", [x, ss, *weights])
    M, D = x.shape
    Fd = w1.shape[0]
    B = M // T
    if (M < 1 or M != B * T or D % 32 or D > 256 or Fd % 32
            or w1.shape != (Fd, D) or w2.shape != (D, Fd)
            or w3.shape != (D, D) or ss.shape[-1] != 2 * D
            or ss.shape[0] not in (1, B)):
        raise ValueError(f"fused_stylized_ffn: unsupported shape M={M} T={T} "
                         f"D={D} F={Fd} ss={tuple(ss.shape)}")
    check_cuda_args("fused_stylized_ffn",
                    {"x": x, "ss": ss, **dict(zip(_NAMES, weights))})
    out = torch.empty_like(x)
    launch("stylized_ffn", "stylized_ffn_forward", x.device,
           [x.data_ptr(), ss.data_ptr(), *[t.data_ptr() for t in weights],
            out.data_ptr()],
           [M, D, Fd, T, 0 if ss.shape[0] == 1 else 2 * D])
    fused_stylized_ffn.launches += 1
    return out
