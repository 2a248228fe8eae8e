"""Kernels K3 and K4: the two halves of a CLIP text layer around its causal
attention core.  Replace ``ladiff_tpu/ops/pallas_clip_layer.py``
``fused_ln_qkv`` (:65, ``pl.pallas_call`` at :82) and ``fused_proj_mlp``
(:113, ``pl.pallas_call`` at :129).

    K3  fused_ln_qkv:   y = LN1(x); q = (y Wq + bq) * scale;
                        k = y Wk + bk; v = y Wv + bv
    K4  fused_proj_mlp: h = x + att Wo + bo;
                        out = h + fc2(quick_gelu(fc1(LN2(h))))

What bounds them on the H100: at the bench shape (256 captions x 32 tokens
= 8192 rows, width 768, MLP 3072) K3 is ~29 GFLOP and K4 ~87 GFLOP against
~15 / ~30 MB, well above the ridge: the tensor cores bound both.  Design
(``csrc/clip_layer.cu``): 32-row blocks with the LayerNorm computed in f32
in the block's prologue and kept in shared memory as the bf16 A operand;
products are WMMA bf16 tiles with f32 accumulation, weights read from
global memory.  K3 runs one block per (row block, output matrix) so the
three projections fill the card.  K4 keeps the [32, 768] residual sum in
f32 shared memory as the accumulator of fc2 and walks the MLP width in
256-column chunks (fc1 chunk -> quick-GELU -> bf16 -> accumulate fc2),
because the whole fc1 output of even a 32-row tile would not fit beside it.
Unlike the JAX package, which fuses only at S <= 32 in half precision, the
port runs both kernels at every bucket on the card.  Neither has a backward
(the tower is frozen): on CUDA tensors they raise while a gradient is
required.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import (check_cuda_args, launch,
                                          register_kernel, require_no_grad)

__all__ = ["fused_ln_qkv", "fused_proj_mlp", "ln_qkv_plain",
           "proj_mlp_plain"]

_QKV_ORDER = ("wq", "bq", "wk", "bk", "wv", "bv", "ln_w", "ln_b")
_MLP_ORDER = ("wo", "bo", "w1", "b1", "w2", "b2", "ln_w", "ln_b")


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
    q, k, v = (torch.empty_like(x) for _ in range(3))
    launch("clip_layer", "ln_qkv_forward", x.device,
           [x.data_ptr(), *[p[n].data_ptr() for n in _QKV_ORDER],
            q.data_ptr(), k.data_ptr(), v.data_ptr()], [M, D], [scale])
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
    out = torch.empty_like(x)
    launch("clip_layer", "proj_mlp_forward", x.device,
           [att.data_ptr(), x.data_ptr(),
            *[p[n].data_ptr() for n in _MLP_ORDER], out.data_ptr()],
           [M, D, Fd])
    fused_proj_mlp.launches += 1
    return out
