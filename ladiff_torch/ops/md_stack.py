"""Kernel 11: the whole MD-trans skip stack in one launch.  Replaces
``ladiff_tpu/ops/pallas_md_stack.py`` ``fused_md_stack`` (:217,
``pl.pallas_call`` at :278).

    for each of L layers in U-Net order (inputs, middle, outputs):
        [output block: x <- Linear(2D -> D)([x, skip popped])]
        x <- MD layer(x)                  (K1's layer, one text token)
        [input block: push x as a skip]
    out <- LN(x)

Only the sampling layout is taken, as in the JAX kernel: every sample
shares the step's AdaLN rows ``ca_ss`` / ``ffn_ss`` [L, 2D], one row per
layer.  In bf16 activations are rounded to bf16 at each layer boundary,
as the per-layer path rounds them; in float32 nothing is rounded, as in
the plain version.

What bounds it on the H100: at the sampling shape (2B = 512 samples x 5
rows, D 256, F 1024, 9 layers) one launch is 9 K1 layers (~7.7 GFLOP
each) plus 4 skip products (~0.7 GFLOP each) against 26 MB of bf16
weights, so the tensor cores bound it: ~0.072 ms.  The design
(``csrc/md_stack.cu``): one cluster of D / 64 CTAs per row group of whole
samples (K1's geometry, ``md_geometry``) runs all layers with K1's
cluster body (``csrc/md_body_cluster.cuh``): each CTA computes its 64
columns of every product, the weight slices stream from one layer into
the next, and every intermediate stays in shared memory or registers; a
skip Linear is split on its output columns like the layers' products,
the CTAs exchanging their skip columns first.  The skips go to a global
scratch in which each CTA writes and reads back its own columns
(L2-resident).  Float32 inputs (the published configurations' type) take
the float32 chain ``f32_layer.md_stack_f32`` instead: K1's float32 chain
layer by layer, each skip Linear one GEMM over [x, skip] written in place
by the layers around it, the final LN (131 launches at 9 layers).  It has
no backward: on CUDA tensors it raises while a gradient is required.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.cuda_common import (check_cuda_args, launch,
                                          register_kernel, require_no_grad)
from ladiff_torch.ops.f32_layer import md_stack_f32
from ladiff_torch.ops.md_layer import (_PARAM_ORDER, md_launch_geometry,
                                       md_layer_plain, md_layer_supported)

__all__ = ["fused_md_stack", "md_stack_plain", "stack_md_params",
           "STACK_PARAM_ORDER"]

STACK_PARAM_ORDER = _PARAM_ORDER + ("lin_w", "lin_b", "norm_w", "norm_b")


def stack_md_params(layers: Sequence[Dict[str, torch.Tensor]],
                    linears: Sequence[nn.Linear], norm: nn.LayerNorm,
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The stack's tensors in ``dtype``: each of K1's 24 names (``layers``:
    ``MDTransformerLayer.kernel_params()`` in execution order) stacked to
    [L, ...]; the skip Linears as "lin_w" [nb, D, 2D] and "lin_b" [nb, D];
    the final LayerNorm as "norm_w", "norm_b" [D]."""
    out = {k: torch.stack([p[k].detach() for p in layers]).to(dtype)
           for k in _PARAM_ORDER}
    D = norm.weight.shape[0]
    out["lin_w"] = torch.stack([m.weight.detach() for m in linears]).to(
        dtype) if linears else out["ca_w"].new_empty(0, D, 2 * D)
    out["lin_b"] = torch.stack([m.bias.detach() for m in linears]).to(
        dtype) if linears else out["ca_b"].new_empty(0, D)
    out["norm_w"] = norm.weight.detach().to(dtype)
    out["norm_b"] = norm.bias.detach().to(dtype)
    return {k: v.contiguous() for k, v in out.items()}


def md_stack_plain(x, extra, kvalid, values, ca_ss, ffn_ss, stacked, *,
                   T: int, E: int, H: int) -> torch.Tensor:
    """Plain PyTorch version: ``md_layer_plain`` looped over the stack with
    the skip wiring of ``_SkipStack.run``, then the final LayerNorm.  x
    [B*T, D]; extra [B*E, D]; kvalid [B*T]; values [L, B, D]; ca_ss /
    ffn_ss [L, 2D]; stacked: ``stack_md_params``."""
    D = x.shape[-1]
    dt = x.dtype
    L = values.shape[0]
    nb = (L - 1) // 2
    skips = []
    for l in range(L):
        if l > nb:
            j = l - nb - 1
            x = F.linear(torch.cat([x, skips.pop()], dim=-1),
                         stacked["lin_w"][j].to(dt),
                         stacked["lin_b"][j].to(dt))
        x = md_layer_plain(x, extra, kvalid, values[l], ca_ss[l:l + 1],
                           ffn_ss[l:l + 1],
                           {k: stacked[k][l] for k in _PARAM_ORDER},
                           T=T, E=E, H=H)
        if l < nb:
            skips.append(x)
    return F.layer_norm(x, (D,), stacked["norm_w"].to(dt),
                        stacked["norm_b"].to(dt), 1e-5)


@register_kernel("fused_md_stack")
def fused_md_stack(x, extra, kvalid, values, ca_ss, ffn_ss, stacked, *,
                   T: int, E: int, H: int) -> torch.Tensor:
    """Kernel 11 on CUDA tensors (bf16, or float32 through its float32
    chain; kvalid float32), its plain version on CPU tensors."""
    if not x.is_cuda:
        return md_stack_plain(x, extra, kvalid, values, ca_ss, ffn_ss,
                              stacked, T=T, E=E, H=H)
    require_no_grad("fused_md_stack",
                    [x, extra, values, ca_ss, ffn_ss, *stacked.values()])
    BT, D = x.shape
    B = BT // T
    L = values.shape[0]
    nb = (L - 1) // 2
    F1, F2 = stacked["w1"].shape[1], stacked["fw1"].shape[1]
    if (BT != B * T or L % 2 == 0 or extra.shape != (B * E, D)
            or values.shape != (L, B, D) or ca_ss.shape != (L, 2 * D)
            or ffn_ss.shape != (L, 2 * D)
            or stacked["sa_in_w"].shape[0] != L
            or stacked["lin_w"].shape != (nb, D, 2 * D)
            or not md_layer_supported(B, T, E, D, H, F1, F2)):
        raise ValueError(f"fused_md_stack: unsupported shape B={B} T={T} "
                         f"E={E} D={D} H={H} F={F1},{F2} L={L}")
    check_cuda_args("fused_md_stack",
                    {"x": x, "extra": extra, "kvalid": kvalid,
                     "values": values, "ca_ss": ca_ss, "ffn_ss": ffn_ss,
                     **{k: stacked[k] for k in STACK_PARAM_ORDER}},
                    f32=("kvalid",))
    if x.dtype == torch.float32:
        out = md_stack_f32(x, extra, kvalid, values, ca_ss, ffn_ss, stacked,
                           T=T, E=E, H=H)
        fused_md_stack.launches += 1
        return out
    g = md_launch_geometry("md_stack", x.device, B, T, E, D, F1, F2)
    skips = torch.empty(max(nb, 1), BT, D, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    launch("md_stack", "md_stack_forward", x.device,
           [x.data_ptr(), extra.data_ptr(), kvalid.data_ptr(),
            values.data_ptr(), ca_ss.data_ptr(), ffn_ss.data_ptr(),
            *[stacked[k].data_ptr() for k in STACK_PARAM_ORDER],
            skips.data_ptr(), out.data_ptr()],
           [B, T, E, D, H, F1, F2, L, g["samples_per_group"],
            g["row_groups"], g["cluster"]])
    fused_md_stack.launches += 1
    return out
