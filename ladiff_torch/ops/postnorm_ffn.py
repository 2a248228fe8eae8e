"""Kernel 5: the post-norm FFN tail of a transformer layer, inference.
Replaces ``ladiff_tpu/ops/pallas_postnorm_ffn.py`` ``fused_postnorm_ffn``
(:64, ``pl.pallas_call`` at :82).

    h   = LN1(x)                       # x = residual sum (src + attn)
    out = LN2(h + W2 act(W1 h + b1) + b2)      act: ReLU or exact-erf GELU

What bounds it on the H100: at the VAE encoder's shape (128 x 206 rows,
D 256, F 1024) one launch is ~27.6 GFLOP of bf16 products against ~27 MB
of activations, far above the 295 FLOP/byte ridge, so the tensor cores
bound it.  The CUDA version (``csrc/postnorm_ffn.cu``, body shared with
kernel 9's forward in ``csrc/ffn_tail.cuh``) walks 32-row blocks: LN1 per
row by one warp in f32, the FFN width in 256-column chunks (W1 chunk ->
activation -> bf16 hidden in shared memory), then the W2 product over the
whole hidden row block, the residual and LN2; no intermediate leaves
shared memory.

It has no backward: called on CUDA tensors while a gradient is required
it raises (``require_no_grad``); training layers use ``train_postnorm_ffn``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import (check_cuda_args, launch,
                                          register_kernel, require_no_grad)

__all__ = ["fused_postnorm_ffn", "postnorm_ffn_plain", "FFN_PARAM_ORDER",
           "ACTIVATIONS", "check_ffn_shape", "postnorm_ffn_supported"]

ACTIVATIONS = {"relu": 0, "gelu": 1}
FFN_PARAM_ORDER = ("ln1_w", "ln1_b", "w1", "b1", "w2", "b2", "ln2_w",
                   "ln2_b")


def postnorm_ffn_plain(x: torch.Tensor, p, *, activation: str = "gelu"
                       ) -> torch.Tensor:
    """Plain PyTorch version.  x [M, D]; p: ``FFN_PARAM_ORDER`` tensors in
    the torch layouts (w1 [F, D], w2 [D, F])."""
    D = x.shape[-1]
    w = {k: p[k].to(x.dtype) for k in FFN_PARAM_ORDER}
    act = F.relu if activation == "relu" else F.gelu
    h = F.layer_norm(x, (D,), w["ln1_w"], w["ln1_b"], 1e-5)
    y = F.linear(act(F.linear(h, w["w1"], w["b1"])), w["w2"], w["b2"])
    return F.layer_norm(h + y, (D,), w["ln2_w"], w["ln2_b"], 1e-5)


def postnorm_ffn_supported(D: int, F: int, activation: str) -> bool:
    """Whether kernels 5 and 9 take an FFN tail of width D, hidden width F:
    D a multiple of 64 up to 256 (a row's values in a warp's registers, the
    256-column product chunk), F a multiple of 128 up to 1024 (the hidden
    rows in shared memory), ReLU or GELU.  A tail that fails it runs as
    plain ``layer_norm`` / ``linear`` ops (the JAX package's XLA path)."""
    return (D % 64 == 0 and 0 < D <= 256 and F % 128 == 0 and 0 < F <= 1024
            and activation in ACTIVATIONS)


def check_ffn_shape(name: str, x: torch.Tensor, p, activation: str,
                    d_multiple: int = 32) -> int:
    """Raises on a shape the FFN-tail kernels do not take; returns F."""
    M, D = x.shape
    Fd = p["w1"].shape[0]
    if (M < 1 or D % d_multiple or D > 256 or Fd % 128 or Fd > 1024
            or p["w1"].shape != (Fd, D) or p["w2"].shape != (D, Fd)
            or activation not in ACTIVATIONS):
        raise ValueError(f"{name}: unsupported shape M={M} D={D} F={Fd} "
                         f"activation={activation}")
    return Fd


@register_kernel("fused_postnorm_ffn")
def fused_postnorm_ffn(x: torch.Tensor, p, *, activation: str = "gelu"
                       ) -> torch.Tensor:
    """Kernel 5 on CUDA tensors (bf16), its plain version on CPU tensors."""
    if not x.is_cuda:
        return postnorm_ffn_plain(x, p, activation=activation)
    require_no_grad("fused_postnorm_ffn",
                    [x, *[p[k] for k in FFN_PARAM_ORDER]])
    Fd = check_ffn_shape("fused_postnorm_ffn", x, p, activation)
    check_cuda_args("fused_postnorm_ffn",
                    {"x": x, **{k: p[k] for k in FFN_PARAM_ORDER}})
    M, D = x.shape
    out = torch.empty_like(x)
    ptrs = [x.data_ptr(), *[p[k].data_ptr() for k in FFN_PARAM_ORDER],
            out.data_ptr()]
    launch("postnorm_ffn", "postnorm_ffn_forward", x.device, ptrs,
           [M, D, Fd, ACTIVATIONS[activation]])
    fused_postnorm_ffn.launches += 1
    return out
