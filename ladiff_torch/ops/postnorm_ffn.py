"""Kernel 5: the post-norm FFN tail of a transformer layer, inference.
Replaces ``ladiff_tpu/ops/pallas_postnorm_ffn.py`` ``fused_postnorm_ffn``
(:64, ``pl.pallas_call`` at :82).

    h   = LN1(x)                       # x = residual sum (src + attn)
    out = LN2(h + W2 act(W1 h + b1) + b2)      act: ReLU or exact-erf GELU

What bounds it on the H100: at the VAE encoder's shape (128 x 206 rows,
D 256, F 1024) one launch is ~27.6 GFLOP of bf16 products against ~27 MB
of activations, far above the 295 FLOP/byte ridge, so the tensor cores
bound it.  The CUDA version (``csrc/postnorm_ffn.cu``, body shared with
kernel 9's forward in ``csrc/ffn_tail64.cuh``) runs 64-row blocks of 16
warps (``csrc/tail64.cuh``): LN1 on the f32 accumulator registers, the
FFN in 128-column hidden chunks (the W1 product, activation, bf16 hidden
chunk in shared memory, its W2 product accumulating y in registers) with
the weights streaming through a cp.async ring, then the residual and LN2;
no intermediate leaves the block.  Where the blocks cannot fill the card
(the MD layers' 2560 rows are 40 blocks on 132 SMs), ``ffn_geometry``
gives each block a cluster of C CTAs that split the hidden width: each
computes LN1, its F / C hidden columns and its partial of y, the partials
are reduce-scattered in rank order through distributed shared memory and
LN2's statistics combined across the cluster, each CTA storing D / C
output columns.

It has no backward: called on CUDA tensors while a gradient is required
it raises (``require_no_grad``); training layers use ``train_postnorm_ffn``.

In float32 (the published configurations' type) the wrapper runs kernel
5's float32 chain, ``f32_layer.postnorm_ffn_f32``: LN1, the W1 product
with its activation, the W2 product with the residual, LN2, four launches
of ``csrc/f32_layer.cu``, at the shapes ``postnorm_ffn_supported`` takes.
Kernel 9 (the training tail) takes float32 the same way, through its
float32 chain in ``ops/f32_train.py``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import (check_cuda_args, launch, library,
                                          register_kernel, require_no_grad)
from ladiff_torch.ops.f32_layer import postnorm_ffn_f32

__all__ = ["fused_postnorm_ffn", "postnorm_ffn_plain", "FFN_PARAM_ORDER",
           "ACTIVATIONS", "check_ffn_shape", "postnorm_ffn_supported",
           "ffn_geometry", "ffn_launch_geometry"]

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
    D a multiple of 64 up to 256 (the 64-row block's instantiations, D / 32
    accumulator tiles of 8 columns a warp), F a multiple of 128 up to 1024
    (whole 128-column hidden chunks), ReLU or GELU.  A tail that fails it
    runs as plain ``layer_norm`` / ``linear`` ops (the JAX package's XLA
    path)."""
    return (D % 64 == 0 and 0 < D <= 256 and F % 128 == 0 and 0 < F <= 1024
            and activation in ACTIVATIONS)


def check_ffn_shape(name: str, x: torch.Tensor, p, activation: str) -> int:
    """Raises on a shape the FFN-tail kernels do not take (where
    ``postnorm_ffn_supported`` is false, or the weights do not match x);
    returns F."""
    M, D = x.shape
    Fd = p["w1"].shape[0]
    if (M < 1 or not postnorm_ffn_supported(D, Fd, activation)
            or p["w1"].shape != (Fd, D) or p["w2"].shape != (D, Fd)):
        raise ValueError(f"{name}: unsupported shape M={M} D={D} F={Fd} "
                         f"activation={activation}")
    return Fd


# csrc/tail64.cuh: rows of a block, hidden columns of a chunk
_ROWS, _CHUNK = 64, 128


def ffn_geometry(M: int, D: int, F: int, slots: int, cluster: int = 0):
    """The launch geometry of the FFN tail's forward (kernels 5 and 9):
    (64-row blocks, CTAs a block C, CTAs).  ``slots`` CTAs fit on the card
    at once; C is the largest of 4, 2 (F / C a multiple of 128) for which
    blocks x C still fits them, so a launch of few rows splits each block's
    hidden width over a cluster and fills the card once; C is 1 where the
    blocks alone fill it.  ``cluster`` > 0 asks for that C (a sweep)."""
    blocks = -(-M // _ROWS)
    allowed = [c for c in (1, 2, 4) if F % (_CHUNK * c) == 0]
    if cluster:
        if cluster not in allowed:
            raise ValueError(f"ffn_geometry: cluster {cluster} does not "
                             f"split F={F} into 128-column chunks")
        C = cluster
    else:
        C = max(c for c in allowed if c == 1 or blocks * c <= slots)
    return blocks, C, blocks * C


_SLOTS = {}


def _slots(lib_name: str, device: torch.device, D: int) -> int:
    """CTAs of the forward at width D that fit on ``device`` at once (the
    library's occupancy query, cached; the SM count where it fails)."""
    key = (lib_name, device.index, D)
    if key not in _SLOTS:
        fn = getattr(library(lib_name), f"{lib_name}_slots")
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            n = fn(D)
        if n <= 0:
            n = torch.cuda.get_device_properties(
                device).multi_processor_count
        _SLOTS[key] = n
    return _SLOTS[key]


def ffn_launch_geometry(lib_name: str, device, M: int, D: int, F: int,
                        cluster: int = 0) -> dict:
    """``ffn_geometry`` on ``device`` for the library ``lib_name``
    (postnorm_ffn or train_ffn), as a record."""
    slots = _slots(lib_name, torch.device(device), D)
    blocks, C, ctas = ffn_geometry(M, D, F, slots, cluster)
    return {"rows": M, "blocks": blocks, "cluster": C, "ctas": ctas,
            "slots": slots}


@register_kernel("fused_postnorm_ffn")
def fused_postnorm_ffn(x: torch.Tensor, p, *, activation: str = "gelu",
                       cluster: int = 0) -> torch.Tensor:
    """Kernel 5 on CUDA tensors (bf16, or float32 through its float32
    chain), its plain version on CPU tensors.  ``cluster`` > 0 sets the
    CTAs a block of the bf16 kernel (``ffn_geometry``'s choice by
    default)."""
    if not x.is_cuda:
        return postnorm_ffn_plain(x, p, activation=activation)
    require_no_grad("fused_postnorm_ffn",
                    [x, *[p[k] for k in FFN_PARAM_ORDER]])
    Fd = check_ffn_shape("fused_postnorm_ffn", x, p, activation)
    check_cuda_args("fused_postnorm_ffn",
                    {"x": x, **{k: p[k] for k in FFN_PARAM_ORDER}})
    if x.dtype == torch.float32:
        out = postnorm_ffn_f32(x, p, activation=activation)
        fused_postnorm_ffn.launches += 1
        return out
    M, D = x.shape
    g = ffn_launch_geometry("postnorm_ffn", x.device, M, D, Fd, cluster)
    out = torch.empty_like(x)
    ptrs = [x.data_ptr(), *[p[k].data_ptr() for k in FFN_PARAM_ORDER],
            out.data_ptr()]
    launch("postnorm_ffn", "postnorm_ffn_forward", x.device, ptrs,
           [M, D, Fd, ACTIVATIONS[activation], g["cluster"]])
    fused_postnorm_ffn.launches += 1
    return out
