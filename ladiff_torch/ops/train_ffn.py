"""Kernel 9: the post-norm FFN tail of a transformer layer in training,
forward and backward.  Replaces ``ladiff_tpu/ops/pallas_train_ffn.py``
``train_postnorm_ffn`` (:209; ``pl.pallas_call`` forward :232, backward
:263).

    h   = LN1(x)                  # x = residual sum (src + drop(attn))
    a   = h W1^T + b1
    gd  = act(a) * m1             # dropout mask 1 on [M, F]
    y   = gd W2^T + b2
    out = LN2(h + y * m2)         # dropout mask 2 on [M, D]

and its VJP in x and the eight parameters.  ``train_postnorm_ffn`` is a
``torch.autograd.Function``: on CUDA tensors the forward and the backward
are the hand-written kernels of ``csrc/train_ffn.cu``; on CPU tensors they
are ``train_postnorm_ffn_plain`` and ``train_postnorm_ffn_bwd_plain``.

Dropout.  The masks are never stored: element ``i`` of mask ``k`` is
Philox-4x32-10 keyed by the call's 64-bit seed at counter (i, k), kept when
``bits < keep * 2^32`` and scaled by ``1 / keep``, so the backward
regenerates what the forward drew whatever the two grids are.
``train_postnorm_ffn_masks`` writes both masks out for a seed, for checks
against the plain version.

What is saved for the backward: ``x``, the parameters in x's type and the
seed, nothing else; the backward recomputes h, a, gd, y and both
LayerNorms per 64-row block (as the TPU kernel does per row block).

In float32 (the published configurations' type) the wrappers run kernel
9's float32 chain instead (``ops/f32_train.py``: LN1, the W1 product with
its activation and hidden dropout, the W2 product with the output dropout
and the residual, LN2; the backward recomputes that forward and runs the
LayerNorms' backward one warp a row, dy W2 and da W1 products, split-K
weight gradients and fixed-order reductions, 12 launches, FFMA in float32
throughout), under the same shape gate and the same masks.

The kernels (``csrc/train_ffn.cu`` on ``csrc/ffn_tail64.cuh``) run
64-row blocks of 16 warps with the activations in f32 registers: the
forward is kernel 5's body with dropout, and, where the blocks cannot fill
the card, a cluster of C CTAs per block splitting the hidden width
(``postnorm_ffn.ffn_geometry``: 640 rows of the denoiser take C = 4).  The
backward's row-block launch recomputes LN1 from x, the FFN and LN2, then
runs LN2's backward, the FFN's backward in 128-column hidden chunks (dh
accumulating in registers) and LN1's backward from x reloaded.

Weight gradients across blocks.  The row-block launch writes ``h``, ``gd``,
``da`` and ``dy`` (bf16, the rounding points of the TPU kernel) to scratch,
and per block the float32 column sums of the LayerNorm gradients and of
``da`` and ``dy`` (the bias gradients) to a partial buffer, which
reduction launches sum over the blocks in a fixed order; ``dW1 = da^T h``
and ``dW2 = dy^T gd`` are split-K tensor-core products whose float32
partials are summed the same way, so gradients are deterministic (no
atomics).  The wrapper is that fixed sequence of launches, counted once.
Parameter gradients are float32; ``dx`` has x's type.

What bounds it on the H100: forward ~27.6 GFLOP, backward ~83 GFLOP (five
M x D x F products plus the recomputed forward's two) against tens of MB:
the tensor cores.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import (check_cuda_args, draw_seed,
                                          dropout_mask, launch,
                                          register_kernel, split_seed)
from ladiff_torch.ops.f32_train import (train_postnorm_ffn_f32,
                                        train_postnorm_ffn_f32_bwd)
from ladiff_torch.ops.postnorm_ffn import (ACTIVATIONS, FFN_PARAM_ORDER,
                                           check_ffn_shape,
                                           ffn_launch_geometry)

__all__ = ["train_postnorm_ffn", "train_postnorm_ffn_fwd",
           "train_postnorm_ffn_bwd", "train_postnorm_ffn_plain",
           "train_postnorm_ffn_bwd_plain", "train_postnorm_ffn_masks",
           "ln_bwd", "split_rows"]

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
Masks = Optional[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]


def _ln_fwd(x, w, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + 1e-5)
    xhat = (x - mu) * inv
    return xhat * w + b, xhat, inv


def ln_bwd(dout, xhat, inv, w):
    """VJP of LayerNorm: (dx, dweight, dbias)."""
    g = dout * w
    dx = inv * (g - g.mean(-1, keepdim=True)
                - xhat * (g * xhat).mean(-1, keepdim=True))
    return dx, (dout * xhat).sum(0), dout.sum(0)


def _act(a, activation):
    return F.relu(a) if activation == "relu" else F.gelu(a)


def _act_grad(a, activation):
    if activation == "relu":
        return (a > 0).to(a.dtype)
    cdf = 0.5 * (1.0 + torch.erf(a * _INV_SQRT2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * a * a)
    return cdf + a * pdf


def _mul(t, m):
    return t if m is None else t * m


def train_postnorm_ffn_plain(x: torch.Tensor, p, masks: Masks = None, *,
                             activation: str = "gelu") -> torch.Tensor:
    """Plain PyTorch forward.  x [M, D]; p: ``FFN_PARAM_ORDER`` tensors
    (torch layouts); masks: (m1 [M, F], m2 [M, D]) keep-masks already scaled
    by 1 / keep, or None at rate 0."""
    m1, m2 = masks if masks is not None else (None, None)
    D = x.shape[-1]
    w = {k: p[k].to(x.dtype) for k in FFN_PARAM_ORDER}
    h = F.layer_norm(x, (D,), w["ln1_w"], w["ln1_b"], 1e-5)
    gd = _mul(_act(F.linear(h, w["w1"], w["b1"]), activation), m1)
    y = F.linear(gd, w["w2"], w["b2"])
    return F.layer_norm(h + _mul(y, m2), (D,), w["ln2_w"], w["ln2_b"], 1e-5)


def train_postnorm_ffn_bwd_plain(x: torch.Tensor, dout: torch.Tensor, p,
                                 masks: Masks = None, *,
                                 activation: str = "gelu"
                                 ) -> Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """The hand-derived backward in tensor ops, the specification of the
    backward kernel: (dx, {parameter name: gradient})."""
    m1, m2 = masks if masks is not None else (None, None)
    w = {k: p[k].to(x.dtype) for k in FFN_PARAM_ORDER}
    dout = dout.to(x.dtype)
    h, xhat1, inv1 = _ln_fwd(x, w["ln1_w"], w["ln1_b"])
    a = F.linear(h, w["w1"], w["b1"])
    gd = _mul(_act(a, activation), m1)
    y = F.linear(gd, w["w2"], w["b2"])
    _, xhat2, inv2 = _ln_fwd(h + _mul(y, m2), w["ln2_w"], w["ln2_b"])

    ds, g_ln2w, g_ln2b = ln_bwd(dout, xhat2, inv2, w["ln2_w"])
    dy = _mul(ds, m2)
    da = _mul(dy @ w["w2"], m1) * _act_grad(a, activation)
    dh = ds + da @ w["w1"]
    dx, g_ln1w, g_ln1b = ln_bwd(dh, xhat1, inv1, w["ln1_w"])
    grads = {"ln1_w": g_ln1w, "ln1_b": g_ln1b, "w1": da.t() @ h,
             "b1": da.sum(0), "w2": dy.t() @ gd, "b2": dy.sum(0),
             "ln2_w": g_ln2w, "ln2_b": g_ln2b}
    return dx, grads


def split_rows(M: int) -> int:
    """Number of row ranges the split-K weight-gradient products use."""
    return max(1, min(32, M // 1024))


def _seed_args(rate: float, seed: int) -> Tuple[int, int]:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    return split_seed(seed if rate > 0.0 else 0)


@register_kernel("train_postnorm_ffn")
def train_postnorm_ffn_fwd(x: torch.Tensor, p, *, activation: str = "gelu",
                           rate: float = 0.0, seed: int = 0,
                           masks: Masks = None, cluster: int = 0
                           ) -> torch.Tensor:
    """The forward alone (no autograd graph): kernel 9's forward on CUDA
    tensors (bf16, or float32 through its float32 chain; dropout from
    ``rate`` and ``seed``; ``cluster`` > 0 sets the CTAs a block of the
    bf16 kernel, ``ffn_geometry``'s choice by default), the plain version
    with ``masks`` on CPU tensors."""
    if not x.is_cuda:
        return train_postnorm_ffn_plain(x, p, masks, activation=activation)
    if masks is not None:
        raise ValueError("train_postnorm_ffn: the CUDA kernel draws its own "
                         "masks from (rate, seed)")
    Fd = check_ffn_shape("train_postnorm_ffn", x, p, activation)
    check_cuda_args("train_postnorm_ffn",
                    {"x": x, **{k: p[k] for k in FFN_PARAM_ORDER}})
    M, D = x.shape
    lo, hi = _seed_args(rate, seed)
    if x.dtype == torch.float32:
        out = train_postnorm_ffn_f32(x, p, activation=activation,
                                     drop=(lo, hi, rate))
        train_postnorm_ffn_fwd.launches += 1
        return out
    g = ffn_launch_geometry("train_ffn", x.device, M, D, Fd, cluster)
    out = torch.empty_like(x)
    ptrs = [x.data_ptr(), *[p[k].data_ptr() for k in FFN_PARAM_ORDER],
            out.data_ptr()]
    launch("train_ffn", "train_ffn_forward", x.device, ptrs,
           [M, D, Fd, ACTIVATIONS[activation], lo, hi, g["cluster"]],
           [rate])
    train_postnorm_ffn_fwd.launches += 1
    return out


@register_kernel("train_postnorm_ffn_bwd")
def train_postnorm_ffn_bwd(x: torch.Tensor, dout: torch.Tensor, p, *,
                           activation: str = "gelu", rate: float = 0.0,
                           seed: int = 0, masks: Masks = None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The backward: kernel 9's backward on CUDA tensors (bf16 or float32
    inputs, float32 parameter gradients), the plain backward on CPU
    tensors."""
    if not x.is_cuda:
        return train_postnorm_ffn_bwd_plain(x, dout, p, masks,
                                            activation=activation)
    if masks is not None:
        raise ValueError("train_postnorm_ffn_bwd: the CUDA kernel draws its "
                         "own masks from (rate, seed)")
    Fd = check_ffn_shape("train_postnorm_ffn_bwd", x, p, activation)
    M, D = x.shape
    if dout.shape != x.shape:
        raise ValueError("train_postnorm_ffn_bwd: dout must have x's shape")
    lo, hi = _seed_args(rate, seed)
    if x.dtype == torch.float32:
        check_cuda_args("train_postnorm_ffn_bwd",
                        {"x": x, "dout": dout,
                         **{k: p[k] for k in FFN_PARAM_ORDER}})
        dx, grads = train_postnorm_ffn_f32_bwd(x, dout, p,
                                               activation=activation,
                                               drop=(lo, hi, rate))
        train_postnorm_ffn_bwd.launches += 1
        return dx, grads
    dev, bf, f32 = x.device, x.dtype, torch.float32
    split = split_rows(M)
    nblk = -(-M // 64)  # the 64-row blocks' LayerNorm and bias partials
    scratch = {"h": torch.empty(M, D, dtype=bf, device=dev),
               "gd": torch.empty(M, Fd, dtype=bf, device=dev),
               "da": torch.empty(M, Fd, dtype=bf, device=dev),
               "dy": torch.empty(M, D, dtype=bf, device=dev)}
    part = torch.empty(nblk, 5 * D + Fd, dtype=f32, device=dev)
    wpart = torch.empty(split, Fd * D, dtype=f32, device=dev)
    dx = torch.empty_like(x)
    shapes = {k: p[k].shape for k in FFN_PARAM_ORDER}
    grads = {k: torch.empty(shapes[k], dtype=f32, device=dev)
             for k in FFN_PARAM_ORDER}
    check_cuda_args("train_postnorm_ffn_bwd",
                    {"x": x, "dout": dout, "dx": dx, "part": part,
                     "wpart": wpart, **scratch,
                     **{k: p[k] for k in FFN_PARAM_ORDER},
                     **{"d" + k: g for k, g in grads.items()}},
                    f32=("part", "wpart",
                         *["d" + k for k in FFN_PARAM_ORDER]))
    ptrs = [x.data_ptr(), dout.data_ptr(),
            *[p[k].data_ptr() for k in FFN_PARAM_ORDER], dx.data_ptr(),
            *[scratch[k].data_ptr() for k in ("h", "gd", "da", "dy")],
            part.data_ptr(), wpart.data_ptr(),
            *[grads[k].data_ptr() for k in FFN_PARAM_ORDER]]
    launch("train_ffn", "train_ffn_backward", dev, ptrs,
           [M, D, Fd, ACTIVATIONS[activation], lo, hi, split], [rate])
    train_postnorm_ffn_bwd.launches += 1
    return dx, grads


def train_postnorm_ffn_masks(M: int, D: int, Fd: int, rate: float, seed: int,
                             device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two keep-masks (scaled by 1 / keep, float32) that the CUDA
    kernels draw for ``seed``: (m1 [M, F], m2 [M, D])."""
    lo, hi = _seed_args(rate, seed)
    dev = torch.device(device)
    m1 = torch.empty(M, Fd, dtype=torch.float32, device=dev)
    m2 = torch.empty(M, D, dtype=torch.float32, device=dev)
    check_cuda_args("train_postnorm_ffn_masks", {"m1": m1, "m2": m2},
                    f32=("m1", "m2"))
    launch("train_ffn", "train_ffn_masks", dev,
           [m1.data_ptr(), m2.data_ptr()], [M, D, Fd, lo, hi], [rate])
    return m1, m2


class _TrainPostnormFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, activation, rate, seed, m1, m2, *params):
        ctx.activation, ctx.rate, ctx.seed = activation, rate, seed
        ctx.param_dtypes = [w.dtype for w in params]
        masks = None if m1 is None else (m1, m2)
        if x.is_cuda:  # the kernels take x's type: cast the parameters once
            params = tuple(w.detach().to(x.dtype).contiguous()
                           for w in params)
        p = dict(zip(FFN_PARAM_ORDER, params))
        ctx.save_for_backward(x, *params, *(masks or ()))
        return train_postnorm_ffn_fwd(x, p, activation=activation, rate=rate,
                                      seed=seed, masks=masks)

    @staticmethod
    def backward(ctx, dout):
        x, *rest = ctx.saved_tensors
        n = len(FFN_PARAM_ORDER)
        p = dict(zip(FFN_PARAM_ORDER, rest[:n]))
        masks = tuple(rest[n:]) or None
        dx, grads = train_postnorm_ffn_bwd(
            x, dout.contiguous(), p, activation=ctx.activation,
            rate=ctx.rate, seed=ctx.seed, masks=masks)
        gparams = [grads[k].to(dt) for k, dt in zip(FFN_PARAM_ORDER,
                                                    ctx.param_dtypes)]
        return (dx, None, None, None, None, None, *gparams)


def train_postnorm_ffn(x: torch.Tensor, p, *, activation: str = "gelu",
                       rate: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       seed: Optional[int] = None) -> torch.Tensor:
    """Kernel 9, differentiable in x and the eight parameters.  x [M, D]
    (bf16 or float32 on CUDA); p: ``FFN_PARAM_ORDER`` tensors in any float type
    (cast to x's type on the way in; their gradients come back in their own
    type).  With ``rate > 0`` one 64-bit seed is drawn from ``generator`` per
    call (or taken from ``seed``); on CPU tensors the masks come from
    ``generator`` directly."""
    params = [p[k] for k in FFN_PARAM_ORDER]
    m1 = m2 = None
    if x.is_cuda:
        if rate > 0.0 and seed is None:
            seed = draw_seed(generator)
    elif rate > 0.0:
        M, D = x.shape
        m1 = dropout_mask((M, p["w1"].shape[0]), rate, x, generator)
        m2 = dropout_mask((M, D), rate, x, generator)
    return _TrainPostnormFFN.apply(x, activation, float(rate), seed or 0,
                                   m1, m2, *params)
