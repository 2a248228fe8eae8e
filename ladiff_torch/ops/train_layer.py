"""Kernel 12: one whole post-norm transformer encoder layer in training,
forward and backward.  Replaces ``ladiff_tpu/ops/pallas_train_layer.py``
``train_encoder_layer`` (:207; ``pl.pallas_call`` forward :244, backward
:294).

    qkv  = x Wqkv^T + bqkv                      # torch in_proj layout
    ctx  = (softmax(q k^T / sqrt(Dh) + key bias) * pm) v     per head
    r    = x + (ctx Wout^T + bout) * rm         # residual dropout
    h    = LN1(r)
    out  = LN2(h + (act(h W1^T + b1) * m1 W2^T + b2) * m2)

and its VJP in x and the twelve parameters (``ENC_PARAM_ORDER``): kernel
8's function followed by kernel 9's, as one.  ``train_encoder_layer`` is a
``torch.autograd.Function``: on CUDA tensors forward and backward are the
hand-written kernels of ``csrc/train_layer.cu``, on CPU tensors
``train_encoder_layer_plain`` and ``train_encoder_layer_bwd_plain``.

Design on Hopper.  What makes it one layer and not kernels 8 and 9 back to
back: the forward's last launch goes, per 64-row block, from the attention
context to the layer's output (out-projection, residual dropout, LN1, the
FFN, LN2) with the residual ``r``, ``h`` and the hidden rows in registers
and shared memory only, so the split route's round trip of ``r`` through
device memory (written by kernel 8, read by kernel 9 and saved for its
backward) is gone; the backward's first launch goes per block from ``dout``
to ``dctx`` (the tail's backward, LN1's, the residual dropout's and the
out-projection's).  The tails (``csrc/tail64.cuh``) run 8 warps over 64
rows with mma.sync register accumulators and a three-stage cp.async
weight ring, so each byte of weight read from L2 serves 64 rows; the FFN's
hidden dimension goes in 128-column chunks with the second product
accumulating in registers, and the LayerNorms reduce over the accumulator
registers.  Around them the launches are kernel 8's
(``csrc/train_attn.cuh``, ``csrc/train_gemm.cuh``): the qkv product and
``dx = dr + dqkv Wqkv`` on the TMA + ``wgmma`` GEMM block, the
register-resident flash attention forward and its two backward launches
(query side, key side: no atomics); and the split-K weight gradients
with a fixed-order reduction (``train_common.cuh``).  The wrapper is that
fixed sequence, counted once each way.  What bounds it on the H100: ~22
GFLOP forward and ~44 GFLOP backward of needed work at 64 x 206 rows
against tens of MB: the tensor cores.

Dropout: Philox keyed by the call's seed, a mask id and the element index
(``ops/train_ffn.py``).  Masks 0 (probabilities, element ((b H + h) S + i)
S + j), 1 (residual, row D + c), 2 (FFN hidden, row F + c), 3 (FFN output,
row D + c); ``train_encoder_layer_masks`` writes all four out for a seed.

What is saved for the backward: x, kvalid, the parameters in x's type, the
seed, and as kernel 8 does qkv, ctx and the log-sum-exp (the TPU kernel
saved only its inputs; the function is the same).

In float32 (the published configurations' type) the wrappers run kernel
12's float32 design instead (``ops/f32_train.py`` on
``csrc/f32_train_layer.cu``): every product on the tensor cores in
three-term TF32, LN1 and LN2 in the epilogues of the out-projection and
W2, five launches forward; the forward also saves r, h, the
pre-activation, the hidden rows and the pre-LN2 sum, so the backward (nine
launches) recomputes no product; under the same shape gate.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ladiff_torch.ops.clip_layer import gemm_cluster_slots
from ladiff_torch.ops.cuda_common import (check_cuda_args, draw_seed,
                                          dropout_mask, launch,
                                          register_kernel)
from ladiff_torch.ops.f32_train import (train_encoder_layer_f32,
                                        train_encoder_layer_f32_bwd)
from ladiff_torch.ops.postnorm_ffn import (ACTIVATIONS, FFN_PARAM_ORDER,
                                           postnorm_ffn_supported)
from ladiff_torch.ops.train_attention import (ATTN_PARAM_ORDER,
                                              _geo_ints,
                                              attention_gemm_geometry,
                                              train_attention_supported,
                                              train_self_attention_bwd_plain,
                                              train_self_attention_plain)
from ladiff_torch.ops.train_ffn import (_seed_args, split_rows,
                                        train_postnorm_ffn_bwd_plain,
                                        train_postnorm_ffn_plain)

__all__ = ["train_encoder_layer", "train_encoder_layer_fwd",
           "train_encoder_layer_bwd", "train_encoder_layer_plain",
           "train_encoder_layer_bwd_plain", "train_encoder_layer_masks",
           "train_encoder_layer_supported", "ENC_PARAM_ORDER"]

ENC_PARAM_ORDER = ATTN_PARAM_ORDER + FFN_PARAM_ORDER
Masks = Optional[Tuple[torch.Tensor, ...]]


def train_encoder_layer_supported(S: int, D: int, H: int, F: int,
                                  activation: str) -> bool:
    """Whether kernel 12 takes the layer: the JAX package's gate (at least
    32 tokens, ReLU or GELU) and the CUDA kernel's shapes (kernel 8's
    attention and kernel 9's FFN tail)."""
    return (train_attention_supported(S, D, H)
            and postnorm_ffn_supported(D, F, activation))


def _split(p, masks):
    attn = {k: p[k] for k in ATTN_PARAM_ORDER}
    ffn = {k: p[k] for k in FFN_PARAM_ORDER}
    pm, rm, m1, m2 = masks if masks is not None else (None,) * 4
    return attn, ffn, (pm, rm), (m1, m2)


def train_encoder_layer_plain(x: torch.Tensor, kvalid: torch.Tensor, p,
                              masks: Masks = None, *, H: int, S: int,
                              activation: str = "gelu") -> torch.Tensor:
    """Plain PyTorch forward.  x [B*S, D]; kvalid [B*S] float key validity;
    p: ``ENC_PARAM_ORDER`` tensors (torch layouts); masks: (pm [B, H, S, S],
    rm [B*S, D], m1 [B*S, F], m2 [B*S, D]) keep-masks scaled by 1 / keep,
    or None at rate 0."""
    attn, ffn, am, fm = _split(p, masks)
    r = train_self_attention_plain(x, kvalid, attn, am, H=H, S=S)
    return train_postnorm_ffn_plain(r, ffn, fm, activation=activation)


def train_encoder_layer_bwd_plain(x: torch.Tensor, kvalid: torch.Tensor,
                                  dout: torch.Tensor, p, masks: Masks = None,
                                  *, H: int, S: int,
                                  activation: str = "gelu"
                                  ) -> Tuple[torch.Tensor,
                                             Dict[str, torch.Tensor]]:
    """The hand-derived backward in tensor ops, the specification of the
    backward kernels: the tail's backward from the recomputed residual r,
    then the attention segment's with dr.  Returns (dx, {parameter name:
    gradient})."""
    attn, ffn, am, fm = _split(p, masks)
    r = train_self_attention_plain(x, kvalid, attn, am, H=H, S=S)
    dr, g_ffn = train_postnorm_ffn_bwd_plain(r, dout, ffn, fm,
                                             activation=activation)
    dx, g_attn = train_self_attention_bwd_plain(x, kvalid, dr, attn, am,
                                                H=H, S=S)
    return dx, {**g_attn, **g_ffn}


def _check_shape(name, x, kvalid, p, H, S, activation):
    M, D = x.shape
    B = M // max(S, 1)
    Fd = p["w1"].shape[0]
    if (M != B * S or kvalid.shape != (M,)
            or not train_encoder_layer_supported(S, D, H, Fd, activation)
            or p["in_w"].shape != (3 * D, D) or p["out_w"].shape != (D, D)
            or p["w1"].shape != (Fd, D) or p["w2"].shape != (D, Fd)):
        raise ValueError(f"{name}: unsupported shape M={M} S={S} D={D} H={H}"
                         f" F={Fd} activation={activation}")
    return B, Fd


@register_kernel("train_encoder_layer")
def train_encoder_layer_fwd(x: torch.Tensor, kvalid: torch.Tensor, p, *,
                            H: int, S: int, activation: str = "gelu",
                            rate: float = 0.0, seed: int = 0,
                            masks: Masks = None, return_saved: bool = False):
    """The forward alone (no autograd graph): kernel 12's forward on CUDA
    tensors (bf16, or float32 through its float32 chain; kvalid float32), the
    plain version with ``masks`` on CPU tensors.  ``return_saved`` also returns
    (qkv, ctx, lse), in float32 followed by (r, h, a, gd, s), None on the
    CPU."""
    if not x.is_cuda:
        out = train_encoder_layer_plain(x, kvalid, p, masks, H=H, S=S,
                                        activation=activation)
        return (out, None) if return_saved else out
    if masks is not None:
        raise ValueError("train_encoder_layer: the CUDA kernel draws its own "
                         "masks from (rate, seed)")
    B, Fd = _check_shape("train_encoder_layer", x, kvalid, p, H, S,
                         activation)
    M, D = x.shape
    lo, hi = _seed_args(rate, seed)
    dev = x.device
    if x.dtype == torch.float32:
        check_cuda_args("train_encoder_layer",
                        {"x": x, "kvalid": kvalid,
                         **{k: p[k] for k in ENC_PARAM_ORDER}},
                        f32=("kvalid",))
        out, saved = train_encoder_layer_f32(
            x, kvalid, p, H=H, S=S, activation=activation,
            drop=(lo, hi, rate))
        train_encoder_layer_fwd.launches += 1
        return (out, saved) if return_saved else out
    qkv = torch.empty(M, 3 * D, dtype=x.dtype, device=dev)
    ctx = torch.empty(M, D, dtype=x.dtype, device=dev)
    lse = torch.empty(M, H, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    check_cuda_args("train_encoder_layer",
                    {"x": x, "kvalid": kvalid, "lse": lse,
                     **{k: p[k] for k in ENC_PARAM_ORDER}},
                    f32=("kvalid", "lse"))
    ptrs = [x.data_ptr(), kvalid.data_ptr(),
            *[p[k].data_ptr() for k in ENC_PARAM_ORDER], qkv.data_ptr(),
            ctx.data_ptr(), lse.data_ptr(), out.data_ptr()]
    geo = attention_gemm_geometry(M, D, H, gemm_cluster_slots(dev))
    launch("train_layer", "train_layer_forward", dev, ptrs,
           [B, S, D, H, Fd, ACTIVATIONS[activation], lo, hi,
            *_geo_ints(geo["qkv"])], [rate])
    train_encoder_layer_fwd.launches += 1
    return (out, (qkv, ctx, lse)) if return_saved else out


@register_kernel("train_encoder_layer_bwd")
def train_encoder_layer_bwd(x: torch.Tensor, kvalid: torch.Tensor,
                            dout: torch.Tensor, p, saved=None, *, H: int,
                            S: int, activation: str = "gelu",
                            rate: float = 0.0, seed: int = 0,
                            masks: Masks = None
                            ) -> Tuple[torch.Tensor,
                                       Dict[str, torch.Tensor]]:
    """The backward: kernel 12's backward on CUDA tensors (bf16 or float32;
    ``saved`` = the forward's saved tensors; float32 parameter gradients),
    the plain backward on CPU tensors."""
    if not x.is_cuda:
        return train_encoder_layer_bwd_plain(x, kvalid, dout, p, masks, H=H,
                                             S=S, activation=activation)
    if masks is not None or saved is None:
        raise ValueError("train_encoder_layer_bwd: the CUDA kernel takes the "
                         "forward's saved tensors and draws its own masks "
                         "from (rate, seed)")
    B, Fd = _check_shape("train_encoder_layer_bwd", x, kvalid, p, H, S,
                         activation)
    M, D = x.shape
    qkv, ctx, lse = saved[:3]
    f32_saved = (() if x.dtype != torch.float32 else
                 ((M, D), (M, D), (M, Fd), (M, Fd), (M, D)))
    if (dout.shape != x.shape or qkv.shape != (M, 3 * D)
            or ctx.shape != (M, D) or lse.shape != (M, H)
            or [tuple(t.shape) for t in saved[3:]] != list(f32_saved)):
        raise ValueError("train_encoder_layer_bwd: saved tensors do not "
                         "match x")
    lo, hi = _seed_args(rate, seed)
    if x.dtype == torch.float32:
        check_cuda_args("train_encoder_layer_bwd",
                        {"x": x, "kvalid": kvalid, "dout": dout,
                         **{f"saved{i}": t for i, t in enumerate(saved)},
                         **{k: p[k] for k in ENC_PARAM_ORDER}},
                        f32=("kvalid", "saved2"))
        dx, grads = train_encoder_layer_f32_bwd(
            x, kvalid, dout, p, saved, H=H, S=S, activation=activation,
            drop=(lo, hi, rate))
        train_encoder_layer_bwd.launches += 1
        return dx, grads
    dev, bf, f32 = x.device, x.dtype, torch.float32
    split = split_rows(M)
    nblk = (M + 63) // 64  # the tails' 64-row blocks

    def rows(n, dt=bf):
        return torch.empty(M, n, dtype=dt, device=dev)

    scratch = {"r": rows(D, f32), "h": rows(D), "gd": rows(Fd),
               "da": rows(Fd), "dy": rows(D), "dr": rows(D),
               "dattn": rows(D), "dctx": rows(D), "delta": rows(H, f32),
               "dqkv": rows(3 * D),
               "lnpart": torch.empty(nblk, 4 * D, dtype=f32, device=dev),
               "wpart": torch.empty(split, max(3 * D * D, Fd * D), dtype=f32,
                                    device=dev)}
    dx = torch.empty_like(x)
    grads = {k: torch.empty(p[k].shape, dtype=f32, device=dev)
             for k in ENC_PARAM_ORDER}
    check_cuda_args("train_encoder_layer_bwd",
                    {"x": x, "kvalid": kvalid, "dout": dout, "qkv": qkv,
                     "ctx": ctx, "lse": lse, "dx": dx, **scratch,
                     **{k: p[k] for k in ENC_PARAM_ORDER},
                     **{"d" + k: g for k, g in grads.items()}},
                    f32=("kvalid", "lse", "r", "delta", "lnpart", "wpart",
                         *["d" + k for k in ENC_PARAM_ORDER]))
    ptrs = [x.data_ptr(), kvalid.data_ptr(), dout.data_ptr(),
            *[p[k].data_ptr() for k in ENC_PARAM_ORDER], qkv.data_ptr(),
            ctx.data_ptr(), lse.data_ptr(),
            *[t.data_ptr() for t in scratch.values()], dx.data_ptr(),
            *[grads[k].data_ptr() for k in ENC_PARAM_ORDER]]
    geo = attention_gemm_geometry(M, D, H, gemm_cluster_slots(dev))
    launch("train_layer", "train_layer_backward", dev, ptrs,
           [B, S, D, H, Fd, ACTIVATIONS[activation], lo, hi, split,
            *_geo_ints(geo["dx"])], [rate])
    train_encoder_layer_bwd.launches += 1
    return dx, grads


def train_encoder_layer_masks(B: int, S: int, D: int, H: int, Fd: int,
                              rate: float, seed: int, device
                              ) -> Tuple[torch.Tensor, ...]:
    """The four keep-masks (scaled by 1 / keep, float32) that the CUDA
    kernels draw for ``seed``: (pm [B, H, S, S], rm [B*S, D], m1 [B*S, F],
    m2 [B*S, D])."""
    lo, hi = _seed_args(rate, seed)
    dev = torch.device(device)
    M = B * S
    masks = tuple(torch.empty(*shape, dtype=torch.float32, device=dev)
                  for shape in ((B, H, S, S), (M, D), (M, Fd), (M, D)))
    check_cuda_args("train_encoder_layer_masks",
                    {f"m{i}": m for i, m in enumerate(masks)},
                    f32=tuple(f"m{i}" for i in range(4)))
    launch("train_layer", "train_layer_masks", dev,
           [m.data_ptr() for m in masks], [B, S, D, H, Fd, lo, hi], [rate])
    return masks


class _TrainEncoderLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kvalid, H, S, activation, rate, seed, masks,
                *params):
        ctx.H, ctx.S, ctx.rate, ctx.seed = H, S, rate, seed
        ctx.activation = activation
        ctx.param_dtypes = [w.dtype for w in params]
        if x.is_cuda:  # the kernels take x's type: cast the parameters once
            params = tuple(w.detach().to(x.dtype).contiguous()
                           for w in params)
        p = dict(zip(ENC_PARAM_ORDER, params))
        out, saved = train_encoder_layer_fwd(
            x, kvalid, p, H=H, S=S, activation=activation, rate=rate,
            seed=seed, masks=masks, return_saved=True)
        ctx.n_saved = 0 if saved is None else len(saved)
        ctx.save_for_backward(x, kvalid, *params, *(saved or ()),
                              *(masks or ()))
        return out

    @staticmethod
    def backward(ctx, dout):
        x, kvalid, *rest = ctx.saved_tensors
        n = len(ENC_PARAM_ORDER)
        p = dict(zip(ENC_PARAM_ORDER, rest[:n]))
        saved = tuple(rest[n:n + ctx.n_saved]) or None
        masks = tuple(rest[n + ctx.n_saved:]) or None
        dx, grads = train_encoder_layer_bwd(
            x, kvalid, dout.contiguous(), p, saved, H=ctx.H, S=ctx.S,
            activation=ctx.activation, rate=ctx.rate, seed=ctx.seed,
            masks=masks)
        gparams = [grads[k].to(dt) for k, dt in zip(ENC_PARAM_ORDER,
                                                    ctx.param_dtypes)]
        return (dx, None, None, None, None, None, None, None, *gparams)


def train_encoder_layer(x: torch.Tensor, kvalid: torch.Tensor, p, *,
                        H: int, S: int, activation: str = "gelu",
                        rate: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        seed: Optional[int] = None) -> torch.Tensor:
    """Kernel 12, differentiable in x and the twelve parameters.  x [B*S, D]
    (bf16 or float32 on CUDA); kvalid [B*S] float32; p: ``ENC_PARAM_ORDER``
    tensors in any float type (cast to x's type on the way in; their gradients
    come back in their own type).  With ``rate > 0`` one 64-bit seed is drawn
    from ``generator`` per call (or taken from ``seed``); on CPU tensors the
    four masks come from ``generator`` directly."""
    params = [p[k] for k in ENC_PARAM_ORDER]
    masks = None
    if x.is_cuda:
        if rate > 0.0 and seed is None:
            seed = draw_seed(generator)
    elif rate > 0.0:
        M, D = x.shape
        masks = tuple(dropout_mask(shape, rate, x, generator) for shape in (
            (M // S, H, S, S), (M, D), (M, p["w1"].shape[0]), (M, D)))
    return _TrainEncoderLayer.apply(x, kvalid, H, S, activation, float(rate),
                                    seed or 0, masks, *params)
