"""Kernel 8: the self-attention segment of a transformer layer in training,
forward and backward.  Replaces ``ladiff_tpu/ops/pallas_train_attention.py``
``train_self_attention`` (:388; ``pl.pallas_call`` forward :434, backward
:472).

    qkv  = x Wqkv^T + bqkv                    # torch in_proj layout [3D, D]
    p    = softmax(q k^T / sqrt(Dh) + key bias)      per sample and head
    ctx  = (p * pm) v                         # probability dropout
    out  = x + (ctx Wout^T + bout) * rm       # the layer's residual dropout

and its VJP in x, Wqkv, bqkv, Wout, bout.  ``kvalid`` gates keys only
(invalid keys get the additive -1e9); padded query rows still produce
outputs and receive gradients; a sample's keys never include another
sample's rows.  ``train_self_attention`` is a ``torch.autograd.Function``:
on CUDA tensors forward and backward are the hand-written kernels of
``csrc/train_attention.cu``, on CPU tensors ``train_self_attention_plain``
and ``train_self_attention_bwd_plain``.

Design on Hopper.  A [206, 206] float32 score block per head does not fit
shared memory next to q, k and v, so attention is tiled 64 queries x 64
keys with an online softmax, in the register-resident tile of kernel 10
(``csrc/flash_tile.cuh``: mma.sync accumulators, ldmatrix operands, a
two-stage cp.async ring of key tiles, P as bf16 A-fragments; probability
dropout applied to P in registers from the same Philox elements).  The
products around it are most of the work (at 128 x 206 rows, D 256: 13.8
of the forward's 16.8 GFLOP and 27.7 of the backward's 33.7, against 28
and 42 MB of the function's inputs and outputs): the tensor cores bound
them, so they run on the TMA + ``wgmma`` GEMM block of K3 and K4
(``csrc/gemm_sm90.cuh``, via ``csrc/train_gemm.cuh``), with their bias,
residual, dropout and delta in its epilogues.  The wrapper is a fixed
sequence of launches, counted once.  Forward: the qkv product, the tiled
attention (one block per sample, head and query tile, which also writes
each row's log-sum-exp), and the out-projection with the residual and its
dropout in the epilogue.  Backward: ``dattn = dout * rm`` (one elementwise
pass; at rate 0 dout itself) and ``dctx = dattn Wout`` with the flash row
term ``delta = dctx . ctx`` in the epilogue (the identity survives the
probability dropout: sum_j dp_j p_j = dO . O with O = (p * pm) V; a
column tile holds whole heads, so delta is a quad sum over the
accumulators); then two tiled launches that recompute the probabilities
from q, k and the saved log-sum-exp with S, dP and dS in registers, one
owning query tiles (dq), one owning key tiles (dk, dv), so no atomics are
needed; key tiles without a valid key are skipped (their probabilities are
exactly 0 when the sample has a valid key); then ``dx = dout + dqkv Wqkv``.
``dctx`` and ``dx`` read the weight from its "out" side (MN-major B).
``attention_gemm_geometry`` picks each product's tile width and CTAs.

Dropout: as in ``ops/train_ffn.py`` (Philox keyed by the call's seed, the
mask id and the global element index).  Mask 0 is the probability mask,
element ((b H + h) S + i) S + j; mask 1 the residual mask, element
row D + c.  ``train_self_attention_masks`` writes both out for a seed.

What is saved for the backward: ``x``, ``kvalid``, the parameters in x's
type, the seed, and from the forward ``qkv`` [M, 3D] and ``ctx`` [M, D] in
x's type and the per-row log-sum-exp [M, H] float32 (the TPU kernel saved
only its inputs and recomputed all of it; the function is the same).

In float32 (the published configurations' type) the wrappers run kernel
8's float32 chain instead (``ops/f32_train.py``: the qkv product, the
attention with its probability dropout and log-sum-exp, the out-projection
with the residual dropout; backward in ten launches, the same query-side /
key-side split without atomics and split-K weight gradients with a
fixed-order reduction, FFMA in float32 throughout), under the same shape
gate and the same masks.

Weight gradients: ``dWqkv = dqkv^T x`` and ``dWout = dattn^T ctx`` run on
the GEMM block with both operands MN-major, the rows cut into K ranges so
that the output tiles times the ranges fill the card once
(``wgrad_geometry``); each range writes float32 partials to a workspace
and a fixed-order reduction launch sums them (deterministic, no atomics);
bias gradients are column sums by the same scheme.  Parameter gradients
are float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ladiff_torch.ops.clip_layer import (EPILOGUES, clip_gemm_geometry,
                                         gemm_cluster_slots)
from ladiff_torch.ops.cuda_common import (NEG_INF, check_cuda_args,
                                          draw_seed, dropout_mask, launch,
                                          register_kernel)
from ladiff_torch.ops.f32_train import (train_self_attention_f32,
                                        train_self_attention_f32_bwd)
from ladiff_torch.ops.train_ffn import _mul, _seed_args, split_rows

__all__ = ["train_self_attention", "train_self_attention_fwd",
           "train_self_attention_bwd", "train_self_attention_plain",
           "train_self_attention_bwd_plain", "train_self_attention_masks",
           "train_attention_supported", "ATTN_PARAM_ORDER", "MIN_TOKENS",
           "attention_gemm_geometry", "wgrad_geometry", "dctx_widths",
           "train_gemm_plain", "train_gemm_launch", "TRAIN_GEMMS"]

ATTN_PARAM_ORDER = ("in_w", "in_b", "out_w", "out_b")
# Streams shorter than this (the MD denoiser's ~7-token sa_block) are not
# what the function is for; their layers keep the plain modules.
MIN_TOKENS = 32
Masks = Optional[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]


def train_attention_supported(S: int, D: int, H: int) -> bool:
    """Whether a layer's training self-attention over S tokens runs as
    kernel 8: at least ``MIN_TOKENS`` tokens, D a multiple of 64 up to 256
    and a head width of 16, 32, 48 or 64 (the kernel's tiles).  A layer that
    fails it runs the plain attention module (the JAX package's kernel takes
    head widths up to 128 and plain attention above)."""
    return (S >= MIN_TOKENS and D % 64 == 0 and 0 < D <= 256 and H > 0
            and D % H == 0 and D // H in (16, 32, 48, 64))


# the products' tile widths (csrc/train_gemm.cuh): 192 only for q / k / v;
# a weight gradient's tiles are 128 wide
_BNS = (256, 128)
WGRAD_BN = 128
# the GEMM block's epilogues (csrc/gemm_sm90.cuh sm90::Epilogue) that the
# products use, with the operands' layouts (A MN-major, B MN-major)
TRAIN_GEMMS = {"qkv": ("bias", False, False), "out": ("add", False, False),
               "out_drop": ("add_drop", False, False),
               "dctx": ("dctx", False, True), "dx": ("add", False, True),
               "wgrad": ("part", True, True)}


def wgrad_geometry(N1: int, N2: int, K: int, slots: int = 66) -> dict:
    """The launch geometry of a weight gradient [N1, N2] = dy^T x over K
    rows: tiles of 128 x 128 paired in clusters of two, the K rows cut into
    ``splits`` ranges of ``ksplit`` rows (a multiple of 64) so that the
    tile pairs times the ranges fill the ``slots`` clusters once; range s
    covers rows [s ksplit, min(K, (s + 1) ksplit)) and the partials are
    summed in range order."""
    geo = clip_gemm_geometry(N1, N2, K, slots=slots, bn=WGRAD_BN,
                             bns=(WGRAD_BN,))
    base = geo["pairs"]
    splits = max(1, min(slots // base, -(-K // 64)))
    ksplit = -(-(-(-K // splits)) // 64) * 64
    splits = -(-K // ksplit)
    pairs = base * splits
    geo.update(splits=splits, ksplit=ksplit, pairs=pairs,
               ctas=2 * min(pairs, slots), persistent=pairs > slots,
               waves=pairs / slots,
               ranges=[(s * ksplit, min(K, (s + 1) * ksplit))
                       for s in range(splits)])
    return geo


def dctx_widths(D: int, H: int):
    """The tile widths the dctx product may take: its epilogue sums each
    head's columns, so a column tile holds whole heads (all D columns, or
    a width that is a multiple of the head width)."""
    return tuple(b for b in _BNS if D <= b or b % (D // H) == 0)


def attention_gemm_geometry(M: int, D: int, H: int,
                            slots: int = 66) -> dict:
    """Each product of kernel 8 at M rows of width D, H heads: name -> the
    launch geometry (``clip_gemm_geometry``'s record; a weight gradient's
    ``wgrad_geometry``)."""
    return {"qkv": clip_gemm_geometry(M, 3 * D, D, slots=slots),
            "out": clip_gemm_geometry(M, D, D, slots=slots, bns=_BNS),
            "dctx": clip_gemm_geometry(M, D, D, slots=slots,
                                       bns=dctx_widths(D, H)),
            "dx": clip_gemm_geometry(M, D, 3 * D, slots=slots, bns=_BNS),
            "dWqkv": wgrad_geometry(3 * D, D, M, slots),
            "dWout": wgrad_geometry(D, D, M, slots)}


def _geo_ints(geo: dict, split: bool = False):
    return ([geo["bn"], geo["ctas"], geo["splits"], geo["ksplit"]] if split
            else [geo["bn"], geo["ctas"]])


def train_gemm_plain(name: str, a, w, *, bias=None, resid=None, rm=None,
                     H: int = 0, ranges=None):
    """One product of kernels 8 and 12 (``TRAIN_GEMMS``) in float32: v = A
    W^T with A = a (a^T where A is MN-major) and W = w (w^T where B is),
    then the epilogue: qkv v + bias; out, dx resid + v (+ bias); out_drop
    resid + (v + bias) * rm; dctx (v, delta [M, H]: per head, the sum over
    its columns of v rounded to a's type times resid); wgrad [len(ranges),
    M, N] the products over each range of the K rows.  Results in a's type
    but delta and wgrad's (float32)."""
    epi, a_mn, b_mn = TRAIN_GEMMS[name]
    A = (a.t() if a_mn else a).float()
    W = (w.t() if b_mn else w).float()
    if epi == "part":
        return torch.stack([A[:, k0:k1] @ W[:, k0:k1].t()
                            for k0, k1 in ranges])
    v = A @ W.t()
    if bias is not None:
        v = v + bias.float()
    if epi == "dctx":
        M, N = v.shape
        delta = (v.to(a.dtype).float() * resid.float()).reshape(
            M, H, N // H).sum(-1)
        return v.to(a.dtype), delta
    if epi == "add_drop":
        v = v * rm.float()
    if epi in ("add", "add_drop"):
        v = v + resid.float()
    return v.to(a.dtype)


def train_gemm_launch(name: str, a, w, *, bias=None, resid=None, H: int = 0,
                      rate: float = 0.0, seed: int = 0, bn: int = 0):
    """One product of kernels 8 and 12 alone on the card (``TRAIN_GEMMS``),
    at the geometry the kernels take (``bn`` forces a tile width): returns
    (output, geometry).  The output is ``train_gemm_plain``'s: bf16, dctx's
    (dctx, delta), or a weight gradient's float32 partials [ranges, M, N]
    (A = a^T, W = w^T)."""
    epi, a_mn, b_mn = TRAIN_GEMMS[name]
    M, K = (a.shape[1], a.shape[0]) if a_mn else a.shape
    N = w.shape[1] if b_mn else w.shape[0]
    dev = a.device
    slots = gemm_cluster_slots(dev)
    if name == "wgrad":
        geo = wgrad_geometry(M, N, K, slots)
        out = torch.empty(geo["splits"], M, N, dtype=torch.float32,
                          device=dev)
    else:
        bns = (dctx_widths(N, H) if name == "dctx" else
               (256, 192, 128) if name == "qkv" else _BNS)
        geo = clip_gemm_geometry(M, N, K, slots=slots, bn=bn, bns=bns)
        out = torch.empty(M, N, dtype=a.dtype, device=dev)
    delta = (torch.empty(M, H, dtype=torch.float32, device=dev)
             if name == "dctx" else None)
    lo, hi = _seed_args(rate, seed)
    launch("train_attention", "train_gemm", dev,
           [a.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else 0, out.data_ptr(),
            resid.data_ptr() if resid is not None else 0,
            delta.data_ptr() if delta is not None else 0],
           [M, N, K, EPILOGUES[epi], int(a_mn), int(b_mn), geo["bn"],
            geo["ctas"], geo.get("splits", 1), geo.get("ksplit", 0), H, lo,
            hi], [rate])
    return ((out, delta) if delta is not None else out), geo


def _heads(t, B, S, H):
    return t.reshape(B, S, H, -1).transpose(1, 2)


def _attention_core(x, kvalid, w, pm, H, S):
    M, D = x.shape
    B = M // S
    q, k, v = F.linear(x, w["in_w"], w["in_b"]).split(D, dim=-1)
    q, k, v = (_heads(t, B, S, H) for t in (q, k, v))
    scale = 1.0 / math.sqrt(D // H)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    bias = torch.where(kvalid.reshape(B, 1, 1, S) > 0.5, 0.0, NEG_INF)
    p = torch.softmax(logits + bias.to(logits.dtype), dim=-1)
    a = _mul(p, pm)
    ctx = torch.matmul(a, v).transpose(1, 2).reshape(M, D)
    return q, k, v, p, a, ctx, scale


def train_self_attention_plain(x: torch.Tensor, kvalid: torch.Tensor, p,
                               masks: Masks = None, *, H: int, S: int
                               ) -> torch.Tensor:
    """Plain PyTorch forward.  x [B*S, D]; kvalid [B*S] float key validity;
    p: ``ATTN_PARAM_ORDER`` tensors (in_w [3D, D], out_w [D, D]); masks:
    (pm [B, H, S, S], rm [B*S, D]) keep-masks scaled by 1 / keep, or None."""
    pm, rm = masks if masks is not None else (None, None)
    w = {k: p[k].to(x.dtype) for k in ATTN_PARAM_ORDER}
    ctx = _attention_core(x, kvalid, w, pm, H, S)[5]
    return x + _mul(F.linear(ctx, w["out_w"], w["out_b"]), rm)


def train_self_attention_bwd_plain(x: torch.Tensor, kvalid: torch.Tensor,
                                   dout: torch.Tensor, p,
                                   masks: Masks = None, *, H: int, S: int
                                   ) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
    """The hand-derived backward in tensor ops, the specification of the
    backward kernel: (dx, {parameter name: gradient})."""
    pm, rm = masks if masks is not None else (None, None)
    w = {k: p[k].to(x.dtype) for k in ATTN_PARAM_ORDER}
    dout = dout.to(x.dtype)
    M, D = x.shape
    B = M // S
    q, k, v, prob, a, ctx, scale = _attention_core(x, kvalid, w, pm, H, S)
    dattn = _mul(dout, rm)
    dctx = _heads(dattn @ w["out_w"], B, S, H)
    dv = torch.matmul(a.transpose(-1, -2), dctx)
    dp = _mul(torch.matmul(dctx, v.transpose(-1, -2)), pm)
    ds = prob * (dp - (dp * prob).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dqkv = torch.cat([t.transpose(1, 2).reshape(M, D) for t in (dq, dk, dv)],
                     dim=-1)
    grads = {"in_w": dqkv.t() @ x, "in_b": dqkv.sum(0),
             "out_w": dattn.t() @ ctx, "out_b": dattn.sum(0)}
    return dout + dqkv @ w["in_w"], grads


def _check_shape(name, x, kvalid, p, H, S):
    M, D = x.shape
    B = M // max(S, 1)
    Dh = D // max(H, 1)
    if (S < 1 or M != B * S or kvalid.shape != (M,) or D % 64 or D > 256
            or H < 1 or D % H or Dh not in (16, 32, 48, 64)
            or p["in_w"].shape != (3 * D, D) or p["out_w"].shape != (D, D)):
        raise ValueError(f"{name}: unsupported shape M={M} S={S} D={D} H={H}")
    return B


@register_kernel("train_self_attention")
def train_self_attention_fwd(x: torch.Tensor, kvalid: torch.Tensor, p, *,
                             H: int, S: int, rate: float = 0.0,
                             seed: int = 0, masks: Masks = None,
                             return_saved: bool = False):
    """The forward alone (no autograd graph): kernel 8's forward on CUDA
    tensors (bf16, or float32 through its float32 chain; kvalid float32), the
    plain version with ``masks`` on CPU tensors.  ``return_saved`` also returns
    what the backward kernel needs from the forward: (qkv, ctx, lse), None on
    the CPU."""
    if not x.is_cuda:
        out = train_self_attention_plain(x, kvalid, p, masks, H=H, S=S)
        return (out, None) if return_saved else out
    if masks is not None:
        raise ValueError("train_self_attention: the CUDA kernel draws its "
                         "own masks from (rate, seed)")
    B = _check_shape("train_self_attention", x, kvalid, p, H, S)
    M, D = x.shape
    lo, hi = _seed_args(rate, seed)
    dev = x.device
    if x.dtype == torch.float32:
        check_cuda_args("train_self_attention",
                        {"x": x, "kvalid": kvalid,
                         **{k: p[k] for k in ATTN_PARAM_ORDER}},
                        f32=("kvalid",))
        out, saved = train_self_attention_f32(x, kvalid, p, H=H, S=S,
                                              drop=(lo, hi, rate))
        train_self_attention_fwd.launches += 1
        return (out, saved) if return_saved else out
    geo = attention_gemm_geometry(M, D, H, gemm_cluster_slots(dev))
    qkv = torch.empty(M, 3 * D, dtype=x.dtype, device=dev)
    ctx = torch.empty(M, D, dtype=x.dtype, device=dev)
    lse = torch.empty(M, H, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    check_cuda_args("train_self_attention",
                    {"x": x, "kvalid": kvalid, "lse": lse,
                     **{k: p[k] for k in ATTN_PARAM_ORDER}},
                    f32=("kvalid", "lse"))
    ptrs = [x.data_ptr(), kvalid.data_ptr(),
            *[p[k].data_ptr() for k in ATTN_PARAM_ORDER], qkv.data_ptr(),
            ctx.data_ptr(), lse.data_ptr(), out.data_ptr()]
    launch("train_attention", "train_attention_forward", dev, ptrs,
           [B, S, D, H, lo, hi, *_geo_ints(geo["qkv"]),
            *_geo_ints(geo["out"])], [rate])
    train_self_attention_fwd.launches += 1
    return (out, (qkv, ctx, lse)) if return_saved else out


@register_kernel("train_self_attention_bwd")
def train_self_attention_bwd(x: torch.Tensor, kvalid: torch.Tensor,
                             dout: torch.Tensor, p, saved=None, *, H: int,
                             S: int, rate: float = 0.0, seed: int = 0,
                             masks: Masks = None
                             ) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
    """The backward: kernel 8's backward on CUDA tensors (bf16 or float32;
    ``saved`` = the forward's (qkv, ctx, lse); float32 parameter
    gradients), the plain backward on CPU tensors."""
    if not x.is_cuda:
        return train_self_attention_bwd_plain(x, kvalid, dout, p, masks,
                                              H=H, S=S)
    if masks is not None or saved is None:
        raise ValueError("train_self_attention_bwd: the CUDA kernel takes "
                         "the forward's saved tensors and draws its own "
                         "masks from (rate, seed)")
    B = _check_shape("train_self_attention_bwd", x, kvalid, p, H, S)
    M, D = x.shape
    qkv, ctx, lse = saved
    if (dout.shape != x.shape or qkv.shape != (M, 3 * D)
            or ctx.shape != (M, D) or lse.shape != (M, H)):
        raise ValueError("train_self_attention_bwd: saved tensors do not "
                         "match x")
    lo, hi = _seed_args(rate, seed)
    if x.dtype == torch.float32:
        check_cuda_args("train_self_attention_bwd",
                        {"x": x, "kvalid": kvalid, "dout": dout, "qkv": qkv,
                         "ctx": ctx, "lse": lse,
                         **{k: p[k] for k in ATTN_PARAM_ORDER}},
                        f32=("kvalid", "lse"))
        dx, grads = train_self_attention_f32_bwd(
            x, kvalid, dout, p, saved, H=H, S=S, drop=(lo, hi, rate))
        train_self_attention_bwd.launches += 1
        return dx, grads
    dev, bf, f32 = x.device, x.dtype, torch.float32
    split = split_rows(M)
    geo = attention_gemm_geometry(M, D, H, gemm_cluster_slots(dev))
    # the weight gradients' partials, then the column sums' (3 D a range)
    wpart = max(geo["dWqkv"]["splits"] * 3 * D * D,
                geo["dWout"]["splits"] * D * D, split * 3 * D)
    scratch = {"dattn": torch.empty(M, D, dtype=bf, device=dev),
               "dctx": torch.empty(M, D, dtype=bf, device=dev),
               "delta": torch.empty(M, H, dtype=f32, device=dev),
               "dqkv": torch.empty(M, 3 * D, dtype=bf, device=dev),
               "wpart": torch.empty(wpart, dtype=f32, device=dev)}
    dx = torch.empty_like(x)
    grads = {k: torch.empty(p[k].shape, dtype=f32, device=dev)
             for k in ATTN_PARAM_ORDER}
    check_cuda_args("train_self_attention_bwd",
                    {"x": x, "kvalid": kvalid, "dout": dout, "qkv": qkv,
                     "ctx": ctx, "lse": lse, "dx": dx, **scratch,
                     **{k: p[k] for k in ATTN_PARAM_ORDER},
                     **{"d" + k: g for k, g in grads.items()}},
                    f32=("kvalid", "lse", "delta", "wpart",
                         *["d" + k for k in ATTN_PARAM_ORDER]))
    ptrs = [x.data_ptr(), kvalid.data_ptr(), dout.data_ptr(),
            *[p[k].data_ptr() for k in ATTN_PARAM_ORDER], qkv.data_ptr(),
            ctx.data_ptr(), lse.data_ptr(),
            *[scratch[k].data_ptr()
              for k in ("dattn", "dctx", "delta", "dqkv", "wpart")],
            dx.data_ptr(), *[grads[k].data_ptr() for k in ATTN_PARAM_ORDER]]
    launch("train_attention", "train_attention_backward", dev, ptrs,
           [B, S, D, H, lo, hi, split, *_geo_ints(geo["dctx"]),
            *_geo_ints(geo["dx"]), *_geo_ints(geo["dWqkv"], True),
            *_geo_ints(geo["dWout"], True)], [rate])
    train_self_attention_bwd.launches += 1
    return dx, grads


def train_self_attention_masks(B: int, S: int, D: int, H: int, rate: float,
                               seed: int, device
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two keep-masks (scaled by 1 / keep, float32) that the CUDA
    kernels draw for ``seed``: (pm [B, H, S, S], rm [B*S, D])."""
    lo, hi = _seed_args(rate, seed)
    dev = torch.device(device)
    pm = torch.empty(B, H, S, S, dtype=torch.float32, device=dev)
    rm = torch.empty(B * S, D, dtype=torch.float32, device=dev)
    check_cuda_args("train_self_attention_masks", {"pm": pm, "rm": rm},
                    f32=("pm", "rm"))
    launch("train_attention", "train_attention_masks", dev,
           [pm.data_ptr(), rm.data_ptr()], [B, S, D, H, lo, hi], [rate])
    return pm, rm


class _TrainSelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kvalid, H, S, rate, seed, pm, rm, *params):
        ctx.H, ctx.S, ctx.rate, ctx.seed = H, S, rate, seed
        ctx.param_dtypes = [w.dtype for w in params]
        masks = None if pm is None else (pm, rm)
        if x.is_cuda:  # the kernels take x's type: cast the parameters once
            params = tuple(w.detach().to(x.dtype).contiguous()
                           for w in params)
        p = dict(zip(ATTN_PARAM_ORDER, params))
        out, saved = train_self_attention_fwd(
            x, kvalid, p, H=H, S=S, rate=rate, seed=seed, masks=masks,
            return_saved=True)
        ctx.n_saved = 0 if saved is None else len(saved)
        ctx.save_for_backward(x, kvalid, *params, *(saved or ()),
                              *(masks or ()))
        return out

    @staticmethod
    def backward(ctx, dout):
        x, kvalid, *rest = ctx.saved_tensors
        n = len(ATTN_PARAM_ORDER)
        p = dict(zip(ATTN_PARAM_ORDER, rest[:n]))
        saved = tuple(rest[n:n + ctx.n_saved]) or None
        masks = tuple(rest[n + ctx.n_saved:]) or None
        dx, grads = train_self_attention_bwd(
            x, kvalid, dout.contiguous(), p, saved, H=ctx.H, S=ctx.S,
            rate=ctx.rate, seed=ctx.seed, masks=masks)
        gparams = [grads[k].to(dt) for k, dt in zip(ATTN_PARAM_ORDER,
                                                    ctx.param_dtypes)]
        return (dx, None, None, None, None, None, None, None, *gparams)


def train_self_attention(x: torch.Tensor, kvalid: torch.Tensor, p, *,
                         H: int, S: int, rate: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         seed: Optional[int] = None) -> torch.Tensor:
    """Kernel 8, differentiable in x and the four parameters.  x [B*S, D]
    (bf16 or float32 on CUDA); kvalid [B*S] float32; p: ``ATTN_PARAM_ORDER``
    tensors in any float type (cast to x's type on the way in; their gradients
    come back in their own type).  With ``rate > 0`` one 64-bit seed is drawn
    from ``generator`` per call (or taken from ``seed``); on CPU tensors the
    masks come from ``generator`` directly."""
    params = [p[k] for k in ATTN_PARAM_ORDER]
    pm = rm = None
    if x.is_cuda:
        if rate > 0.0 and seed is None:
            seed = draw_seed(generator)
    elif rate > 0.0:
        M, D = x.shape
        pm = dropout_mask((M // S, H, S, S), rate, x, generator)
        rm = dropout_mask((M, D), rate, x, generator)
    return _TrainSelfAttention.apply(x, kvalid, H, S, float(rate), seed or 0,
                                     pm, rm, *params)
