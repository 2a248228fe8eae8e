"""Kernel 13: one whole post-norm transformer decoder layer in training,
forward and backward.  Replaces
``ladiff_tpu/ops/pallas_train_decoder_layer.py`` ``train_decoder_layer``
(:410; ``pl.pallas_call`` forward :464, backward :521).

    r1  = x + (selfattn(x) Wso^T + bso) * rm1      # probabilities * pm1
    t1  = LN1(r1)
    cc  = (softmax(q k^T / sqrt(Dh) + memory bias) * pm2) v
          q = t1 Wq^T + bq;  k, v = mem Wk^T + bk, mem Wv^T + bv
    r2  = t1 + (cc Wco^T + bco) * rm2
    h   = LN2(r2)
    out = LN3(h + (act(h W1^T + b1) * m1 W2^T + b2) * m2)

and its VJP in x, the memory [B, L, D] and the eighteen parameters
(``DEC_PARAM_ORDER``, the names ``TransformerDecoderLayer.kernel_params``
gives).  ``train_decoder_layer`` is a ``torch.autograd.Function``: on CUDA
tensors forward and backward are the hand-written kernels of
``csrc/train_decoder_layer.cu``, on CPU tensors ``train_decoder_layer_plain``
and ``train_decoder_layer_bwd_plain``.

Design on Hopper.  What bounds it on the H100: ~25 GFLOP forward and ~49
GFLOP backward at 64 x 196 rows against tens of MB of activations and
1.4 MB of weights: the tensor cores, and the weight bytes each row block
streams from L2.  So every projection and tail runs on the 64-row blocks
of ``csrc/tail64.cuh`` (16 warps, ``mma.sync`` bf16 with f32 register
accumulators, the weights through a three-stage ``cp.async`` ring: each
byte of weight serves 64 rows), with the residuals and LayerNorms in the
accumulator registers.  The forward's projections are ``linear64_kernel``
(the memory's k, v once per sample); the tail from the self-attention
context to the layer's output is ``csrc/dec_tail64.cuh``'s body, which K2
runs too: out-projection and residual dropout, LN1, the cross-attention
(one warp per row and head: the L <= 8 memory rows' scores in the warp's
lane quads, softmax by shuffles), its out-projection and residual dropout,
LN2, the FFN in 128-column hidden chunks, LN3.  The backward's tail is two
launches per 64-row block: the forward body again (keeping r1, r2, t1, q,
cc, h), the FFN segment's backward (``tail64.cuh``'s ``ffn_ln_bwd``, kernel
12's) and LN2's, down to dr2; then the cross-attention out-projection's
backward, the cross-attention's (dq in the block; each memory row's dk, dv
summed over the block's rows of each of the at most ``kv_slots(S)``
samples it holds), the q projection's, LN1's and the self-attention
out-projection's.  The memory gradient is then summed per sample over
those blocks in block order by one reduction launch, without atomics, so
two runs give equal bits, and taken through Wk, Wv (``linear64_kernel``,
as is dx = dr1 + dqkv Wqkv).  Kernel 8's launches do the tiled
self-attention forward and backward (``csrc/train_attn.cuh``), and the
weight gradients sum over row splits (``csrc/train_common.cuh``).  The
wrapper is that fixed sequence, counted once each way.

Dropout: Philox keyed by (seed, mask id, element) as in ``ops/train_ffn.py``.
Masks 0 (self-attention probabilities, element ((b H + h) T + i) T + j), 1
(its residual, row D + c), 2 (cross-attention probabilities, element
((b H + h) T + i) L + j), 3 (its residual), 4 (FFN hidden, row F + c), 5
(FFN output); ``train_decoder_layer_masks`` writes all six out.

What is saved for the backward: the inputs, the parameters in x's type, the
seed, and qkv, ctx, the log-sum-exp and the memory's projected k, v.

In float32 (the published configurations' type) the wrappers run kernel
13's float32 design instead (``ops/f32_train.py`` on
``csrc/f32_train_layer.cu``): every product on the tensor cores in
three-term TF32 (the cross-attention over the L <= 8 memory rows on a
small SIMT path), LN1, LN2 and LN3 in the epilogues of the out-projections
and W2, eight launches forward; the forward also saves r1, t1, q, cc, the
cross log-sum-exp, r2, h, the pre-activation, the hidden rows and the
pre-LN3 sum, so the backward (twelve launches, the memory gradient from
each sample's memory rows summed in warp order, no atomics) recomputes no
product; under the same shape gate.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import (NEG_INF, check_cuda_args,
                                          draw_seed, dropout_mask, launch,
                                          register_kernel)
from ladiff_torch.ops.decoder_layer import MAX_MEMORY
from ladiff_torch.ops.f32_train import (train_decoder_layer_f32,
                                        train_decoder_layer_f32_bwd)
from ladiff_torch.ops.postnorm_ffn import ACTIVATIONS
from ladiff_torch.ops.train_attention import (_heads,
                                              train_self_attention_bwd_plain,
                                              train_self_attention_plain)
from ladiff_torch.ops.train_ffn import (_ln_fwd, _mul, _seed_args, ln_bwd,
                                        split_rows,
                                        train_postnorm_ffn_bwd_plain,
                                        train_postnorm_ffn_plain)
from ladiff_torch.ops.train_layer import train_encoder_layer_supported

__all__ = ["train_decoder_layer", "train_decoder_layer_fwd",
           "train_decoder_layer_bwd", "train_decoder_layer_plain",
           "train_decoder_layer_bwd_plain", "train_decoder_layer_masks",
           "train_decoder_layer_supported", "kv_slots", "DEC_PARAM_ORDER",
           "MAX_MEMORY"]

DEC_PARAM_ORDER = ("sa_in_w", "sa_in_b", "sa_out_w", "sa_out_b", "ln1_w",
                   "ln1_b", "ca_in_w", "ca_in_b", "ca_out_w", "ca_out_b",
                   "ln2_w", "ln2_b", "w1", "b1", "w2", "b2", "ln3_w",
                   "ln3_b")
ROWS = 64  # rows of the backward's tail blocks
Masks = Optional[Tuple[torch.Tensor, ...]]


def kv_slots(S: int) -> int:
    """The most samples of S frames whose rows one 64-row block holds, 1 +
    ceil(63 / S): the backward's partial sums of the memory gradient per
    block (3 for 32 <= S < 63, 2 from 63 on)."""
    return 1 + -(-(ROWS - 1) // S)


def train_decoder_layer_supported(S: int, L: int, D: int, H: int, F: int,
                                  activation: str) -> bool:
    """Whether kernel 13 takes the layer: kernel 12's shapes over S frames
    (at least 32: a row block holds rows of at most ``kv_slots(S)``
    samples) and 1 to ``MAX_MEMORY`` memory rows per sample (the JAX
    package's gate takes up to 128)."""
    return (train_encoder_layer_supported(S, D, H, F, activation)
            and 1 <= L <= MAX_MEMORY)


def _parts(p, masks):
    sa = {"in_w": p["sa_in_w"], "in_b": p["sa_in_b"],
          "out_w": p["sa_out_w"], "out_b": p["sa_out_b"]}
    ffn = {"ln1_w": p["ln2_w"], "ln1_b": p["ln2_b"], "w1": p["w1"],
           "b1": p["b1"], "w2": p["w2"], "b2": p["b2"], "ln2_w": p["ln3_w"],
           "ln2_b": p["ln3_b"]}
    pm1, rm1, pm2, rm2, m1, m2 = masks if masks is not None else (None,) * 6
    return sa, ffn, (pm1, rm1), (pm2, rm2), (m1, m2)


def _cross(t1, mem, mvalid, w, pm2, H):
    """The cross-attention's pieces: q [M, D]; heads q, k, v; the
    probabilities p and a = p * pm2 [B, H, T, L]; the context cc [M, D]."""
    M, D = t1.shape
    B, L, _ = mem.shape
    T = M // B
    cw, cb = w["ca_in_w"], w["ca_in_b"]
    q = F.linear(t1, cw[:D], cb[:D])
    k = F.linear(mem, cw[D:2 * D], cb[D:2 * D])
    v = F.linear(mem, cw[2 * D:], cb[2 * D:])
    qh, kh, vh = _heads(q, B, T, H), _heads(k, B, L, H), _heads(v, B, L, H)
    scale = 1.0 / math.sqrt(D // H)
    bias = torch.where(mvalid.reshape(B, 1, 1, L) > 0.5, 0.0, NEG_INF)
    prob = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale
                         + bias.to(q.dtype), dim=-1)
    a = _mul(prob, pm2)
    cc = torch.matmul(a, vh).transpose(1, 2).reshape(M, D)
    return q, qh, kh, vh, prob, a, cc, scale


def _forward_parts(x, kvalid, mem, mvalid, w, masks, H, S):
    sa, ffn, sam, (pm2, rm2), fm = _parts(w, masks)
    D = x.shape[1]
    r1 = train_self_attention_plain(x, kvalid, sa, sam, H=H, S=S)
    t1 = F.layer_norm(r1, (D,), w["ln1_w"], w["ln1_b"], 1e-5)
    cross = _cross(t1, mem, mvalid, w, pm2, H)
    r2 = t1 + _mul(F.linear(cross[6], w["ca_out_w"], w["ca_out_b"]), rm2)
    return sa, ffn, sam, rm2, fm, r1, t1, cross, r2


def train_decoder_layer_plain(x: torch.Tensor, kvalid: torch.Tensor,
                              mem: torch.Tensor, mvalid: torch.Tensor, p,
                              masks: Masks = None, *, H: int, S: int,
                              activation: str = "gelu") -> torch.Tensor:
    """Plain PyTorch forward.  x [B*S, D] frame rows; kvalid [B*S] float;
    mem [B, L, D]; mvalid [B, L] float; p: ``DEC_PARAM_ORDER`` tensors
    (torch layouts); masks: (pm1 [B, H, S, S], rm1 [B*S, D], pm2
    [B, H, S, L], rm2 [B*S, D], m1 [B*S, F], m2 [B*S, D]) keep-masks scaled
    by 1 / keep, or None at rate 0."""
    w = {k: p[k].to(x.dtype) for k in DEC_PARAM_ORDER}
    _, ffn, _, _, fm, _, _, _, r2 = _forward_parts(
        x, kvalid, mem.to(x.dtype), mvalid, w, masks, H, S)
    return train_postnorm_ffn_plain(r2, ffn, fm, activation=activation)


def train_decoder_layer_bwd_plain(x: torch.Tensor, kvalid: torch.Tensor,
                                  mem: torch.Tensor, mvalid: torch.Tensor,
                                  dout: torch.Tensor, p, masks: Masks = None,
                                  *, H: int, S: int,
                                  activation: str = "gelu"
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             Dict[str, torch.Tensor]]:
    """The hand-derived backward in tensor ops, the specification of the
    backward kernels: (dx, dmem, {parameter name: gradient})."""
    w = {k: p[k].to(x.dtype) for k in DEC_PARAM_ORDER}
    mem, dout = mem.to(x.dtype), dout.to(x.dtype)
    sa, ffn, sam, rm2, fm, r1, t1, cross, r2 = _forward_parts(
        x, kvalid, mem, mvalid, w, masks, H, S)
    _, qh, kh, vh, prob, a, cc, scale = cross
    pm2 = masks[2] if masks is not None else None
    M, D = x.shape
    B, L, _ = mem.shape

    dr2, g_ffn = train_postnorm_ffn_bwd_plain(r2, dout, ffn, fm,
                                              activation=activation)
    dco = _mul(dr2, rm2)
    dcc = _heads(dco @ w["ca_out_w"], B, S, H)
    dvh = torch.matmul(a.transpose(-1, -2), dcc)
    dp = _mul(torch.matmul(dcc, vh.transpose(-1, -2)), pm2)
    ds = prob * (dp - (dp * prob).sum(-1, keepdim=True))
    dq = (torch.matmul(ds, kh) * scale).transpose(1, 2).reshape(M, D)
    dkh = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dk, dv = (t.transpose(1, 2).reshape(B * L, D) for t in (dkh, dvh))
    mrows = mem.reshape(B * L, D)
    cw = w["ca_in_w"]
    dmem = (dk @ cw[D:2 * D] + dv @ cw[2 * D:]).reshape(B, L, D)
    dt1 = dr2 + dq @ cw[:D]
    _, xhat1, inv1 = _ln_fwd(r1, w["ln1_w"], w["ln1_b"])
    dr1, g_ln1w, g_ln1b = ln_bwd(dt1, xhat1, inv1, w["ln1_w"])
    dx, g_sa = train_self_attention_bwd_plain(x, kvalid, dr1, sa, sam, H=H,
                                              S=S)
    grads = {"sa_in_w": g_sa["in_w"], "sa_in_b": g_sa["in_b"],
             "sa_out_w": g_sa["out_w"], "sa_out_b": g_sa["out_b"],
             "ln1_w": g_ln1w, "ln1_b": g_ln1b,
             "ca_in_w": torch.cat([dq.t() @ t1, dk.t() @ mrows,
                                   dv.t() @ mrows]),
             "ca_in_b": torch.cat([dq.sum(0), dk.sum(0), dv.sum(0)]),
             "ca_out_w": dco.t() @ cc, "ca_out_b": dco.sum(0),
             "ln2_w": g_ffn["ln1_w"], "ln2_b": g_ffn["ln1_b"],
             "w1": g_ffn["w1"], "b1": g_ffn["b1"], "w2": g_ffn["w2"],
             "b2": g_ffn["b2"], "ln3_w": g_ffn["ln2_w"],
             "ln3_b": g_ffn["ln2_b"]}
    return dx, dmem, grads


def _check_shape(name, x, kvalid, mem, mvalid, p, H, S, activation):
    M, D = x.shape
    B = M // max(S, 1)
    L = mem.shape[1] if mem.dim() == 3 else 0
    Fd = p["w1"].shape[0]
    if (M != B * S or kvalid.shape != (M,) or mem.shape != (B, L, D)
            or mvalid.shape != (B, L)
            or not train_decoder_layer_supported(S, L, D, H, Fd, activation)
            or p["sa_in_w"].shape != (3 * D, D)
            or p["ca_in_w"].shape != (3 * D, D)
            or p["w1"].shape != (Fd, D) or p["w2"].shape != (D, Fd)):
        raise ValueError(f"{name}: unsupported shape M={M} S={S} L={L} D={D}"
                         f" H={H} F={Fd} activation={activation}")
    return B, L, Fd


@register_kernel("train_decoder_layer")
def train_decoder_layer_fwd(x: torch.Tensor, kvalid: torch.Tensor,
                            mem: torch.Tensor, mvalid: torch.Tensor, p, *,
                            H: int, S: int, activation: str = "gelu",
                            rate: float = 0.0, seed: int = 0,
                            masks: Masks = None, return_saved: bool = False):
    """The forward alone (no autograd graph): kernel 13's forward on CUDA
    tensors (bf16, or float32 through its float32 chain; kvalid, mvalid
    float32), the plain version with
    ``masks`` on CPU tensors.  ``return_saved`` also returns (qkv, ctx, lse,
    memkv), in float32 followed by (r1, t1, q, cc, the cross log-sum-exp,
    r2, h, a, gd, s), None on the CPU."""
    if not x.is_cuda:
        out = train_decoder_layer_plain(x, kvalid, mem, mvalid, p, masks,
                                        H=H, S=S, activation=activation)
        return (out, None) if return_saved else out
    if masks is not None:
        raise ValueError("train_decoder_layer: the CUDA kernel draws its own "
                         "masks from (rate, seed)")
    B, L, Fd = _check_shape("train_decoder_layer", x, kvalid, mem, mvalid, p,
                            H, S, activation)
    M, D = x.shape
    lo, hi = _seed_args(rate, seed)
    dev, bf = x.device, x.dtype
    if bf == torch.float32:
        check_cuda_args("train_decoder_layer",
                        {"x": x, "kvalid": kvalid, "mem": mem,
                         "mvalid": mvalid,
                         **{k: p[k] for k in DEC_PARAM_ORDER}},
                        f32=("kvalid", "mvalid"))
        out, saved = train_decoder_layer_f32(
            x, kvalid, mem, mvalid, p, H=H, S=S, activation=activation,
            drop=(lo, hi, rate))
        train_decoder_layer_fwd.launches += 1
        return (out, saved) if return_saved else out
    qkv = torch.empty(M, 3 * D, dtype=bf, device=dev)
    ctx = torch.empty(M, D, dtype=bf, device=dev)
    lse = torch.empty(M, H, dtype=torch.float32, device=dev)
    memkv = torch.empty(B * L, 2 * D, dtype=bf, device=dev)
    out = torch.empty_like(x)
    check_cuda_args("train_decoder_layer",
                    {"x": x, "kvalid": kvalid, "mem": mem, "mvalid": mvalid,
                     "lse": lse, **{k: p[k] for k in DEC_PARAM_ORDER}},
                    f32=("kvalid", "mvalid", "lse"))
    ptrs = [x.data_ptr(), kvalid.data_ptr(), mem.data_ptr(),
            mvalid.data_ptr(), *[p[k].data_ptr() for k in DEC_PARAM_ORDER],
            qkv.data_ptr(), ctx.data_ptr(), lse.data_ptr(), memkv.data_ptr(),
            out.data_ptr()]
    launch("train_decoder_layer", "train_decoder_layer_forward", dev, ptrs,
           [B, S, L, D, H, Fd, ACTIVATIONS[activation], lo, hi], [rate])
    train_decoder_layer_fwd.launches += 1
    return (out, (qkv, ctx, lse, memkv)) if return_saved else out


@register_kernel("train_decoder_layer_bwd")
def train_decoder_layer_bwd(x: torch.Tensor, kvalid: torch.Tensor,
                            mem: torch.Tensor, mvalid: torch.Tensor,
                            dout: torch.Tensor, p, saved=None, *, H: int,
                            S: int, activation: str = "gelu",
                            rate: float = 0.0, seed: int = 0,
                            masks: Masks = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       Dict[str, torch.Tensor]]:
    """The backward: kernel 13's backward on CUDA tensors (bf16 or float32;
    ``saved`` = the forward's saved tensors; float32 parameter gradients),
    the plain backward on CPU tensors.  Returns (dx, dmem, grads)."""
    if not x.is_cuda:
        return train_decoder_layer_bwd_plain(x, kvalid, mem, mvalid, dout,
                                             p, masks, H=H, S=S,
                                             activation=activation)
    if masks is not None or saved is None:
        raise ValueError("train_decoder_layer_bwd: the CUDA kernel takes the "
                         "forward's saved tensors and draws its own masks "
                         "from (rate, seed)")
    B, L, Fd = _check_shape("train_decoder_layer_bwd", x, kvalid, mem,
                            mvalid, p, H, S, activation)
    M, D = x.shape
    qkv, ctx, lse, memkv = saved[:4]
    f32_saved = (() if x.dtype != torch.float32 else
                 ((M, D), (M, D), (M, D), (M, D), (M, H), (M, D), (M, D),
                  (M, Fd), (M, Fd), (M, D)))
    if (dout.shape != x.shape or qkv.shape != (M, 3 * D)
            or ctx.shape != (M, D) or lse.shape != (M, H)
            or memkv.shape != (B * L, 2 * D)
            or [tuple(t.shape) for t in saved[4:]] != list(f32_saved)):
        raise ValueError("train_decoder_layer_bwd: saved tensors do not "
                         "match x")
    lo, hi = _seed_args(rate, seed)
    if x.dtype == torch.float32:
        check_cuda_args("train_decoder_layer_bwd",
                        {"x": x, "kvalid": kvalid, "mem": mem,
                         "mvalid": mvalid, "dout": dout,
                         **{f"saved{i}": t for i, t in enumerate(saved)},
                         **{k: p[k] for k in DEC_PARAM_ORDER}},
                        f32=("kvalid", "mvalid", "saved2", "saved8"))
        dx, dmem, grads = train_decoder_layer_f32_bwd(
            x, kvalid, mem, mvalid, dout, p, saved, H=H, S=S,
            activation=activation, drop=(lo, hi, rate))
        train_decoder_layer_bwd.launches += 1
        return dx, dmem, grads
    dev, bf, f32 = x.device, x.dtype, torch.float32
    split, split_mem = split_rows(M), split_rows(B * L)
    nblk, slots = -(-M // ROWS), kv_slots(S)

    def rows(n, dt=bf, m=M):
        return torch.empty(m, n, dtype=dt, device=dev)

    scratch = {"r1": rows(D, f32), "r2": rows(D, f32), "t1": rows(D),
               "q": rows(D), "cc": rows(D), "h": rows(D), "gd": rows(Fd),
               "da": rows(Fd), "dy": rows(D), "dco": rows(D), "dq": rows(D),
               "dr": rows(D), "dattn": rows(D), "dctx": rows(D),
               "delta": rows(H, f32), "dqkv": rows(3 * D),
               "kvpart": rows(L * 2 * D, f32, slots * nblk),
               "dkv": rows(2 * D, bf, B * L),
               "lnpart": rows(6 * D, f32, nblk),
               "wpart": rows(max(3 * D * D, Fd * D), f32,
                             max(split, split_mem))}
    dx = torch.empty_like(x)
    dmem = torch.empty(B, L, D, dtype=bf, device=dev)
    grads = {k: torch.empty(p[k].shape, dtype=f32, device=dev)
             for k in DEC_PARAM_ORDER}
    check_cuda_args("train_decoder_layer_bwd",
                    {"x": x, "kvalid": kvalid, "mem": mem, "mvalid": mvalid,
                     "dout": dout, "qkv": qkv, "ctx": ctx, "lse": lse,
                     "memkv": memkv, "dx": dx, "dmem": dmem, **scratch,
                     **{k: p[k] for k in DEC_PARAM_ORDER},
                     **{"d" + k: g for k, g in grads.items()}},
                    f32=("kvalid", "mvalid", "lse", "r1", "r2", "delta",
                         "kvpart", "lnpart", "wpart",
                         *["d" + k for k in DEC_PARAM_ORDER]))
    ptrs = [x.data_ptr(), kvalid.data_ptr(), mem.data_ptr(),
            mvalid.data_ptr(), dout.data_ptr(),
            *[p[k].data_ptr() for k in DEC_PARAM_ORDER], qkv.data_ptr(),
            ctx.data_ptr(), lse.data_ptr(), memkv.data_ptr(),
            *[t.data_ptr() for t in scratch.values()], dx.data_ptr(),
            dmem.data_ptr(), *[grads[k].data_ptr() for k in DEC_PARAM_ORDER]]
    launch("train_decoder_layer", "train_decoder_layer_backward", dev, ptrs,
           [B, S, L, D, H, Fd, ACTIVATIONS[activation], lo, hi, split,
            split_mem, slots], [rate])
    train_decoder_layer_bwd.launches += 1
    return dx, dmem, grads


def train_decoder_layer_masks(B: int, S: int, L: int, D: int, H: int,
                              Fd: int, rate: float, seed: int, device
                              ) -> Tuple[torch.Tensor, ...]:
    """The six keep-masks (scaled by 1 / keep, float32) that the CUDA
    kernels draw for ``seed``, in the plain version's order."""
    lo, hi = _seed_args(rate, seed)
    dev = torch.device(device)
    M = B * S
    masks = tuple(torch.empty(*shape, dtype=torch.float32, device=dev)
                  for shape in ((B, H, S, S), (M, D), (B, H, S, L), (M, D),
                                (M, Fd), (M, D)))
    check_cuda_args("train_decoder_layer_masks",
                    {f"m{i}": m for i, m in enumerate(masks)},
                    f32=tuple(f"m{i}" for i in range(6)))
    launch("train_decoder_layer", "train_decoder_layer_masks", dev,
           [m.data_ptr() for m in masks], [B, S, L, D, H, Fd, lo, hi],
           [rate])
    return masks


class _TrainDecoderLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kvalid, mem, mvalid, H, S, activation, rate, seed,
                masks, *params):
        ctx.H, ctx.S, ctx.rate, ctx.seed = H, S, rate, seed
        ctx.activation = activation
        ctx.param_dtypes = [w.dtype for w in params]
        ctx.mem_dtype = mem.dtype
        if x.is_cuda:  # the kernels take x's type: cast once
            params = tuple(w.detach().to(x.dtype).contiguous()
                           for w in params)
            mem = mem.detach().to(x.dtype).contiguous()
        p = dict(zip(DEC_PARAM_ORDER, params))
        out, saved = train_decoder_layer_fwd(
            x, kvalid, mem, mvalid, p, H=H, S=S, activation=activation,
            rate=rate, seed=seed, masks=masks, return_saved=True)
        ctx.n_saved = 0 if saved is None else len(saved)
        ctx.save_for_backward(x, kvalid, mem, mvalid, *params,
                              *(saved or ()), *(masks or ()))
        return out

    @staticmethod
    def backward(ctx, dout):
        x, kvalid, mem, mvalid, *rest = ctx.saved_tensors
        n = len(DEC_PARAM_ORDER)
        p = dict(zip(DEC_PARAM_ORDER, rest[:n]))
        saved = tuple(rest[n:n + ctx.n_saved]) or None
        masks = tuple(rest[n + ctx.n_saved:]) or None
        dx, dmem, grads = train_decoder_layer_bwd(
            x, kvalid, mem, mvalid, dout.contiguous(), p, saved, H=ctx.H,
            S=ctx.S, activation=ctx.activation, rate=ctx.rate, seed=ctx.seed,
            masks=masks)
        gparams = [grads[k].to(dt) for k, dt in zip(DEC_PARAM_ORDER,
                                                    ctx.param_dtypes)]
        return (dx, None, dmem.to(ctx.mem_dtype), None, None, None, None,
                None, None, None, *gparams)


def train_decoder_layer(x: torch.Tensor, kvalid: torch.Tensor,
                        mem: torch.Tensor, mvalid: torch.Tensor, p, *,
                        H: int, S: int, activation: str = "gelu",
                        rate: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        seed: Optional[int] = None) -> torch.Tensor:
    """Kernel 13, differentiable in x, the memory and the eighteen
    parameters.  x [B*S, D] (bf16 or float32 on CUDA); kvalid [B*S] float32;
    mem [B, L, D] in any float type; mvalid [B, L] float32; p:
    ``DEC_PARAM_ORDER`` tensors in any float type (cast to x's type on the way
    in; gradients come back in their own types).  With ``rate > 0`` one 64-bit
    seed is drawn from ``generator`` per call (or taken from ``seed``); on CPU
    tensors the six masks come from ``generator``."""
    params = [p[k] for k in DEC_PARAM_ORDER]
    masks = None
    if x.is_cuda:
        if rate > 0.0 and seed is None:
            seed = draw_seed(generator)
    elif rate > 0.0:
        M, D = x.shape
        B, L = M // S, mem.shape[1]
        masks = tuple(dropout_mask(shape, rate, x, generator) for shape in (
            (B, H, S, S), (M, D), (B, H, S, L), (M, D),
            (M, p["w1"].shape[0]), (M, D)))
    return _TrainDecoderLayer.apply(x, kvalid, mem, mvalid, H, S, activation,
                                    float(rate), seed or 0, masks, *params)
