"""The float32 routes of the training kernels 8, 9, 12 and 13 on the card,
forward and backward: each a chain of the hand-written kernels of
``csrc/f32_train.cu`` (on the float32 tiles of ``csrc/f32_tile.cuh``, which
the inference chains of ``ops/f32_layer.py`` share), launched by the
wrappers ``train_self_attention_fwd`` / ``_bwd``,
``train_postnorm_ffn_fwd`` / ``_bwd``, ``train_encoder_layer_fwd`` /
``_bwd`` and ``train_decoder_layer_fwd`` / ``_bwd`` when their inputs are
float32.  The published configurations train in float32
(``TRAIN.MIXED_PRECISION: false``), as the JAX package's Pallas kernels do
there: they take the module's type and accumulate in float32.

Launches a call (one launch count on the wrapper):

  kernel 8   qkv, attention (probability dropout, log-sum-exp), out-proj
             with the residual dropout                                   3
             backward: dattn = dout * rm, dctx = dattn Wout, delta, the
             attention's query side (dq) and key side (dk, dv), dx = dout
             + dqkv Wqkv, dWqkv / dbqkv and dWout / dbout (a split-K
             product and its reduction each)                           10
  kernel 9   LN1, W1 + act + dropout, W2 + dropout + residual, LN2        4
             backward: LN1, W1 (keeping the pre-activation), W2 (the
             forward recomputed), LN2's backward (ds, dy = ds * m2), da =
             (dy W2) m1 act'(a), dh = ds + da W1, LN1's backward, dW1 /
             db1, dW2 / db2, the LayerNorms' reduction                  12
  kernel 12  kernel 8's forward then kernel 9's                          7
             backward: the residual r recomputed from ctx, kernel 9's
             backward, kernel 8's                                       23
  kernel 13  kernel 8's forward, LN1, the cross q, the memory's k / v,
             the cross-attention, its out-proj with the residual dropout,
             kernel 9's forward                                         12
             backward: r1, t1, q, the cross-attention and r2 recomputed,
             kernel 9's backward, dco = dr2 * rm2, dcc, delta, the cross-
             attention's two sides (dq; the memory rows' dk, dv), dmem =
             [dk dv] Wkv, dt1 = dr2 + dq Wq, LN1's backward, three weight
             gradients, LN1's reduction, kernel 8's backward             42

Dropout: the bf16 kernels' Philox-4x32-10 keyed by (seed, mask id,
element) (``csrc/common.cuh`` ``keep_scale``), so a seed draws the same
masks in both types and ``train_*_masks`` write them out for either.  The
chains of kernels 12 and 13 call kernel 8's and 9's pieces with their own
mask ids: 8 uses 0 (probabilities) and 1 (residual), 9 uses 0 (hidden) and
1 (output), 12 uses 0 to 3, 13 uses 0 to 5 (self-attention, cross-
attention, FFN).

Numerics are the plain versions': float32 operands and accumulators,
LayerNorm eps 1e-5, exact erf GELU, a masked key's logit -1e9 (a sample
without a valid key attends uniformly, forward and backward), no TF32 and
no bf16 anywhere.  Gradients are deterministic: every sum across blocks
(the weight and bias gradients, the LayerNorms' parameters) goes through
float32 partials summed in a fixed order, and the attention backward's
query and key sides write disjoint rows.  What is saved: as the bf16
route, qkv, ctx and the log-sum-exp (and kernel 13's memory k / v), here
in float32; everything else is recomputed.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ladiff_torch.ops.cuda_common import launch

__all__ = ["train_self_attention_f32", "train_self_attention_f32_bwd",
           "train_postnorm_ffn_f32", "train_postnorm_ffn_f32_bwd",
           "train_encoder_layer_f32", "train_encoder_layer_f32_bwd",
           "train_decoder_layer_f32", "train_decoder_layer_f32_bwd",
           "gemm_f32", "wgrad_f32", "wgrad_split", "ln_rows",
           "CHAIN_LAUNCHES"]

LIB = "f32_train"
ACT = {None: 0, "relu": 1, "gelu": 2}
# kernel launches of one wrapper call on the float32 route
CHAIN_LAUNCHES = {"train_self_attention": 3, "train_self_attention_bwd": 10,
                  "train_postnorm_ffn": 4, "train_postnorm_ffn_bwd": 12,
                  "train_encoder_layer": 7, "train_encoder_layer_bwd": 23,
                  "train_decoder_layer": 12, "train_decoder_layer_bwd": 42}
# (seed lo, seed hi, rate) of a call; rate 0 draws no mask
Drop = Tuple[int, int, float]
NO_DROP: Drop = (0, 0, 0.0)
_TILE = 64          # the GEMM's output tile
_FILL = 264         # blocks a split-K product aims at: two per SM
_LN_BLOCKS = 256    # blocks a LayerNorm backward aims at


def _ld(t: Optional[torch.Tensor]) -> int:
    """The row stride of a 2-D float32 view whose rows are contiguous (0
    for None)."""
    if t is None:
        return 0
    if t.dim() != 2 or t.stride(1) != 1 or t.dtype != torch.float32:
        raise ValueError(f"f32_train: a float32 2-D view with contiguous "
                         f"rows, got {tuple(t.shape)} strides {t.stride()} "
                         f"{t.dtype}")
    return t.stride(0)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _rows(*shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(*shape, dtype=torch.float32, device=like.device)


def gemm_f32(a: torch.Tensor, b: torch.Tensor, *, a_mn: bool = False,
             b_mn: bool = False, bias=None, act: Optional[str] = None,
             pre=None, gin=None, gact: Optional[str] = None, resid=None,
             drop: Drop = NO_DROP, mask_id: int = 0) -> torch.Tensor:
    """One launch: ``C = epi(A B^T)`` with A = a ([M, K]; a^T where
    ``a_mn``) and B = b ([N, K], a torch weight; b^T where ``b_mn``: dx =
    dY W).  The epilogue: ``v = act(v + bias)`` (v + bias written to
    ``pre`` first), times ``act'(gin)``, times the keep-scale of mask
    ``mask_id`` at element m N + n, plus ``resid``."""
    M, K = (a.shape[1], a.shape[0]) if a_mn else a.shape
    N, Kb = (b.shape[1], b.shape[0]) if b_mn else b.shape
    if Kb != K:
        raise ValueError(f"gemm_f32: {tuple(a.shape)} against "
                         f"{tuple(b.shape)}")
    out = _rows(M, N, like=a)
    lo, hi, rate = drop
    launch(LIB, "f32t_gemm", a.device,
           [_ptr(a), _ptr(b), _ptr(out), _ptr(bias), _ptr(pre), _ptr(gin),
            _ptr(resid), 0],
           [M, N, K, _ld(a), _ld(b), N, int(a_mn), int(b_mn), ACT[act],
            _ld(pre), _ld(gin), ACT[gact], _ld(resid), mask_id, lo, hi, K,
            0, 0], [rate])
    return out


def wgrad_split(N1: int, N2: int, K: int) -> Tuple[int, int]:
    """(splits, rows a split) of a weight gradient [N1, N2] over K rows:
    the 64 x 64 output tiles times the splits aim at two blocks an SM."""
    tiles = -(-N1 // _TILE) * -(-N2 // _TILE)
    splits = max(1, min(-(-_FILL // tiles), -(-K // 64)))
    ksplit = -(-(-(-K // splits)) // 16) * 16
    return -(-K // ksplit), ksplit


def wgrad_f32(dy: torch.Tensor, x: torch.Tensor, gw: torch.Tensor,
              gb: torch.Tensor) -> None:
    """``gw = dy^T x`` and ``gb = dy.sum(0)`` (contiguous outputs, views
    allowed): a split-K launch writing float32 partials and the column
    sums of dy, then a reduction in split order.  Two launches."""
    K, N1 = dy.shape
    N2 = x.shape[1]
    splits, ksplit = wgrad_split(N1, N2, K)
    per = N1 * N2 + N1
    part = _rows(splits, per, like=dy)
    launch(LIB, "f32t_gemm", dy.device,
           [_ptr(dy), _ptr(x), _ptr(part), 0, 0, 0, 0,
            part.data_ptr() + 4 * N1 * N2],
           [N1, N2, K, _ld(dy), _ld(x), N2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0,
            ksplit, per, per], [0.0])
    _reduce(part, [gw, gb])


def _reduce(part: torch.Tensor, outs) -> None:
    """outs (contiguous) = the sum over part's rows, in row order, cut into
    the outputs' sizes.  One launch."""
    sizes = [o.numel() for o in outs] + [0] * (4 - len(outs))
    ptrs = [o.data_ptr() for o in outs] + [0] * (4 - len(outs))
    launch(LIB, "f32t_reduce", part.device, [part.data_ptr(), *ptrs],
           [part.shape[0], part.shape[1], *sizes])


def ln_rows(M: int) -> int:
    """Rows a block of the LayerNorm backward takes (a multiple of its 8
    warps), so that about ``_LN_BLOCKS`` blocks cover M rows."""
    return max(8, -(-(-(-M // _LN_BLOCKS)) // 8) * 8)


def _rownorm(x, w, b) -> torch.Tensor:
    M, D = x.shape
    out = _rows(M, D, like=x)
    launch(LIB, "f32t_rownorm", x.device,
           [x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr()],
           [M, D, _ld(x), D])
    return out


def _ln_bwd(x, w, g, part, col: int, *, drop: Drop = NO_DROP,
            mask_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LayerNorm of x's backward for the upstream g: (dx, dx * keep)
    (dx itself where no dropout is drawn); the per-block column sums of g
    xhat and g go to part[:, col:col + 2D].  One launch."""
    M, D = x.shape
    dx = _rows(M, D, like=x)
    dxk = _rows(M, D, like=x) if drop[2] > 0 else None
    lo, hi, rate = drop
    launch(LIB, "f32t_lnbwd", x.device,
           [x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
            _ptr(dxk), part.data_ptr() + 4 * col],
           [M, D, _ld(x), _ld(g), D, part.shape[1], ln_rows(M), mask_id, lo,
            hi], [rate])
    return dx, (dx if dxk is None else dxk)


def _ln_part(M: int, D: int, n: int, like) -> torch.Tensor:
    """The partials of n LayerNorms' parameter gradients over M rows."""
    return _rows(-(-M // ln_rows(M)), 2 * n * D, like=like)


def _keep_mul(x: torch.Tensor, drop: Drop, mask_id: int) -> torch.Tensor:
    out = torch.empty_like(x)
    lo, hi, rate = drop
    launch(LIB, "f32t_keep_mul", x.device, [x.data_ptr(), out.data_ptr()],
           [x.numel(), mask_id, lo, hi], [rate])
    return out


def _attention(q, k, v, valid, *, B: int, Sq: int, Nk: int, H: int,
               drop: Drop, mask_id: int):
    """(ctx [B Sq, D], lse [B Sq, H]): q [B Sq, D], k / v [B Nk, D] views
    with one row stride, valid [B Nk] float.  One launch."""
    D = q.shape[1]
    out, lse = _rows(B * Sq, D, like=q), _rows(B * Sq, H, like=q)
    lo, hi, rate = drop
    if k.stride(0) != v.stride(0):
        raise ValueError("f32_train: k and v share a row stride")
    launch(LIB, "f32t_attention", q.device,
           [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid),
            out.data_ptr(), lse.data_ptr()],
           [B, Sq, Nk, H, D // H, _ld(q), _ld(k), D, mask_id, lo, hi],
           [1.0 / math.sqrt(D // H), rate])
    return out, lse


def _attention_bwd(q, k, v, valid, dctx, lse, delta, dq, dk, dv, *, B: int,
                   Sq: int, Nk: int, H: int, drop: Drop,
                   mask_id: int) -> None:
    """The attention's backward into dq, dk, dv (views): the query side,
    then the key side.  Two launches."""
    D = q.shape[1]
    lo, hi, rate = drop
    for side in (0, 1):
        launch(LIB, "f32t_attention_bwd", q.device,
               [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid),
                dctx.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr()],
               [B, Sq, Nk, H, D // H, _ld(q), _ld(k), _ld(dctx), _ld(dq),
                _ld(dk), mask_id, lo, hi, side],
               [1.0 / math.sqrt(D // H), rate])


def _rowdot(a, b, H: int) -> torch.Tensor:
    M, D = a.shape
    out = _rows(M, H, like=a)
    launch(LIB, "f32t_rowdot", a.device,
           [a.data_ptr(), b.data_ptr(), out.data_ptr()],
           [M, H, D // H, _ld(a), _ld(b)])
    return out


# -- kernel 8 ---------------------------------------------------------------

def train_self_attention_f32(x, kvalid, p, *, H: int, S: int,
                             drop: Drop = NO_DROP, ids=(0, 1)):
    """Kernel 8's forward: (out, (qkv, ctx, lse)).  x [B S, D]; kvalid
    [B S]; p: in_w, in_b, out_w, out_b; ids: the probability and residual
    masks' ids."""
    M, D = x.shape
    qkv = gemm_f32(x, p["in_w"], bias=p["in_b"])
    ctx, lse = _attention(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], kvalid,
                          B=M // S, Sq=S, Nk=S, H=H, drop=drop,
                          mask_id=ids[0])
    out = gemm_f32(ctx, p["out_w"], bias=p["out_b"], resid=x, drop=drop,
                   mask_id=ids[1])
    return out, (qkv, ctx, lse)


def train_self_attention_f32_bwd(x, kvalid, dout, p, saved, *, H: int,
                                 S: int, drop: Drop = NO_DROP, ids=(0, 1)
                                 ) -> Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """Kernel 8's backward: (dx, {in_w, in_b, out_w, out_b})."""
    qkv, ctx, lse = saved
    M, D = x.shape
    dattn = _keep_mul(dout, drop, ids[1])
    dctx = gemm_f32(dattn, p["out_w"], b_mn=True)
    delta = _rowdot(dctx, ctx, H)
    dqkv = _rows(M, 3 * D, like=x)
    _attention_bwd(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], kvalid, dctx,
                   lse, delta, dqkv[:, :D], dqkv[:, D:2 * D], dqkv[:, 2 * D:],
                   B=M // S, Sq=S, Nk=S, H=H, drop=drop, mask_id=ids[0])
    dx = gemm_f32(dqkv, p["in_w"], b_mn=True, resid=dout)
    grads = {k: _rows(*p[k].shape, like=x) for k in
             ("in_w", "in_b", "out_w", "out_b")}
    wgrad_f32(dqkv, x, grads["in_w"], grads["in_b"])
    wgrad_f32(dattn, ctx, grads["out_w"], grads["out_b"])
    return dx, grads


# -- kernel 9 ---------------------------------------------------------------

def train_postnorm_ffn_f32(x, p, *, activation: str, drop: Drop = NO_DROP,
                           ids=(0, 1)) -> torch.Tensor:
    """Kernel 9's forward: ``LN2(h + (act(h W1^T + b1) m1 W2^T + b2) m2)``
    with ``h = LN1(x)``; ids: the hidden and output masks' ids."""
    h = _rownorm(x, p["ln1_w"], p["ln1_b"])
    gd = gemm_f32(h, p["w1"], bias=p["b1"], act=activation, drop=drop,
                  mask_id=ids[0])
    s = gemm_f32(gd, p["w2"], bias=p["b2"], resid=h, drop=drop,
                 mask_id=ids[1])
    return _rownorm(s, p["ln2_w"], p["ln2_b"])


def train_postnorm_ffn_f32_bwd(x, dout, p, *, activation: str,
                               drop: Drop = NO_DROP, ids=(0, 1)
                               ) -> Tuple[torch.Tensor,
                                          Dict[str, torch.Tensor]]:
    """Kernel 9's backward (``train_postnorm_ffn_bwd_plain``'s math): the
    forward recomputed from x, then (dx, {parameter name: gradient})."""
    M, D = x.shape
    Fd = p["w1"].shape[0]
    h = _rownorm(x, p["ln1_w"], p["ln1_b"])
    a = _rows(M, Fd, like=x)
    gd = gemm_f32(h, p["w1"], bias=p["b1"], act=activation, pre=a,
                  drop=drop, mask_id=ids[0])
    s = gemm_f32(gd, p["w2"], bias=p["b2"], resid=h, drop=drop,
                 mask_id=ids[1])
    part = _ln_part(M, D, 2, x)
    ds, dy = _ln_bwd(s, p["ln2_w"], dout, part, 0, drop=drop,
                     mask_id=ids[1])
    da = gemm_f32(dy, p["w2"], b_mn=True, gin=a, gact=activation, drop=drop,
                  mask_id=ids[0])
    dh = gemm_f32(da, p["w1"], b_mn=True, resid=ds)
    dx, _ = _ln_bwd(x, p["ln1_w"], dh, part, 2 * D)
    grads = {k: _rows(*p[k].shape, like=x) for k in p}
    wgrad_f32(da, h, grads["w1"], grads["b1"])
    wgrad_f32(dy, gd, grads["w2"], grads["b2"])
    _reduce(part, [grads["ln2_w"], grads["ln2_b"], grads["ln1_w"],
                   grads["ln1_b"]])
    return dx, grads


# -- kernel 12 --------------------------------------------------------------

_ATTN = ("in_w", "in_b", "out_w", "out_b")
_FFN = ("ln1_w", "ln1_b", "w1", "b1", "w2", "b2", "ln2_w", "ln2_b")


def train_encoder_layer_f32(x, kvalid, p, *, H: int, S: int,
                            activation: str, drop: Drop = NO_DROP):
    """Kernel 12's forward (masks 0 to 3): (out, (qkv, ctx, lse))."""
    r, saved = train_self_attention_f32(x, kvalid, p, H=H, S=S, drop=drop,
                                        ids=(0, 1))
    return train_postnorm_ffn_f32(r, p, activation=activation, drop=drop,
                                  ids=(2, 3)), saved


def train_encoder_layer_f32_bwd(x, kvalid, dout, p, saved, *, H: int, S: int,
                                activation: str, drop: Drop = NO_DROP
                                ) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    """Kernel 12's backward: the residual r recomputed from the saved ctx,
    kernel 9's backward, then kernel 8's."""
    r = gemm_f32(saved[1], p["out_w"], bias=p["out_b"], resid=x, drop=drop,
                 mask_id=1)
    dr, g_ffn = train_postnorm_ffn_f32_bwd(
        r, dout, {k: p[k] for k in _FFN}, activation=activation, drop=drop,
        ids=(2, 3))
    dx, g_attn = train_self_attention_f32_bwd(
        x, kvalid, dr, {k: p[k] for k in _ATTN}, saved, H=H, S=S, drop=drop,
        ids=(0, 1))
    return dx, {**g_attn, **g_ffn}


# -- kernel 13 --------------------------------------------------------------

def _dec_parts(p):
    sa = {"in_w": p["sa_in_w"], "in_b": p["sa_in_b"],
          "out_w": p["sa_out_w"], "out_b": p["sa_out_b"]}
    ffn = {"ln1_w": p["ln2_w"], "ln1_b": p["ln2_b"], "w1": p["w1"],
           "b1": p["b1"], "w2": p["w2"], "b2": p["b2"], "ln2_w": p["ln3_w"],
           "ln2_b": p["ln3_b"]}
    return sa, ffn


def _cross_forward(t1, memkv, mvalid, p, *, B: int, T: int, L: int, H: int,
                   drop: Drop):
    """The cross-attention segment: (q, cc, lse, r2)."""
    D = t1.shape[1]
    q = gemm_f32(t1, p["ca_in_w"][:D], bias=p["ca_in_b"][:D])
    cc, lse = _attention(q, memkv[:, :D], memkv[:, D:], mvalid, B=B, Sq=T,
                         Nk=L, H=H, drop=drop, mask_id=2)
    r2 = gemm_f32(cc, p["ca_out_w"], bias=p["ca_out_b"], resid=t1, drop=drop,
                  mask_id=3)
    return q, cc, lse, r2


def train_decoder_layer_f32(x, kvalid, mem, mvalid, p, *, H: int, S: int,
                            activation: str, drop: Drop = NO_DROP):
    """Kernel 13's forward (masks 0 to 5): (out, (qkv, ctx, lse, memkv)).
    x [B S, D]; mem [B, L, D]; mvalid [B, L]."""
    M, D = x.shape
    B, L = mem.shape[0], mem.shape[1]
    sa, ffn = _dec_parts(p)
    r1, (qkv, ctx, lse) = train_self_attention_f32(x, kvalid, sa, H=H, S=S,
                                                   drop=drop, ids=(0, 1))
    t1 = _rownorm(r1, p["ln1_w"], p["ln1_b"])
    memkv = gemm_f32(mem.reshape(B * L, D), p["ca_in_w"][D:],
                     bias=p["ca_in_b"][D:])
    r2 = _cross_forward(t1, memkv, mvalid.reshape(B * L), p, B=B, T=S, L=L,
                        H=H, drop=drop)[3]
    out = train_postnorm_ffn_f32(r2, ffn, activation=activation, drop=drop,
                                 ids=(4, 5))
    return out, (qkv, ctx, lse, memkv)


def train_decoder_layer_f32_bwd(x, kvalid, mem, mvalid, dout, p, saved, *,
                                H: int, S: int, activation: str,
                                drop: Drop = NO_DROP):
    """Kernel 13's backward: (dx, dmem [B, L, D], {parameter name:
    gradient})."""
    qkv, ctx, lse, memkv = saved
    M, D = x.shape
    B, L = mem.shape[0], mem.shape[1]
    mrows, mv = mem.reshape(B * L, D), mvalid.reshape(B * L)
    sa, ffn = _dec_parts(p)
    r1 = gemm_f32(ctx, p["sa_out_w"], bias=p["sa_out_b"], resid=x, drop=drop,
                  mask_id=1)
    t1 = _rownorm(r1, p["ln1_w"], p["ln1_b"])
    q, cc, lse2, r2 = _cross_forward(t1, memkv, mv, p, B=B, T=S, L=L, H=H,
                                     drop=drop)
    dr2, g_ffn = train_postnorm_ffn_f32_bwd(r2, dout, ffn,
                                            activation=activation, drop=drop,
                                            ids=(4, 5))
    dco = _keep_mul(dr2, drop, 3)
    dcc = gemm_f32(dco, p["ca_out_w"], b_mn=True)
    delta = _rowdot(dcc, cc, H)
    dq = _rows(M, D, like=x)
    dkv = _rows(B * L, 2 * D, like=x)
    _attention_bwd(q, memkv[:, :D], memkv[:, D:], mv, dcc, lse2, delta, dq,
                   dkv[:, :D], dkv[:, D:], B=B, Sq=S, Nk=L, H=H, drop=drop,
                   mask_id=2)
    dmem = gemm_f32(dkv, p["ca_in_w"][D:], b_mn=True)
    dt1 = gemm_f32(dq, p["ca_in_w"][:D], b_mn=True, resid=dr2)
    part = _ln_part(M, D, 1, x)
    dr1, _ = _ln_bwd(r1, p["ln1_w"], dt1, part, 0)
    grads = {k: _rows(*p[k].shape, like=x) for k in
             ("ln1_w", "ln1_b", "ca_in_w", "ca_in_b", "ca_out_w",
              "ca_out_b")}
    wgrad_f32(dq, t1, grads["ca_in_w"][:D], grads["ca_in_b"][:D])
    wgrad_f32(dkv, mrows, grads["ca_in_w"][D:], grads["ca_in_b"][D:])
    wgrad_f32(dco, cc, grads["ca_out_w"], grads["ca_out_b"])
    _reduce(part, [grads["ln1_w"], grads["ln1_b"]])
    dx, g_sa = train_self_attention_f32_bwd(x, kvalid, dr1, sa,
                                            (qkv, ctx, lse), H=H, S=S,
                                            drop=drop, ids=(0, 1))
    grads.update({"sa_" + k: g for k, g in g_sa.items()})
    grads.update({"ln2_w": g_ffn["ln1_w"], "ln2_b": g_ffn["ln1_b"],
                  "w1": g_ffn["w1"], "b1": g_ffn["b1"], "w2": g_ffn["w2"],
                  "b2": g_ffn["b2"], "ln3_w": g_ffn["ln2_w"],
                  "ln3_b": g_ffn["ln2_b"]})
    return dx, dmem.reshape(B, L, D), grads
