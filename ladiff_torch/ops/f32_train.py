"""The float32 routes of the training kernels 8, 9, 12 and 13 on the card,
forward and backward, launched by the wrappers ``train_self_attention_fwd``
/ ``_bwd``, ``train_postnorm_ffn_fwd`` / ``_bwd``,
``train_encoder_layer_fwd`` / ``_bwd`` and ``train_decoder_layer_fwd`` /
``_bwd`` when their inputs are float32.  The published configurations train
in float32 (``TRAIN.MIXED_PRECISION: false``), as the JAX package's Pallas
kernels do there: they take the module's type and accumulate in float32.

Kernels 8 and 9 are chains of the hand-written SIMT kernels of
``csrc/f32_train.cu`` (on the FFMA tiles of ``csrc/f32_tile.cuh``, which
the inference chains of ``ops/f32_layer.py`` share).  Kernels 12 and 13 run
on the tensor cores in three-term TF32 (``csrc/f32_train_layer.cu`` on
``csrc/f32_tc_tile.cuh``): every product splits each float32 operand into
a TF32 hi and lo part and accumulates lo hi + hi lo + hi hi in float32, the
epilogues take the LayerNorms, residuals, dropout and the softmax's delta,
and the forward saves what the backward would otherwise recompute with a
product.

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
  kernel 12  qkv, attention, out-proj + residual dropout + LN1 (r and h
             kept), W1 + act + dropout (a and the hidden rows kept), W2 +
             dropout + residual + LN2 (the sum s kept)                   5
             backward: LN2's backward (ds, dy), da = (dy W2) m1 act'(a),
             dh = ds + da W1 through LN1's backward (dr, dattn = dr rm),
             dctx = dattn Wout with delta, the attention backward and its
             dQ partials' sum, dx = dr + dqkv Wqkv, the four weight
             gradients as one group of split-K partials, one reduction of
             them and of the LayerNorms' partials                        9
  kernel 13  qkv, attention, out-proj + residual dropout + LN1 (r1, t1
             kept), the cross q and the memory's k / v (one group), the
             cross-attention (cc and its log-sum-exp kept), out-proj +
             dropout + residual + LN2 (r2, h kept), W1, W2 + LN3          8
             backward: LN3's backward, da, dh through LN2's backward (dr2,
             dco), dcc = dco Wco with delta, the cross-attention's
             backward (dq; the memory rows' dk, dv), dt1 = dr2 + dq Wq
             through LN1's backward (dr1, dattn), dctx with delta, the
             attention backward and its dQ sum, dx and dmem = [dk dv] Wkv
             (one group), the seven weight gradients (one group), one
             reduction                                                  12

Dropout: the bf16 kernels' Philox-4x32-10 keyed by (seed, mask id,
element) (``csrc/common.cuh`` ``keep_scale``), so a seed draws the same
masks in both types and ``train_*_masks`` write them out for either.
Kernels 12 and 13 use their own mask ids: 8 uses 0 (probabilities) and 1
(residual), 9 uses 0 (hidden) and 1 (output), 12 uses 0 to 3, 13 uses 0 to
5 (self-attention, cross-attention, FFN).

Numerics: float32 operands and accumulators (kernels 12 and 13: the
three-term TF32 products, about 2^-21 relative a product), LayerNorm eps
1e-5, exact erf GELU, a masked key's logit -1e9 (a sample without a valid
key attends uniformly, forward and backward), no single-term TF32 and no
bf16 anywhere.  Gradients are deterministic: every sum across blocks (the
weight and bias gradients, the LayerNorms' parameters, kernels 12's and
13's dQ over the key tiles) goes through float32 partials summed in a
fixed order, and the attention backward's blocks write disjoint rows.
What is saved: kernels 8 and 9 as the bf16 route, qkv, ctx and the
log-sum-exp, here in float32; kernel 12 also r, h, the pre-activation a,
the hidden rows and the pre-LN2 sum s; kernel 13 also the memory k / v,
r1, t1, q, cc, the cross log-sum-exp, r2, h, a, the hidden rows and s.
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
           "tc_wgrad_split", "attention_key_tiles", "tc_prob", "CHAIN_LAUNCHES"]

LIB = "f32_train"
ACT = {None: 0, "relu": 1, "gelu": 2}
# kernel launches of one wrapper call on the float32 route
CHAIN_LAUNCHES = {"train_self_attention": 3, "train_self_attention_bwd": 10,
                  "train_postnorm_ffn": 4, "train_postnorm_ffn_bwd": 12,
                  "train_encoder_layer": 5, "train_encoder_layer_bwd": 9,
                  "train_decoder_layer": 8, "train_decoder_layer_bwd": 12}
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


# -- kernels 12 and 13 on the tensor cores (csrc/f32_train_layer.cu) -------

LIB_TC = "f32_train_layer"
_ROW = {None: 0, "lnf": 1, "lnb": 2, "delta": 3}
TC_ROW_BM = 64      # rows of a row-epilogue block: one LayerNorm partial
TC_TILE = 128       # a grouped weight gradient's output tile
TC_FILL = 264       # blocks a group of weight gradients fills at most
TC_FLUSH = 1024     # rows a weight gradient's partial sums at most
# the inference tiles (each 8-deep step added to the accumulator in
# float32; the geometry's reasons: csrc/f32_train_layer.cu's note): 64 x
# 128 products, 32-row LayerNorm blocks
TC_PRODUCT_ROWS = 64
TC_ROW_BLOCK = 32
_ATTN = ("in_w", "in_b", "out_w", "out_b")
_FFN = ("ln1_w", "ln1_b", "w1", "b1", "w2", "b2", "ln2_w", "ln2_b")


def tc_prob(A, B, C, *, a_mn=False, b_mn=False, bias=None, act=None,
            pre=None, gin=None, gact=None, R=None, mask=-1, row=None,
            xout=None, lnw=None, lnb=None, lnx=None, C2=None, mask2=-1,
            part=None, ctx=None, delta=None, H=0, ksplit=0, stride=0,
            colsum=None, tile=0):
    """One product of ``f32l_gemm``: ``C = epi(A B^T)`` with A = a [M, K]
    (a^T where ``a_mn``) and B = b [N, K] (b^T where ``b_mn``: dY W).
    Epilogue ``v = act(acc + bias)`` (acc + bias to ``pre``), times
    ``act'(gin)``, times the keep-scale of ``mask`` at m N + n, plus ``R``;
    then by ``row`` (whole rows, N <= 256): "lnf" stores v to ``xout`` and
    ``LN(v) lnw + lnb`` to C; "lnb" takes v as the gradient of
    ``LN(lnx)`` and stores its dx to C (and dx times the keep-scale of
    ``mask2`` to ``C2``; the column sums of g xhat and g of each 64-row
    block to ``part``); "delta" stores v and ``delta[m, h]`` = the head-h
    dot product of v and ``ctx``.  With ``stride`` > 0 (a and b both
    M/N-major): split-K partials instead, the K rows in splits of
    ``ksplit``, each split's in partials of ``TC_FLUSH`` rows, partial i
    at C + i ``stride`` and split z's column sums of a at ``colsum`` + z
    ``stride``.  ``tile``: the output tile's rows (0: 128, or 64 for a
    row epilogue; the inference tiles ``TC_PRODUCT_ROWS`` and
    ``TC_ROW_BLOCK``).  Returns (ptrs, ints)."""
    M, K = (A.shape[1], A.shape[0]) if a_mn else A.shape
    N, Kb = (B.shape[1], B.shape[0]) if b_mn else B.shape
    if Kb != K or C.shape != (M, N):
        raise ValueError(f"f32l_gemm: {tuple(A.shape)} against "
                         f"{tuple(B.shape)} into {tuple(C.shape)}")
    ptrs = [_ptr(t) for t in (A, B, C, bias, pre, gin, R, colsum, xout, lnw,
                              lnb, lnx, C2, part, ctx, delta)]
    ints = [M, N, K, _ld(A), _ld(B), _ld(C), int(a_mn), int(b_mn), ACT[act],
            _ld(pre), _ld(gin), ACT[gact], _ld(R), mask,
            ksplit or -(-K // 16) * 16, _ROW[row], _ld(xout), _ld(lnx), mask2,
            _ld(part), _ld(ctx), H, stride, stride, TC_FLUSH if stride else 0,
            tile]
    return ptrs, ints


def _launch_gemm(like: torch.Tensor, probs, drop: Drop = NO_DROP) -> None:
    """One launch of a group of products of one layout and epilogue kind
    (``tc_prob`` each, or a weight gradient's partials) on like's device."""
    lo, hi, rate = drop
    launch(LIB_TC, "f32l_gemm", like.device,
           [p for pr in probs for p in pr[0]],
           [len(probs), lo, hi, *[i for pr in probs for i in pr[1]]], [rate])


def tc_wgrad_split(K: int, tiles: int) -> Tuple[int, int]:
    """(splits, rows a split) of a weight gradient over K rows in a group
    of ``tiles`` 128 x 128 output tiles: the tiles times the splits fill at
    most ``TC_FILL`` blocks (one wave of two blocks an SM: a second, thin
    wave would cost a whole block's time), a split at most every 64 rows,
    whole 16-row slices."""
    splits = max(1, min(TC_FILL // tiles, -(-K // 64)))
    ksplit = -(-(-(-K // splits)) // 16) * 16
    return -(-K // ksplit), ksplit


def _wgrads(items, grads, like) -> list:
    """``grads[w] = dy^T x`` and ``grads[b] = dy.sum(0)`` for each item (dy
    [K, N1], x [K, N2], w, b; a name may be a (name, row slice) pair): one
    launch of split-K partials, each of at most ``TC_FLUSH`` rows (the
    bias's one a split); returns their reduction's segments."""
    tiles = sum(-(-dy.shape[1] // TC_TILE) * -(-x.shape[1] // TC_TILE)
                for dy, x, _, _ in items)
    probs, segs = [], []
    for dy, x, wname, bname in items:
        K, N1 = dy.shape
        N2 = x.shape[1]
        splits, ksplit = tc_wgrad_split(K, tiles)
        nsub = -(-ksplit // TC_FLUSH)
        per = N1 * N2 + N1
        part = _rows(splits * nsub, per, like=like)
        probs.append(tc_prob(dy, x, part[0, :N1 * N2].view(N1, N2), a_mn=True,
                             b_mn=True, ksplit=ksplit, stride=per,
                             colsum=part[0, N1 * N2:]))
        segs += [_seg(part, splits * nsub, per, 1, N1 * N2,
                      _out(grads, wname)),
                 _seg(part, splits, per, 1, N1, _out(grads, bname),
                      offset=N1 * N2)]
    _launch_gemm(like, probs)
    return segs


def _out(grads, name):
    if isinstance(name, tuple):
        return grads[name[0]][name[1]]
    return grads[name]


def _seg(part, splits, pstride, rows, cols, out, *, offset=0, ldo=None):
    """A reduction segment: ``out[r, c] = sum_z part[z pstride + offset + r
    cols + c]`` (out contiguous, or rows of stride ``ldo``); it holds the
    two tensors until the reduction is launched."""
    return (part.data_ptr() + 4 * offset, out.data_ptr(),
            [splits, pstride, rows, cols, cols if ldo is None else ldo],
            (part, out))


def _reduce_tc(segs, like) -> None:
    """Every segment's partials summed in split order.  One launch."""
    launch(LIB_TC, "f32l_reduce", like.device,
           [p for s in segs for p in s[:2]],
           [len(segs), *[i for s in segs for i in s[2]]])


def _ln_segs(part, gw, gb, D: int) -> list:
    """The LayerNorm parameter gradients from the per-block partials [row
    blocks, 2 D] (g xhat, then g)."""
    n = part.shape[0]
    return [_seg(part, n, 2 * D, 1, D, gw),
            _seg(part, n, 2 * D, 1, D, gb, offset=D)]


def _ln_part_tc(M: int, D: int, like) -> torch.Tensor:
    return _rows(-(-M // TC_ROW_BM), 2 * D, like=like)


def _ln_bwd_tc(x, w, g, drop: Drop, mask_id: int):
    """The LayerNorm of x's backward for the upstream g: (dx, dx * keep of
    ``mask_id`` (dx where no dropout is drawn), the per-block partials of
    its parameters' gradients).  One launch."""
    M, D = x.shape
    dx = _rows(M, D, like=x)
    dxk = _rows(M, D, like=x) if drop[2] > 0 else None
    part = _ln_part_tc(M, D, x)
    lo, hi, rate = drop
    launch(LIB_TC, "f32l_ln_bwd", x.device,
           [x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
            _ptr(dxk), part.data_ptr()],
           [M, D, _ld(x), _ld(g), D, 2 * D, mask_id, lo, hi], [rate])
    return dx, (dx if dxk is None else dxk), part


def _tc_attention(q, k, v, valid, *, B: int, S: int, H: int, drop: Drop,
                  mask_id: int):
    """(ctx [B S, D], lse [B S, H]) of the self-attention of q, k, v [B S,
    D] views (k and v of one row stride).  One launch."""
    D = q.shape[1]
    out, lse = _rows(B * S, D, like=q), _rows(B * S, H, like=q)
    lo, hi, rate = drop
    launch(LIB_TC, "f32l_attention", q.device,
           [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid),
            out.data_ptr(), lse.data_ptr()],
           [B, S, S, H, D // H, _ld(q), _ld(k), D, mask_id, lo, hi],
           [1.0 / math.sqrt(D // H), rate])
    return out, lse


def attention_key_tiles(S: int) -> int:
    """The attention backward's 64-key tiles: its dQ partials."""
    return -(-S // 64)


def _tc_attention_bwd(q, k, v, valid, dctx, lse, delta, dqkv, *, B: int,
                      S: int, H: int, drop: Drop, mask_id: int) -> None:
    """The self-attention's backward into dqkv [B S, 3 D]: dk and dv whole,
    dq as one partial per key tile, then their sum in key-tile order.  Two
    launches."""
    D = q.shape[1]
    M = B * S
    tiles = attention_key_tiles(S)
    dqp = _rows(tiles, M * D, like=q)
    lo, hi, rate = drop
    launch(LIB_TC, "f32l_attention_bwd", q.device,
           [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid),
            dctx.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dqp.data_ptr(), dqkv[:, D:].data_ptr(),
            dqkv[:, 2 * D:].data_ptr()],
           [B, S, S, H, D // H, _ld(q), _ld(k), _ld(dctx), _ld(dqkv),
            mask_id, lo, hi], [1.0 / math.sqrt(D // H), rate])
    _reduce_tc([_seg(dqp, tiles, M * D, M, D, dqkv, ldo=_ld(dqkv))], q)


def _cross_tc(q, memkv, mvalid, *, B: int, S: int, L: int, H: int,
              drop: Drop):
    """Kernel 13's cross-attention over the L memory rows: (cc, lse).  One
    launch."""
    D = q.shape[1]
    cc, lse = _rows(B * S, D, like=q), _rows(B * S, H, like=q)
    lo, hi, rate = drop
    launch(LIB_TC, "f32l_cross_attention", q.device,
           [q.data_ptr(), memkv.data_ptr(), _ptr(mvalid), cc.data_ptr(),
            lse.data_ptr()],
           [B, S, L, H, D // H, _ld(q), _ld(memkv), D, 2, lo, hi],
           [1.0 / math.sqrt(D // H), rate])
    return cc, lse


def _cross_bwd_tc(q, memkv, mvalid, dcc, lse, delta, *, B: int, S: int,
                  L: int, H: int, drop: Drop):
    """Its backward: (dq [B S, D], dkv [B L, 2 D]).  One launch."""
    D = q.shape[1]
    dq, dkv = _rows(B * S, D, like=q), _rows(B * L, 2 * D, like=q)
    lo, hi, rate = drop
    launch(LIB_TC, "f32l_cross_attention_bwd", q.device,
           [q.data_ptr(), memkv.data_ptr(), _ptr(mvalid), dcc.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dkv.data_ptr()],
           [B, S, L, H, D // H, _ld(q), _ld(memkv), _ld(dcc), D, 2 * D, 2,
            lo, hi], [1.0 / math.sqrt(D // H), rate])
    return dq, dkv


def _attn_forward(x, kvalid, sa, ln, *, H: int, S: int, drop: Drop, ids):
    """The layers' shared head: qkv, the self-attention, the out-
    projection with the residual dropout (mask ids[1]) and the LayerNorm
    ``ln`` = (w, b) in its epilogue: (qkv, ctx, lse, r, t)."""
    M, D = x.shape
    qkv = _rows(M, 3 * D, like=x)
    _launch_gemm(x, [tc_prob(x, sa["in_w"], qkv, bias=sa["in_b"])], drop)
    ctx, lse = _tc_attention(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:],
                             kvalid, B=M // S, S=S, H=H, drop=drop,
                             mask_id=ids[0])
    r, t = _rows(M, D, like=x), _rows(M, D, like=x)
    _launch_gemm(x, [tc_prob(ctx, sa["out_w"], t, bias=sa["out_b"],
                             mask=ids[1], R=x, row="lnf", xout=r, lnw=ln[0],
                             lnb=ln[1])], drop)
    return qkv, ctx, lse, r, t


def _ffn_forward(h, p, *, activation: str, drop: Drop, ids):
    """``LN2(h + (act(h W1^T + b1) m1 W2^T + b2) m2)`` (masks ids): (out,
    a, gd, s), a the pre-activation, gd the dropped hidden rows, s the
    pre-LN2 sum.  Two launches."""
    M, D = h.shape
    Fd = p["w1"].shape[0]
    a, gd = _rows(M, Fd, like=h), _rows(M, Fd, like=h)
    _launch_gemm(h, [tc_prob(h, p["w1"], gd, bias=p["b1"], act=activation,
                             pre=a, mask=ids[0])], drop)
    s, out = _rows(M, D, like=h), _rows(M, D, like=h)
    _launch_gemm(h, [tc_prob(gd, p["w2"], out, bias=p["b2"], mask=ids[1],
                             R=h, row="lnf", xout=s, lnw=p["ln2_w"],
                             lnb=p["ln2_b"])], drop)
    return out, a, gd, s


def _ffn_backward(dout, saved, p, *, activation: str, drop: Drop, ids,
                  lnx, lnw, part):
    """The FFN segment's backward down to the LayerNorm before it (of
    ``lnx``, weight ``lnw``): LN2's backward (ds, dy), da = (dy W2) m1
    act'(a), then dh = ds + da W1 through that LayerNorm's backward in the
    epilogue: (dr, dr * keep of ``ids[2]``, dy, da, LN2's partials).  Three
    launches."""
    h, a, gd, s = saved
    M, D = h.shape
    Fd = a.shape[1]
    ds, dy, part2 = _ln_bwd_tc(s, p["ln2_w"], dout, drop, ids[1])
    da = _rows(M, Fd, like=h)
    _launch_gemm(h, [tc_prob(dy, p["w2"], da, b_mn=True, gin=a,
                             gact=activation, mask=ids[0])], drop)
    dr = _rows(M, D, like=h)
    drk = _rows(M, D, like=h) if drop[2] > 0 else None
    _launch_gemm(h, [tc_prob(da, p["w1"], dr, b_mn=True, R=ds, row="lnb",
                             lnx=lnx, lnw=lnw, C2=drk, mask2=ids[2],
                             part=part)], drop)
    return dr, (dr if drk is None else drk), dy, da, part2


def _dctx(dattn, w, ctx, H: int):
    """dctx = dattn W and the softmax's delta = dctx . ctx per head."""
    M, D = dattn.shape
    dctx, delta = _rows(M, D, like=dattn), _rows(M, H, like=dattn)
    _launch_gemm(dattn, [tc_prob(dattn, w, dctx, b_mn=True, row="delta",
                                 ctx=ctx, delta=delta, H=H)])
    return dctx, delta


def train_encoder_layer_f32(x, kvalid, p, *, H: int, S: int,
                            activation: str, drop: Drop = NO_DROP):
    """Kernel 12's forward (masks 0 to 3): (out, (qkv, ctx, lse, r, h, a,
    gd, s)).  Five launches."""
    qkv, ctx, lse, r, h = _attn_forward(x, kvalid, p,
                                        (p["ln1_w"], p["ln1_b"]), H=H, S=S,
                                        drop=drop, ids=(0, 1))
    out, a, gd, s = _ffn_forward(h, p, activation=activation, drop=drop,
                                 ids=(2, 3))
    return out, (qkv, ctx, lse, r, h, a, gd, s)


def train_encoder_layer_f32_bwd(x, kvalid, dout, p, saved, *, H: int, S: int,
                                activation: str, drop: Drop = NO_DROP
                                ) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    """Kernel 12's backward from the forward's saved activations: (dx,
    {parameter name: gradient}).  Nine launches."""
    qkv, ctx, lse, r, h, a, gd, s = saved
    M, D = x.shape
    part1 = _ln_part_tc(M, D, x)
    dr, dattn, dy, da, part2 = _ffn_backward(
        dout, (h, a, gd, s), p, activation=activation, drop=drop,
        ids=(2, 3, 1), lnx=r, lnw=p["ln1_w"], part=part1)
    dctx, delta = _dctx(dattn, p["out_w"], ctx, H)
    dqkv = _rows(M, 3 * D, like=x)
    _tc_attention_bwd(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], kvalid,
                      dctx, lse, delta, dqkv, B=M // S, S=S, H=H, drop=drop,
                      mask_id=0)
    dx = _rows(M, D, like=x)
    _launch_gemm(x, [tc_prob(dqkv, p["in_w"], dx, b_mn=True, R=dr)])
    grads = {k: _rows(*p[k].shape, like=x) for k in _ATTN + _FFN}
    segs = _wgrads([(dqkv, x, "in_w", "in_b"), (dattn, ctx, "out_w", "out_b"),
                    (da, h, "w1", "b1"), (dy, gd, "w2", "b2")], grads, x)
    segs += _ln_segs(part2, grads["ln2_w"], grads["ln2_b"], D)
    segs += _ln_segs(part1, grads["ln1_w"], grads["ln1_b"], D)
    _reduce_tc(segs, x)
    return dx, grads


# -- kernel 13 --------------------------------------------------------------

def _dec_parts(p):
    sa = {"in_w": p["sa_in_w"], "in_b": p["sa_in_b"],
          "out_w": p["sa_out_w"], "out_b": p["sa_out_b"]}
    ffn = {"ln1_w": p["ln2_w"], "ln1_b": p["ln2_b"], "w1": p["w1"],
           "b1": p["b1"], "w2": p["w2"], "b2": p["b2"], "ln2_w": p["ln3_w"],
           "ln2_b": p["ln3_b"]}
    return sa, ffn


def train_decoder_layer_f32(x, kvalid, mem, mvalid, p, *, H: int, S: int,
                            activation: str, drop: Drop = NO_DROP):
    """Kernel 13's forward (masks 0 to 5): (out, (qkv, ctx, lse, memkv,
    r1, t1, q, cc, lse2, r2, h, a, gd, s)).  x [B S, D]; mem [B, L, D];
    mvalid [B, L].  Eight launches."""
    M, D = x.shape
    B, L = mem.shape[0], mem.shape[1]
    sa, ffn = _dec_parts(p)
    qkv, ctx, lse, r1, t1 = _attn_forward(x, kvalid, sa,
                                          (p["ln1_w"], p["ln1_b"]), H=H,
                                          S=S, drop=drop, ids=(0, 1))
    q, memkv = _rows(M, D, like=x), _rows(B * L, 2 * D, like=x)
    cw, cb = p["ca_in_w"], p["ca_in_b"]
    _launch_gemm(x, [tc_prob(t1, cw[:D], q, bias=cb[:D]),
                     tc_prob(mem.reshape(B * L, D), cw[D:], memkv,
                             bias=cb[D:])])
    cc, lse2 = _cross_tc(q, memkv, mvalid.reshape(B * L), B=B, S=S, L=L,
                         H=H, drop=drop)
    r2, h = _rows(M, D, like=x), _rows(M, D, like=x)
    _launch_gemm(x, [tc_prob(cc, p["ca_out_w"], h, bias=p["ca_out_b"], mask=3,
                             R=t1, row="lnf", xout=r2, lnw=p["ln2_w"],
                             lnb=p["ln2_b"])], drop)
    out, a, gd, s = _ffn_forward(h, ffn, activation=activation, drop=drop,
                                 ids=(4, 5))
    return out, (qkv, ctx, lse, memkv, r1, t1, q, cc, lse2, r2, h, a, gd, s)


def train_decoder_layer_f32_bwd(x, kvalid, mem, mvalid, dout, p, saved, *,
                                H: int, S: int, activation: str,
                                drop: Drop = NO_DROP):
    """Kernel 13's backward from the forward's saved activations: (dx, dmem
    [B, L, D], {parameter name: gradient}).  Twelve launches."""
    (qkv, ctx, lse, memkv, r1, t1, q, cc, lse2, r2, h, a, gd, s) = saved
    M, D = x.shape
    B, L = mem.shape[0], mem.shape[1]
    mrows, mv = mem.reshape(B * L, D), mvalid.reshape(B * L)
    sa, ffn = _dec_parts(p)
    part2, part1 = _ln_part_tc(M, D, x), _ln_part_tc(M, D, x)
    dr2, dco, dy, da, part3 = _ffn_backward(
        dout, (h, a, gd, s), ffn, activation=activation, drop=drop,
        ids=(4, 5, 3), lnx=r2, lnw=p["ln2_w"], part=part2)
    dcc, delta2 = _dctx(dco, p["ca_out_w"], cc, H)
    dq, dkv = _cross_bwd_tc(q, memkv, mv, dcc, lse2, delta2, B=B, S=S, L=L,
                            H=H, drop=drop)
    cw = p["ca_in_w"]
    dr1 = _rows(M, D, like=x)
    dattn = _rows(M, D, like=x) if drop[2] > 0 else None
    _launch_gemm(x, [tc_prob(dq, cw[:D], dr1, b_mn=True, R=dr2, row="lnb",
                             lnx=r1, lnw=p["ln1_w"], C2=dattn, mask2=1,
                             part=part1)], drop)
    dattn = dr1 if dattn is None else dattn
    dctx, delta = _dctx(dattn, p["sa_out_w"], ctx, H)
    dqkv = _rows(M, 3 * D, like=x)
    _tc_attention_bwd(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], kvalid,
                      dctx, lse, delta, dqkv, B=B, S=S, H=H, drop=drop,
                      mask_id=0)
    dx, dmem = _rows(M, D, like=x), _rows(B * L, D, like=x)
    _launch_gemm(x, [tc_prob(dqkv, p["sa_in_w"], dx, b_mn=True, R=dr1),
                     tc_prob(dkv, cw[D:], dmem, b_mn=True)])
    grads = {k: _rows(*p[k].shape, like=x) for k in p}
    segs = _wgrads([(dqkv, x, "sa_in_w", "sa_in_b"),
                    (dattn, ctx, "sa_out_w", "sa_out_b"),
                    (dq, t1, ("ca_in_w", slice(0, D)),
                     ("ca_in_b", slice(0, D))),
                    (dkv, mrows, ("ca_in_w", slice(D, 3 * D)),
                     ("ca_in_b", slice(D, 3 * D))),
                    (dco, cc, "ca_out_w", "ca_out_b"),
                    (da, h, "w1", "b1"), (dy, gd, "w2", "b2")], grads, x)
    segs += _ln_segs(part3, grads["ln3_w"], grads["ln3_b"], D)
    segs += _ln_segs(part2, grads["ln2_w"], grads["ln2_b"], D)
    segs += _ln_segs(part1, grads["ln1_w"], grads["ln1_b"], D)
    _reduce_tc(segs, x)
    return dx, dmem.reshape(B, L, D), grads
