"""The float32 routes of K1, K2 and kernels 5, 6, 7, 10 and 11 on the card,
launched by the wrappers ``fused_md_layer``, ``fused_decoder_layer``,
``fused_postnorm_ffn``, ``fused_stylized_ffn``,
``fused_broadcast_stylize``, ``fused_masked_attention`` and
``fused_md_stack`` when their inputs are float32.  The published
configurations compute in float32 (``TRAIN.MIXED_PRECISION: false``), as
the JAX package's Pallas kernels do there: they take the module's type and
accumulate in float32.

K2 and kernel 10 run on the tensor cores in three-term TF32
(``csrc/f32_train_layer.cu`` on ``csrc/f32_tc_tile.cuh``, the tiles of
the float32 kernels 12 and 13): each float32 operand splits into a TF32 hi
and lo part and a product accumulates lo hi + hi lo + hi hi in float32.
K2 is kernel 13's forward at rate 0 with nothing saved, on the inference
tiles (64-row products, 32-row LayerNorm blocks, each 8-deep step of a
product added in float32);
kernel 10 is the inference attention tile, each key tile's K and V split
once a block and key tiles without a valid key skipped.  The others are short chains of
the three hand-written FFMA kernels of ``csrc/f32_layer.cu`` (a tiled GEMM
with bias / activation / residual epilogues, a row LayerNorm with optional
AdaLN and SiLU, a masked softmax attention over one or two key sources).

Launches a call (one launch count on the wrapper):

  kernel 5   LN1, W1 + act, W2 + residual, LN2                          4
  kernel 10  attention                                                  1
  kernel 7   the one-token collapse (LN of the masked value row, AdaLN,
             SiLU), its projection + residual                           2
  kernel 6   W1 + GELU, W2, LN + AdaLN + SiLU, projection + residual    4
  K2         qkv, self-attention, out-proj + residual + LN1, the cross q
             with the memory's k / v (one group), cross-attention, cross
             out-proj + residual + LN2, W1 + act, W2 + residual + LN3    8
  K1         latent qkv, text / time k / v, attention over both, out-proj
             + residual, then the chains of kernels 5 (ReLU), 7 and 6   14
  kernel 11  K1's chain per layer, each skip Linear(2D -> D) one GEMM
             over [x, skip] (the layers around it write the two halves
             of its input), the final LN: 14 L + (L - 1) / 2 + 1, 131 at
             the published 9 layers

Numerics are the plain versions': float32 operands and accumulators (K2
and kernel 10: the three-term TF32 products, about 2^-21 relative a
product), LayerNorm eps 1e-5 (of an all-zero row: its bias), exact erf
GELU, a masked key's logit -1e9 (a sample without a valid key attends
uniformly), no single-term TF32 and no bf16 anywhere, nothing rounded
between layers.  What bounds each kernel, and its time against the bound,
is in PERF.md §6.

The float32 kernels' own budget is at least the bf16 kernels' (any width,
memory rows and FFN width; an attention head width up to 128), so on
every shape the bf16 shape gates take the float32 route holds as well: one
shape gate per kernel serves both types, and a module's route on the card
is the same in bf16 and float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ladiff_torch.ops.cuda_common import launch
from ladiff_torch.ops.f32_train import (LIB_TC, TC_PRODUCT_ROWS,
                                        TC_ROW_BLOCK, tc_prob)

__all__ = ["linear_f32", "rownorm_f32", "attention_f32", "postnorm_ffn_f32",
           "attention_tc", "masked_attention_f32", "decoder_layer_f32",
           "broadcast_stylize_f32", "stylized_ffn_f32", "md_layer_f32",
           "md_stack_f32", "md_stack_launches", "ACT", "CHAIN_LAUNCHES"]

ACT = {None: 0, "relu": 1, "gelu": 2}
LIB = "f32_layer"
# the tensors of ``stack_md_params`` that are not a layer's
_STACK_ONLY = ("lin_w", "lin_b", "norm_w", "norm_b")


def md_stack_launches(layers: int) -> int:
    """Kernel launches of kernel 11's float32 chain over ``layers``
    layers: K1's 14 a layer, one a skip Linear, one for the final LN."""
    return 14 * layers + (layers - 1) // 2 + 1


# kernel launches of one wrapper call on the float32 route (kernel 11 at
# the published 9 layers)
CHAIN_LAUNCHES = {"fused_postnorm_ffn": 4, "fused_masked_attention": 1,
                  "fused_broadcast_stylize": 2, "fused_stylized_ffn": 4,
                  "fused_decoder_layer": 8, "fused_md_layer": 14,
                  "fused_md_stack": md_stack_launches(9)}


def _ld(t: torch.Tensor) -> int:
    """The row stride of a 2-D float32 view whose rows are contiguous."""
    if t.dim() != 2 or t.stride(1) != 1 or t.dtype != torch.float32:
        raise ValueError(f"f32_layer: a float32 2-D view with contiguous "
                         f"rows, got {tuple(t.shape)} strides {t.stride()} "
                         f"{t.dtype}")
    return t.stride(0)


def linear_f32(a: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *, act: Optional[str] = None,
               resid: Optional[torch.Tensor] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(a w^T + b) + resid`` in one launch: a [M, K] (a view with
    contiguous rows), w [N, K] contiguous, b [N], resid [M, N] (a view);
    written into ``out`` [M, N] (a view) where given."""
    M, K = a.shape
    N = w.shape[0]
    if not w.is_contiguous() or w.shape[1] != K:
        raise ValueError(f"linear_f32: weight {tuple(w.shape)} against "
                         f"input {tuple(a.shape)}")
    if out is None:
        out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    elif out.shape != (M, N):
        raise ValueError(f"linear_f32: out {tuple(out.shape)}, not "
                         f"{(M, N)}")
    launch(LIB, "f32_linear", a.device,
           [a.data_ptr(), w.data_ptr(), 0 if b is None else b.data_ptr(),
            0 if resid is None else resid.data_ptr(), out.data_ptr()],
           [M, N, K, _ld(a), 0 if resid is None else _ld(resid), _ld(out),
            ACT[act]])
    return out


def rownorm_f32(src: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                rows: Optional[int] = None, src_div: int = 1,
                row_scale: Optional[torch.Tensor] = None,
                ss: Optional[torch.Tensor] = None,
                ss_div: int = 0) -> torch.Tensor:
    """Row r of the result is ``LN(src[r // src_div] * row_scale[r])``
    (weight w, bias b, eps 1e-5), then with ``ss`` [S, 2D] ``SiLU(y (1 +
    scale) + shift)`` with (scale, shift) row ``r // ss_div`` of ss (row 0
    where ``ss_div`` is 0)."""
    D = src.shape[1]
    M = src.shape[0] * src_div if rows is None else rows
    out = torch.empty(M, D, dtype=torch.float32, device=src.device)
    launch(LIB, "f32_rownorm", src.device,
           [src.data_ptr(), 0 if row_scale is None else row_scale.data_ptr(),
            w.data_ptr(), b.data_ptr(), 0 if ss is None else ss.data_ptr(),
            out.data_ptr()],
           [M, D, _ld(src), src_div, ss_div, D])
    return out


def attention_f32(q: torch.Tensor, k1: torch.Tensor, v1: torch.Tensor,
                  valid1: Optional[torch.Tensor], *, B: int, Sq: int, n1: int,
                  H: int, k2: Optional[torch.Tensor] = None,
                  v2: Optional[torch.Tensor] = None,
                  n2: int = 0) -> torch.Tensor:
    """Masked softmax attention per sample and head, one launch.  q [B Sq,
    D], k1 / v1 [B n1, D] (views with contiguous rows, one row stride)
    with ``valid1`` [B n1] float (> 0.5 valid) or None (all valid), and
    k2 / v2 [B n2, D], always valid.  Returns [B Sq, D]."""
    D = q.shape[1]
    Dh = D // H
    if k1.stride(0) != v1.stride(0) or (n2 and k2.stride(0) != v2.stride(0)):
        raise ValueError("attention_f32: k and v of a source share a stride")
    out = torch.empty(B * Sq, D, dtype=torch.float32, device=q.device)
    launch(LIB, "f32_attention", q.device,
           [q.data_ptr(), k1.data_ptr(), v1.data_ptr(),
            0 if valid1 is None else valid1.data_ptr(),
            0 if k2 is None else k2.data_ptr(),
            0 if v2 is None else v2.data_ptr(), out.data_ptr()],
           [B, Sq, n1, n2, H, Dh, _ld(q), _ld(k1),
            _ld(k2) if n2 else 0, D],
           [1.0 / math.sqrt(Dh)])
    return out


def postnorm_ffn_f32(x: torch.Tensor, p, *, activation: str
                     ) -> torch.Tensor:
    """Kernel 5's float32 chain: ``LN2(h + W2 act(W1 h + b1) + b2)`` with
    ``h = LN1(x)``."""
    h = rownorm_f32(x, p["ln1_w"], p["ln1_b"])
    a = linear_f32(h, p["w1"], p["b1"], act=activation)
    y = linear_f32(a, p["w2"], p["b2"], resid=h)
    return rownorm_f32(y, p["ln2_w"], p["ln2_b"])


def _rows(M: int, N: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(M, N, dtype=torch.float32, device=like.device)


def attention_tc(q, k, v, valid: Optional[torch.Tensor], *, B: int, S: int,
                 H: int) -> torch.Tensor:
    """The attention at inference on the tensor cores (``csrc/
    f32_train_layer.cu`` ``f32l_masked_attention``), one launch: q, k, v
    [B S, D] views with contiguous rows (k and v of one row stride), valid
    [B S] float (> 0.5 valid) or None.  Returns [B S, D]."""
    D = q.shape[1]
    if k.stride(0) != v.stride(0):
        raise ValueError("attention_tc: k and v share a row stride")
    out = _rows(B * S, D, q)
    launch(LIB_TC, "f32l_masked_attention", q.device,
           [q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if valid is None else valid.data_ptr(), out.data_ptr()],
           [B, S, S, H, D // H, _ld(q), _ld(k), D],
           [1.0 / math.sqrt(D // H)])
    return out


def masked_attention_f32(q, k, v, kvalid: Optional[torch.Tensor], *,
                         H: int) -> torch.Tensor:
    """Kernel 10's float32 route: q, k, v [B, S, D]; kvalid [B, S] float
    or None.  Returns [B, S, D]."""
    B, S, D = q.shape
    out = attention_tc(q.reshape(B * S, D), k.reshape(B * S, D),
                       v.reshape(B * S, D),
                       None if kvalid is None else kvalid.reshape(B * S),
                       B=B, S=S, H=H)
    return out.reshape(B, S, D)


def _gemm_tc(like: torch.Tensor, probs) -> None:
    """One ``f32l_gemm`` launch of a group of ``tc_prob`` products (no
    dropout)."""
    launch(LIB_TC, "f32l_gemm", like.device,
           [p for pr in probs for p in pr[0]],
           [len(probs), 0, 0, *[i for pr in probs for i in pr[1]]], [0.0])


def decoder_layer_f32(x, kvalid, mem, mvalid, p, *, T: int, H: int,
                      activation: str) -> torch.Tensor:
    """K2's float32 route (``decoder_layer_plain``'s math) on the tensor
    cores, eight launches: x [B T, D], kvalid [B T], mem [B, L, D], mvalid
    [B, L]."""
    M, D = x.shape
    B, L = mem.shape[0], mem.shape[1]
    Fd = p["w1"].shape[0]
    gen, row = TC_PRODUCT_ROWS, TC_ROW_BLOCK
    qkv = _rows(M, 3 * D, x)
    _gemm_tc(x, [tc_prob(x, p["sa_in_w"], qkv, bias=p["sa_in_b"],
                         tile=gen)])
    ctx = attention_tc(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], kvalid,
                       B=B, S=T, H=H)
    t1 = _rows(M, D, x)
    _gemm_tc(x, [tc_prob(ctx, p["sa_out_w"], t1, bias=p["sa_out_b"], R=x,
                         row="lnf", lnw=p["ln1_w"], lnb=p["ln1_b"],
                         tile=row)])
    q, memkv = _rows(M, D, x), _rows(B * L, 2 * D, x)
    cw, cb = p["ca_in_w"], p["ca_in_b"]
    _gemm_tc(x, [tc_prob(t1, cw[:D], q, bias=cb[:D], tile=gen),
                 tc_prob(mem.reshape(B * L, D), cw[D:], memkv, bias=cb[D:],
                         tile=gen)])
    cc = _rows(M, D, x)
    launch(LIB_TC, "f32l_cross_attention", x.device,
           [q.data_ptr(), memkv.data_ptr(), mvalid.data_ptr(),
            cc.data_ptr(), 0],
           [B, T, L, H, D // H, _ld(q), _ld(memkv), D, -1, 0, 0],
           [1.0 / math.sqrt(D // H), 0.0])
    h = _rows(M, D, x)
    _gemm_tc(x, [tc_prob(cc, p["ca_out_w"], h, bias=p["ca_out_b"], R=t1,
                         row="lnf", lnw=p["ln2_w"], lnb=p["ln2_b"],
                         tile=row)])
    gd = _rows(M, Fd, x)
    _gemm_tc(x, [tc_prob(h, p["w1"], gd, bias=p["b1"], act=activation,
                         tile=gen)])
    out = _rows(M, D, x)
    _gemm_tc(x, [tc_prob(gd, p["w2"], out, bias=p["b2"], R=h, row="lnf",
                         lnw=p["ln3_w"], lnb=p["ln3_b"], tile=row)])
    return out


def _ss_div(ss: torch.Tensor, T: int) -> int:
    """``rownorm_f32``'s ss_div for AdaLN rows [1 or B, 2D] over T-row
    samples: the row's sample, or row 0 for all."""
    return T if ss.shape[0] > 1 else 0


def broadcast_stylize_f32(x, value, mask, ss, ln_w, ln_b, w, b, *,
                          T: int) -> torch.Tensor:
    """Kernel 7's float32 chain (``broadcast_stylize_plain``'s math): x
    [M, D] rows, T per sample; value [M / T, D]; mask [M] (fractional or
    zero: the LayerNorm of a zero row is its bias); ss [1 or M / T, 2D]."""
    h = rownorm_f32(value, ln_w, ln_b, rows=x.shape[0], src_div=T,
                    row_scale=mask, ss=ss, ss_div=_ss_div(ss, T))
    return linear_f32(h, w, b, resid=x)


def stylized_ffn_f32(x, ss, w1, b1, w2, b2, ln_w, ln_b, w3, b3, *, T: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 6's float32 chain (``stylized_ffn_plain``'s math): x [M, D]
    rows (a view), T per sample; ss [1 or M / T, 2D], a row's AdaLN row
    that of its sample r // T."""
    y = linear_f32(linear_f32(x, w1, b1, act="gelu"), w2, b2)
    h = rownorm_f32(y, ln_w, ln_b, ss=ss, ss_div=_ss_div(ss, T))
    return linear_f32(h, w3, b3, resid=x, out=out)


def md_layer_f32(x, extra, kvalid, value, ca_ss, ffn_ss, p, *, T: int,
                 E: int, H: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1's float32 chain (``md_layer_plain``'s math): x [B T, D] latent
    rows (a view), extra [B E, D] text and time rows, kvalid [B T], value
    [B, D], ca_ss / ffn_ss [1 or B, 2D]; written into ``out`` (a view)
    where given."""
    BT, D = x.shape
    B = BT // T
    qkv = linear_f32(x, p["sa_in_w"], p["sa_in_b"])
    ekv = linear_f32(extra, p["sa_in_w"][D:], p["sa_in_b"][D:])
    ctx = attention_f32(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], kvalid,
                        B=B, Sq=T, n1=T, H=H, k2=ekv[:, :D], v2=ekv[:, D:],
                        n2=E)
    r = linear_f32(ctx, p["sa_out_w"], p["sa_out_b"], resid=x)
    x2 = postnorm_ffn_f32(r, p, activation="relu")
    x3 = broadcast_stylize_f32(x2, value, kvalid, ca_ss, p["ca_ln_w"],
                               p["ca_ln_b"], p["ca_w"], p["ca_b"], T=T)
    return stylized_ffn_f32(x3, ffn_ss, p["fw1"], p["fb1"], p["fw2"],
                            p["fb2"], p["f_ln_w"], p["f_ln_b"], p["fp_w"],
                            p["fp_b"], T=T, out=out)


def md_stack_f32(x, extra, kvalid, values, ca_ss, ffn_ss, stacked, *,
                 T: int, E: int, H: int) -> torch.Tensor:
    """Kernel 11's float32 chain (``md_stack_plain``'s math): x [B T, D];
    extra [B E, D]; kvalid [B T]; values [L, B, D]; ca_ss / ffn_ss [L, 2D],
    one row a layer shared by every sample; stacked: ``stack_md_params``.

    Output block j's skip Linear reads [x, skip] from one buffer [B T, 2D]:
    the layer before it writes the left half, the input block whose output
    it pops (nb - 1 - j) the right half, so each Linear is one GEMM over
    the concatenation and no copy is made."""
    BT, D = x.shape
    L = values.shape[0]
    nb = (L - 1) // 2
    cat = torch.empty(nb, BT, 2 * D, dtype=torch.float32, device=x.device)
    for l in range(L):
        if l > nb:
            j = l - nb - 1
            x = linear_f32(cat[j], stacked["lin_w"][j], stacked["lin_b"][j])
        dst = (cat[nb - 1 - l][:, D:] if l < nb
               else cat[l - nb][:, :D] if l < L - 1 else None)
        x = md_layer_f32(x, extra, kvalid, values[l], ca_ss[l:l + 1],
                         ffn_ss[l:l + 1],
                         {k: v[l] for k, v in stacked.items()
                          if k not in _STACK_ONLY}, T=T, E=E, H=H, out=dst)
    return rownorm_f32(x, stacked["norm_w"], stacked["norm_b"])
