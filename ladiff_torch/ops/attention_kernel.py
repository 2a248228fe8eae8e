"""Kernel 10: masked multi-head self-attention of projected q, k, v, the
attention of every inference encoder layer over a frame-length stream.
Replaces ``ladiff_tpu/ops/pallas_attention.py`` ``pallas_masked_attention``
(:52, ``pl.pallas_call`` at :82).

    per sample and head:  logits = (q * Dh^-0.5) k^T          [S, S], f32
                          logits += -1e9 on keys with key_valid false
                          out    = softmax(logits) v

What bounds it on the H100: at the frozen encode's shape (128 samples x 206
tokens, D 256, 4 heads) q, k, v and the output are ~54 MB against at most
5.6 GFLOP, under 110 FLOP per byte and so below the 295 FLOP/byte ridge:
memory bounds it, near 0.016 ms.  The TPU kernel pads the head width to 128
lanes and holds a whole [S, S] logit block per program; neither suits the
card.  The CUDA version (``csrc/masked_attention.cu``, body in
``csrc/attn_tile.cuh`` over ``csrc/flash_tile.cuh``, shared with K2's
self-attention) is a register-resident FlashAttention-2 tile: one block of
4 warps per (sample, head, 64-query tile), each warp's 16 query rows held
as mma.sync A-fragments for the whole key loop; k and v tiles come through
a two-stage cp.async ring (16-byte vectors), so the next tile's load
overlaps this one's products; S = q k^T and O accumulate in mma.sync
m16n8k16 registers, the online softmax runs on them with quad shuffles and
exp2 (scale and log2 e folded in), P turns into bf16 A-fragments in
registers and O is written once.  Shared memory is the ring alone (~36 KB
at head width 64), so several blocks share an SM.  Keys past S do not
exist; a masked key's probability is exactly 0 once a valid key sets the
row maximum, so a 64-key tile without a valid key is skipped, decided per
key from ``key_valid`` (the encoder stream's valid keys are not a prefix);
a sample without a valid key attends uniformly over its S keys, as the JAX
package's -1e9 gives.  Padded query rows are computed, as in the JAX
package.

It has no backward: called on CUDA tensors while a gradient is required it
raises; layers that need a gradient take ``train_self_attention``.

In float32 (the published configurations' type) the wrapper launches
kernel 10's float32 counterpart, ``f32_layer.masked_attention_f32``
(``attn_inf_tc`` of ``csrc/f32_tc_tile.cuh`` through
``csrc/f32_train_layer.cu``: flash tiles on the tensor cores in
three-term TF32, each key tile's K and V split once into shared-memory
planes in fragment order; up to head width 64 blocks of 4 warps hold
their 64 queries' split Q fragments in registers, wider heads blocks of
8 warps their 128 raw Q rows; key tiles without a valid key skipped, an
online softmax in float32), at every shape ``masked_attention_supported``
takes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ladiff_torch.ops.cuda_common import (NEG_INF, check_cuda_args,
                                          dropout_mask, launch,
                                          register_kernel, require_no_grad)
from ladiff_torch.ops.f32_layer import masked_attention_f32

__all__ = ["fused_masked_attention", "masked_attention_plain",
           "masked_attention_supported", "MIN_SEQ"]

MIN_SEQ = 64  # shorter streams keep the plain attention (one partial tile)


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_valid: Optional[torch.Tensor] = None, *,
                           num_heads: int, dropout_rate: float = 0.0,
                           generator: Optional[torch.Generator] = None,
                           return_weights: bool = False):
    """Plain PyTorch version.  q [B, Sq, D], k/v [B, Sk, D] (projected);
    key_valid [B, Sk] bool.  ``dropout_rate`` > 0 drops probabilities
    (scaled by 1 / keep) with a mask drawn from ``generator``.  Returns
    [B, Sq, D]; with ``return_weights`` also the probabilities averaged
    over the heads [B, Sq, Sk] (after dropout, in q's type; a masked key's
    weight is 0 wherever the row has a valid key)."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    H = num_heads
    Dh = D // H
    qh = q.reshape(B, Sq, H, Dh).transpose(1, 2)
    kh = k.reshape(B, Sk, H, Dh).transpose(1, 2)
    vh = v.reshape(B, Sk, H, Dh).transpose(1, 2)
    logits = torch.matmul(qh * (1.0 / math.sqrt(Dh)), kh.transpose(-1, -2))
    logits = logits.float()
    if key_valid is not None:
        logits = logits.masked_fill(~key_valid[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_rate > 0.0:
        w = w * dropout_mask(w.shape, dropout_rate, w, generator)
    out = torch.matmul(w, vh).transpose(1, 2).reshape(B, Sq, D)
    if return_weights:
        return out, w.mean(dim=1)
    return out


def masked_attention_supported(B: int, S: int, D: int, H: int) -> bool:
    """Whether kernel 10 takes B samples of S tokens, width D, H heads: a
    head width that is a multiple of 16 up to 128 (the attention tile's),
    at most 65535 samples (the grid's)."""
    return (H >= 1 and D % H == 0 and (D // H) % 16 == 0 and D // H <= 128
            and S >= 1 and 1 <= B <= 65535)


@register_kernel("fused_masked_attention")
def fused_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_valid: Optional[torch.Tensor] = None, *,
                           num_heads: int) -> torch.Tensor:
    """Kernel 10 on CUDA tensors (bf16, or float32 through its float32
    counterpart), its plain version on CPU tensors.
    q, k, v [B, S, D]; key_valid [B, S] bool or None.  Returns [B, S, D]."""
    if not q.is_cuda:
        return masked_attention_plain(q, k, v, key_valid, num_heads=num_heads)
    require_no_grad("fused_masked_attention", [q, k, v])
    B, S, D = q.shape
    H = num_heads
    if (k.shape != q.shape or v.shape != q.shape
            or not masked_attention_supported(B, S, D, H)
            or (key_valid is not None and key_valid.shape != (B, S))):
        raise ValueError(
            f"fused_masked_attention: unsupported shapes q={tuple(q.shape)} "
            f"k={tuple(k.shape)} v={tuple(v.shape)} H={H} key_valid="
            f"{None if key_valid is None else tuple(key_valid.shape)}")
    tensors = {"q": q, "k": k, "v": v}
    kv_ptr = 0
    if key_valid is not None:
        kvalid = key_valid.to(torch.float32).contiguous()
        tensors["key_valid"] = kvalid
        kv_ptr = kvalid.data_ptr()
    check_cuda_args("fused_masked_attention", tensors, f32=("key_valid",))
    if q.dtype == torch.float32:
        out = masked_attention_f32(q, k, v, tensors.get("key_valid"), H=H)
        fused_masked_attention.launches += 1
        return out
    out = torch.empty_like(q)
    launch("masked_attention", "masked_attention_forward", q.device,
           [q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_ptr,
            out.data_ptr()], [B, S, D, H])
    fused_masked_attention.launches += 1
    return out
