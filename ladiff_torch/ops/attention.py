"""Masked multi-head attention (counterpart of ``ladiff_tpu/ops/attention.py``).

Batch-first [B, S, D] tensors; padding is a boolean key-validity mask
(True = attend), masked logits are set to ``NEG_INF``.  ``masked_attention``
sends frame-length self-attention of a shape kernel 10 takes to it
(``ops/attention_kernel.py``) and keeps the plain version for the rest.
q/k/v share one fused input projection in the
``torch.nn.MultiheadAttention`` layout (``in_proj_weight`` [3D, D],
``in_proj_bias`` [3D], ``out_proj``), so the
reference checkpoints load as they are.

Parameters may be stored in another float type than the activations (the
trainer keeps float32 parameters and computes in bf16): every product casts
its weight to the input's type, a no-op when the two agree.  In training the
probabilities take dropout from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.attention_kernel import (MIN_SEQ,
                                               fused_masked_attention,
                                               masked_attention_plain,
                                               masked_attention_supported)
from ladiff_torch.ops.cuda_common import kernel_route

__all__ = ["MultiHeadAttention", "masked_attention"]


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_valid: Optional[torch.Tensor] = None, *,
                     num_heads: int, dropout_rate: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     return_weights: bool = False):
    """q [B, Sq, D], k/v [B, Sk, D] (projected); key_valid [B, Sk] bool.
    ``dropout_rate`` > 0 drops probabilities (scaled by 1 / keep) with a
    mask drawn from ``generator``.  Returns [B, Sq, D]; with
    ``return_weights`` also the head-averaged probabilities [B, Sq, Sk],
    which only the plain version gives.

    Self-attention over at least ``MIN_SEQ`` tokens without dropout, in bf16
    or float32 (``kernel_route``), of a shape kernel 10 takes
    (``masked_attention_supported``), and with no gradient required
    (kernel 10 has no backward), goes through
    ``fused_masked_attention`` (kernel 10 on CUDA tensors); everything else
    (the denoiser's 7-key stream, cross-attention into the few memory rows,
    any dropout, a head width above 128, a training layer's plain
    attention) is the plain version."""
    B, S, D = q.shape
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if (S == k.shape[1] >= MIN_SEQ and dropout_rate == 0.0
            and not needs_grad and not return_weights
            and kernel_route(q, "fused_masked_attention")
            and masked_attention_supported(B, S, D, num_heads)):
        return fused_masked_attention(q, k, v, key_valid,
                                      num_heads=num_heads)
    return masked_attention_plain(q, k, v, key_valid, num_heads=num_heads,
                                  dropout_rate=dropout_rate,
                                  generator=generator,
                                  return_weights=return_weights)


class MultiHeadAttention(nn.Module):
    """Batch-first equivalent of ``torch.nn.MultiheadAttention`` (same
    parameter names); ``dropout`` acts on the probabilities in training
    mode only."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                return_weights: bool = False, plain: bool = False):
        """Returns [B, Sq, D]; with ``return_weights`` also the
        head-averaged probabilities [B, Sq, Sk] (``masked_attention``;
        ``plain`` takes its plain version whatever the shape: a pre-norm
        layer's route)."""
        D = self.d_model
        dt = query.dtype
        w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        q = F.linear(query, w[:D], b[:D])
        k = F.linear(key.to(dt), w[D:2 * D], b[D:2 * D])
        v = F.linear(value.to(dt), w[2 * D:], b[2 * D:])
        attend = masked_attention_plain if plain else masked_attention
        out = attend(
            q, k, v, key_valid, num_heads=self.num_heads,
            dropout_rate=self.dropout if self.training else 0.0,
            generator=generator, return_weights=return_weights)
        if return_weights:
            out, weights = out
        out = F.linear(out, self.out_proj.weight.to(dt),
                       self.out_proj.bias.to(dt))
        return (out, weights) if return_weights else out

    def kernel_params(self) -> dict:
        """The module's tensors by the names ``train_self_attention``
        takes."""
        return {"in_w": self.in_proj_weight, "in_b": self.in_proj_bias,
                "out_w": self.out_proj.weight, "out_b": self.out_proj.bias}
