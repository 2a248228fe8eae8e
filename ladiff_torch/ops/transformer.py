"""Post-norm transformer blocks with U-Net skip connections (counterpart of
``ladiff_tpu/ops/transformer.py``), inference paths.

Parameter names follow the reference torch LADiff (``self_attn``,
``multihead_attn``, ``linear1/2``, ``norm1/2/3``; skip stacks with
``input_blocks.i``, ``middle_block``, ``output_blocks.i``,
``linear_blocks.i``, ``norm``).  A decoder layer runs as one call of
``fused_decoder_layer`` (kernel K2 on a CUDA tensor, its plain version on a
CPU tensor).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.attention import MultiHeadAttention
from ladiff_torch.ops.decoder_layer import fused_decoder_layer

__all__ = [
    "get_activation",
    "TransformerEncoderLayer",
    "TransformerDecoderLayer",
    "SkipTransformerEncoder",
    "SkipTransformerDecoder",
]


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "relu":
        return F.relu
    if name == "gelu":
        return F.gelu  # exact (erf) GELU
    raise ValueError(f"activation should be relu/gelu, not {name}")


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer; ``extra_kv`` tokens are attended to but
    produce no outputs (same as running on ``cat([src, extra_kv])`` and
    keeping the first S rows)."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int = 2048,
                 activation: str = "relu"):
        super().__init__()
        self.activation = activation
        self.self_attn = MultiHeadAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                extra_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = src if extra_kv is None else torch.cat([src, extra_kv], dim=1)
        x2 = self.self_attn(src, kv, kv, key_valid)
        h = self.norm1(src + x2)
        act = get_activation(self.activation)
        return self.norm2(h + self.linear2(act(self.linear1(h))))


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention over the queries,
    cross-attention into the memory, FFN."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int = 2048,
                 activation: str = "relu"):
        super().__init__()
        self.num_heads = num_heads
        self.activation = activation
        self.self_attn = MultiHeadAttention(d_model, num_heads)
        self.multihead_attn = MultiHeadAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def kernel_params(self) -> dict:
        """The layer's tensors by the names ``fused_decoder_layer`` takes."""
        sa, ca = self.self_attn, self.multihead_attn
        return {
            "sa_in_w": sa.in_proj_weight, "sa_in_b": sa.in_proj_bias,
            "sa_out_w": sa.out_proj.weight, "sa_out_b": sa.out_proj.bias,
            "ln1_w": self.norm1.weight, "ln1_b": self.norm1.bias,
            "ca_in_w": ca.in_proj_weight, "ca_in_b": ca.in_proj_bias,
            "ca_out_w": ca.out_proj.weight, "ca_out_b": ca.out_proj.bias,
            "ln2_w": self.norm2.weight, "ln2_b": self.norm2.bias,
            "w1": self.linear1.weight, "b1": self.linear1.bias,
            "w2": self.linear2.weight, "b2": self.linear2.bias,
            "ln3_w": self.norm3.weight, "ln3_b": self.norm3.bias,
        }

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_key_valid: Optional[torch.Tensor] = None,
                memory_key_valid: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        B, T, D = tgt.shape
        L = memory.shape[1]
        kv = (tgt_key_valid if tgt_key_valid is not None
              else torch.ones(B, T, dtype=torch.bool, device=tgt.device))
        mv = (memory_key_valid if memory_key_valid is not None
              else torch.ones(B, L, dtype=torch.bool, device=tgt.device))
        out = fused_decoder_layer(
            tgt.reshape(B * T, D).contiguous(),
            kv.reshape(B * T).float().contiguous(),
            memory.to(tgt.dtype).contiguous(), mv.float().contiguous(),
            self.kernel_params(), T=T, H=self.num_heads,
            activation=self.activation)
        return out.reshape(B, T, D)


class _SkipStack(nn.Module):
    """U-Net wiring: (L-1)/2 input blocks, a middle block, (L-1)/2 output
    blocks fed through Linear(2D -> D) skip fusion, final LayerNorm."""

    def __init__(self, make_layer, d_model: int, num_layers: int):
        super().__init__()
        assert num_layers % 2 == 1, "skip stack needs an odd layer count"
        nb = (num_layers - 1) // 2
        self.input_blocks = nn.ModuleList([make_layer() for _ in range(nb)])
        self.middle_block = make_layer()
        self.output_blocks = nn.ModuleList([make_layer() for _ in range(nb)])
        self.linear_blocks = nn.ModuleList(
            [nn.Linear(2 * d_model, d_model) for _ in range(nb)])
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def ordered_blocks(self):
        """The layers in execution order."""
        return [*self.input_blocks, self.middle_block, *self.output_blocks]

    def run(self, x: torch.Tensor, block_fn) -> torch.Tensor:
        """``block_fn(i, block, x)`` runs the i-th layer in execution
        order."""
        nb = len(self.input_blocks)
        xs = []
        for i, block in enumerate(self.ordered_blocks()):
            if i > nb:
                x = self.linear_blocks[i - nb - 1](
                    torch.cat([x, xs.pop()], dim=-1))
            x = block_fn(i, block, x)
            if i < nb:
                xs.append(x)
        return self.norm(x)


class SkipTransformerEncoder(_SkipStack):
    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 ff_size: int = 1024, activation: str = "gelu"):
        super().__init__(
            lambda: TransformerEncoderLayer(d_model, num_heads, ff_size,
                                            activation),
            d_model, num_layers)

    def forward(self, src: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.run(src, lambda i, block, x: block(x, key_valid))


class SkipTransformerDecoder(_SkipStack):
    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 ff_size: int = 1024, activation: str = "gelu"):
        super().__init__(
            lambda: TransformerDecoderLayer(d_model, num_heads, ff_size,
                                            activation),
            d_model, num_layers)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_key_valid: Optional[torch.Tensor] = None,
                memory_key_valid: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return self.run(tgt, lambda i, block, x: block(
            x, memory, tgt_key_valid, memory_key_valid))
