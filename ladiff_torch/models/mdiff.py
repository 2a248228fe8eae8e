"""MotionDiffuse: the per-frame text-to-motion diffusion transformer
(counterpart of ``ladiff_tpu/models/mdiff.py``).

``MotionTransformer`` embeds frames (``joint_embed`` + a learned
``sequence_embedding``), encodes the text tokens through ``text_pre_proj``,
``num_text_layers`` post-norm encoder layers and ``text_ln`` (``encode_text``),
adds the EOT token's ``text_proj`` to the time embedding, and runs
``num_layers`` decoder layers, each self-attention, cross-attention into
the text tokens and a stylized FFN, all three with AdaLN output
projections (``ops/stylization.py`` ``StylizationBlock``).  Two flavours:
``no_eff`` runs quadratic attention (``TemporalDecoderLayer``), the default
the softmax-linear blocks (``LinearTemporalDecoderLayer``).

Parameter names are the reference torch MotionTransformer's
(``temporal_decoder_blocks.{i}.{sa_block,ca_block,ffn}``,
``textTransEncoder.layers.{i}``, ``text_proj.0``, ``time_embed.{0,2}``), so
its state dict (without the frozen ``clip.*`` keys) loads as it is.  The
reference quirks stay: ``TemporalSelfAttention`` adds its -1e5 mask along
the query axis; the linear self-attention adds -1e6 to invalid keys and
zeroes their values, with queries softmaxed over features and keys over
time; ``out`` and each ``StylizationBlock``'s last linear start at zero.

Kernels: in bf16 at inference the text layers' self-attention over 77
tokens is kernel 10 (d 256, 4 heads); their FFN tails (F 2048) and every
D-512 block (including ``StylizedFFN``, past kernel 6's gate) are plain.
Dropout draws come from the ``generator`` passed to ``forward``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.embeddings import timestep_embedding
from ladiff_torch.ops.stylization import (LinearTemporalCrossAttention,
                                          StylizationBlock, StylizedFFN)
from ladiff_torch.ops.transformer import TransformerEncoderLayer, _drop
from ladiff_torch.utils.device import resolve_device
from ladiff_torch.utils.masks import lengths_to_mask

__all__ = ["LinearTemporalSelfAttention", "TemporalSelfAttention",
           "TemporalCrossAttention", "TemporalDecoderLayer",
           "LinearTemporalDecoderLayer", "MotionTransformer"]


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``einsum`` accumulated in float32, rounded to ``dtype`` (the JAX
    package's ``preferred_element_type=float32``)."""
    return torch.einsum(eq, a.float(), b.float()).to(dtype)


class _QKV(nn.Module):
    """``norm`` and the ``query`` / ``key`` / ``value`` projections and the
    stylized ``proj_out`` that the three attention blocks share."""

    def __init__(self, latent_dim: int, num_heads: int, emb_dim: int,
                 dropout: float, kv_dim: Optional[int] = None):
        super().__init__()
        D = latent_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.norm = nn.LayerNorm(D, eps=1e-5)
        self.query = nn.Linear(D, D)
        self.key = nn.Linear(kv_dim or D, D)
        self.value = nn.Linear(kv_dim or D, D)
        self.proj_out = StylizationBlock(D, emb_dim, dropout)


class LinearTemporalSelfAttention(_QKV):
    """Softmax-linear self-attention with frame masking: two small products
    in place of a T x T map."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                frame_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        xn = self.norm(x)
        query, key, value = self.query(xn), self.key(xn), self.value(xn)
        if frame_valid is not None:
            fv = frame_valid[:, :, None].to(key.dtype)
            key = key + (1.0 - fv) * -1000000.0
            value = value * fv
        query = torch.softmax(query.reshape(B, T, H, -1), dim=-1)
        key = torch.softmax(key.reshape(B, T, H, -1), dim=1)
        att = _f32_einsum("bnhd,bnhl->bhdl", key, value.reshape(B, T, H, -1),
                          x.dtype)
        y = _f32_einsum("bnhd,bhdl->bnhl", query, att, x.dtype)
        return x + self.proj_out(y.reshape(B, T, D), emb, generator)


def _softmax_attend(block: _QKV, q, k, v, bias, generator) -> torch.Tensor:
    """Quadratic attention of [B, T, D] queries over [B, N, D] keys, the
    logits in float32 (plus ``bias`` where given), dropout on the weights
    in training mode."""
    B, T, D = q.shape
    H = block.num_heads
    logits = _f32_einsum("bnhd,bmhd->bnmh", q.reshape(B, T, H, -1),
                         k.reshape(B, k.shape[1], H, -1),
                         torch.float32) / math.sqrt(D // H)
    if bias is not None:
        logits = logits + bias
    weight = torch.softmax(logits, dim=2).to(q.dtype)
    weight = _drop(weight, block.dropout if block.training else 0.0,
                   generator)
    y = _f32_einsum("bnmh,bmhd->bnhd", weight,
                    v.reshape(B, v.shape[1], H, -1), q.dtype)
    return y.reshape(B, T, D)


class TemporalSelfAttention(_QKV):
    """Quadratic self-attention with a stylized output projection.  The mask
    is the reference's: ``(1 - valid) * -1e5`` added along the query axis
    (constant over the keys)."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                frame_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        xn = self.norm(x)
        bias = (None if frame_valid is None else
                (1.0 - frame_valid[:, :, None, None].float()) * -100000.0)
        y = _softmax_attend(self, self.query(xn), self.key(xn),
                            self.value(xn), bias, generator)
        return x + self.proj_out(y, emb, generator)


class TemporalCrossAttention(_QKV):
    """Quadratic attention of the frames into the text tokens."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 emb_dim: int, dropout: float = 0.1):
        super().__init__(latent_dim, num_heads, emb_dim, dropout,
                         kv_dim=text_latent_dim)
        self.text_norm = nn.LayerNorm(text_latent_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        xn, tn = self.norm(x), self.text_norm(xf)
        y = _softmax_attend(self, self.query(xn), self.key(tn),
                            self.value(tn), None, generator)
        return x + self.proj_out(y, emb, generator)


class _DecoderLayer(nn.Module):
    """sa_block, ca_block, ffn: the two flavours differ in their blocks."""

    def forward(self, x, xf, emb, frame_valid=None, generator=None):
        x = self.sa_block(x, emb, frame_valid, generator)
        x = self.ca_block(x, xf, emb, generator=generator)
        return self.ffn(x, emb, generator)


class TemporalDecoderLayer(_DecoderLayer):
    """``no_eff``: quadratic self- and cross-attention, stylized FFN."""

    def __init__(self, latent_dim: int, text_latent_dim: int, emb_dim: int,
                 ffn_dim: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.sa_block = TemporalSelfAttention(latent_dim, num_heads, emb_dim,
                                              dropout)
        self.ca_block = TemporalCrossAttention(latent_dim, text_latent_dim,
                                               num_heads, emb_dim, dropout)
        self.ffn = StylizedFFN(latent_dim, ffn_dim, emb_dim, dropout)


class LinearTemporalDecoderLayer(_DecoderLayer):
    """The efficient layer: softmax-linear self- and cross-attention,
    stylized FFN."""

    def __init__(self, latent_dim: int, text_latent_dim: int, emb_dim: int,
                 ffn_dim: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.sa_block = LinearTemporalSelfAttention(latent_dim, num_heads,
                                                    emb_dim, dropout)
        self.ca_block = LinearTemporalCrossAttention(
            latent_dim, text_latent_dim, num_heads, emb_dim, dropout)
        self.ffn = StylizedFFN(latent_dim, ffn_dim, emb_dim, dropout)


class _TextEncoder(nn.Module):
    """``layers``: the reference's ``nn.TransformerEncoder`` naming."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class MotionTransformer(nn.Module):
    """Per-frame denoiser: x [B, T, input_feats], timesteps [B] -> [B, T,
    input_feats].  Text comes in as frozen-CLIP token features
    ``clip_tokens`` [B, N, clip_dim] with each sample's EOT index, or
    already encoded as (``xf_proj``, ``xf_out``)."""

    def __init__(self, input_feats: int, num_frames: int = 240,
                 latent_dim: int = 512, ff_size: int = 1024,
                 num_layers: int = 8, num_heads: int = 8,
                 dropout: float = 0.0, activation: str = "gelu",
                 num_text_layers: int = 4, text_latent_dim: int = 256,
                 text_ff_size: int = 2048, text_num_heads: int = 4,
                 clip_dim: int = 512, no_eff: bool = False, device=None):
        super().__init__()
        D, E = latent_dim, 4 * latent_dim
        self.latent_dim = D
        self.sequence_embedding = nn.Parameter(torch.randn(num_frames, D))
        self.text_pre_proj = (nn.Linear(clip_dim, text_latent_dim)
                              if text_latent_dim != clip_dim
                              else nn.Identity())
        self.textTransEncoder = _TextEncoder([
            TransformerEncoderLayer(text_latent_dim, text_num_heads,
                                    text_ff_size, activation, dropout)
            for _ in range(num_text_layers)])
        self.text_ln = nn.LayerNorm(text_latent_dim, eps=1e-5)
        self.text_proj = nn.Sequential(nn.Linear(text_latent_dim, E))
        self.joint_embed = nn.Linear(input_feats, D)
        self.time_embed = nn.Sequential(nn.Linear(D, E), nn.SiLU(),
                                        nn.Linear(E, E))
        layer = TemporalDecoderLayer if no_eff else LinearTemporalDecoderLayer
        self.temporal_decoder_blocks = nn.ModuleList([
            layer(D, text_latent_dim, E, ff_size, num_heads, dropout)
            for _ in range(num_layers)])
        self.out = nn.Linear(D, input_feats)
        nn.init.zeros_(self.out.weight)
        nn.init.zeros_(self.out.bias)
        self.to(resolve_device(device))

    @property
    def dtype(self) -> torch.dtype:
        return self.joint_embed.weight.dtype

    def encode_text(self, clip_tokens: torch.Tensor, eot_idx: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frozen-CLIP token features [B, N, clip_dim] + EOT positions [B]
        -> (xf_proj [B, 4D], xf_out [B, N, text_latent_dim])."""
        x = self.text_pre_proj(clip_tokens.to(self.dtype))
        for layer in self.textTransEncoder.layers:
            x = layer(x, None, generator=generator)
        xf_out = self.text_ln(x)
        eot = xf_out[torch.arange(x.shape[0], device=x.device),
                     eot_idx.to(x.device)]
        return self.text_proj(eot), xf_out

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                xf_proj: Optional[torch.Tensor] = None,
                xf_out: Optional[torch.Tensor] = None,
                clip_tokens: Optional[torch.Tensor] = None,
                eot_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, _ = x.shape
        dtype = self.dtype
        if xf_proj is None or xf_out is None:
            xf_proj, xf_out = self.encode_text(clip_tokens, eot_idx,
                                               generator)
        t_emb = timestep_embedding(timesteps, self.latent_dim,
                                   flip_sin_to_cos=True).to(dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb))) \
            + xf_proj.to(dtype)
        h = self.joint_embed(x.to(dtype)) \
            + self.sequence_embedding[None, :T].to(dtype)
        frame_valid = (lengths_to_mask(lengths.to(x.device), T)
                       if lengths is not None else None)
        for block in self.temporal_decoder_blocks:
            h = block(h, xf_out, emb, frame_valid, generator)
        return self.out(h)
