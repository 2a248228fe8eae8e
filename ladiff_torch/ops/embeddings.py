"""Positional and timestep embeddings (counterpart of
``ladiff_tpu/ops/embeddings.py``).  Batch-first [B, S, D]."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

__all__ = [
    "sinusoidal_position_table",
    "PositionEmbeddingLearned1D",
    "PositionEmbeddingSine1D",
    "timestep_embedding",
    "TimestepEmbedding",
]


def sinusoidal_position_table(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] sine/cosine table."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionEmbeddingSine1D(nn.Module):
    """Additive fixed sine PE over the sequence axis."""

    def __init__(self, d_model: int, max_len: int = 500):
        super().__init__()
        table = torch.from_numpy(sinusoidal_position_table(max_len, d_model))
        self.register_buffer("pe", table[:, None, :], persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[: x.shape[1], 0].to(x.dtype)[None]


class PositionEmbeddingLearned1D(nn.Module):
    """Additive learned PE; ``pe`` keeps the reference shape [max_len, 1, D]
    (init U[0, 1))."""

    def __init__(self, d_model: int, max_len: int = 500):
        super().__init__()
        self.pe = nn.Parameter(torch.rand(max_len, 1, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[: x.shape[1], 0].to(x.dtype)[None]


def timestep_embedding(timesteps: torch.Tensor, embedding_dim: int, *,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       scale: float = 1.0,
                       max_period: int = 10000) -> torch.Tensor:
    """diffusers ``get_timestep_embedding``: [N] -> [N, embedding_dim] f32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Linear-SiLU-Linear MLP over the sinusoidal embedding, computed in the
    input's type whatever type the parameters have."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        F = torch.nn.functional
        dt = sample.dtype
        h = F.silu(F.linear(sample, self.linear_1.weight.to(dt),
                            self.linear_1.bias.to(dt)))
        return F.linear(h, self.linear_2.weight.to(dt),
                        self.linear_2.bias.to(dt))
