"""Length/mask helpers (counterpart of ``ladiff_tpu/utils/masks.py``)."""
from __future__ import annotations

import torch

__all__ = ["lengths_to_mask", "active_latent_count", "latent_valid_mask"]


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int -> [B, max_len] bool; True for frames < length."""
    idx = torch.arange(max_len, device=lengths.device)[None, :]
    return idx < lengths[:, None]


def active_latent_count(lengths: torch.Tensor, frame_per_latent: int,
                        max_it: int) -> torch.Tensor:
    """n_active = ceil(length / FRAME_PER_LATENT), clipped to [0, max_it]."""
    n = -torch.div(-lengths, frame_per_latent, rounding_mode="floor")
    return n.clamp(0, max_it)


def latent_valid_mask(lengths: torch.Tensor, frame_per_latent: int,
                      max_it: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_it] bool latent-row validity."""
    n = active_latent_count(lengths, frame_per_latent, max_it)
    idx = torch.arange(max_it, device=lengths.device)[None, :]
    return idx < n[:, None]
