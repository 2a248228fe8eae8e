"""LA-VAE (counterpart of ``ladiff_tpu/models/vae.py``).

This slice ports ``decode``: zero frame queries plus the learned
``query_pos_decoder`` cross-attend to the latent memory through the skip
decoder, under the frame mask and the ``ceil(len / FRAME_PER_LATENT)``
latent mask; ``final_layer`` maps to features and padded frames are zeroed.
The encoder's modules are built so that a full reference checkpoint loads
with ``strict=True``; ``encode`` comes with the training slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ladiff_torch.ops.embeddings import PositionEmbeddingLearned1D
from ladiff_torch.ops.transformer import (SkipTransformerDecoder,
                                          SkipTransformerEncoder)
from ladiff_torch.utils.masks import latent_valid_mask, lengths_to_mask

__all__ = ["LAVae"]


class LAVae(nn.Module):
    def __init__(self, nfeats: int, latent_dim: Sequence[int] = (7, 256),
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, max_it: int = 5,
                 frame_per_latent: int = 48, activation: str = "gelu"):
        super().__init__()
        D = int(latent_dim[-1])
        self.frame_per_latent = frame_per_latent
        self.skel_embedding = nn.Linear(nfeats, D)
        self.final_layer = nn.Linear(D, nfeats)
        self.global_motion_token = nn.Parameter(torch.randn(2 * max_it, D))
        self.query_pos_encoder = PositionEmbeddingLearned1D(D)
        self.query_pos_decoder = PositionEmbeddingLearned1D(D)
        self.encoder = SkipTransformerEncoder(D, num_heads, num_layers,
                                              ff_size, activation)
        self.decoder = SkipTransformerDecoder(D, num_heads, num_layers,
                                              ff_size, activation)

    def decode(self, z: torch.Tensor, lengths: torch.Tensor, nframes: int,
               latent_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents [B, max_it, D] -> features [B, nframes, nfeats]."""
        B, _, D = z.shape
        dtype = self.final_layer.weight.dtype
        frame_valid = lengths_to_mask(lengths, nframes)
        if latent_valid is None:
            latent_valid = latent_valid_mask(lengths, self.frame_per_latent,
                                             z.shape[1])
        queries = self.query_pos_decoder(
            torch.zeros(B, nframes, D, dtype=dtype, device=z.device))
        out = self.decoder(queries, z.to(dtype), tgt_key_valid=frame_valid,
                           memory_key_valid=latent_valid)
        feats = self.final_layer(out)
        return torch.where(frame_valid[:, :, None], feats,
                           torch.zeros((), dtype=feats.dtype,
                                       device=feats.device))
