"""The deterministic conv "VAE" over T2M-GPT's conv stacks (counterpart of
``ladiff_tpu/models/mld_vae_t2m.py``).

No distribution: ``encode`` is ``models/vq.py``'s strided-conv
``Encoder1D``, ``decode`` its nearest-upsample ``Decoder1D``, with MLD's
``[L, B, 512]`` latent layout between them and None where a distribution
would be.  Parameter names are the reference MldVae's (``encoder.model.N``
/ ``decoder.model.N``), so its state dict loads as it is.  Plain PyTorch on
every device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ladiff_torch.models.vq import Decoder1D, Encoder1D
from ladiff_torch.utils.device import resolve_device

__all__ = ["MldVaeT2m"]


class MldVaeT2m(nn.Module):
    """``latent_dim`` is accepted and unused, as in the reference, which
    builds only the conv stacks."""

    def __init__(self, nfeats: int, latent_dim: Sequence[int] = (1, 256),
                 down_t: int = 3, device=None):
        super().__init__()
        self.encoder = Encoder1D(nfeats, down_t=down_t)
        self.decoder = Decoder1D(out_feats=nfeats, down_t=down_t)
        self.to(resolve_device(device))

    def encode(self, features: torch.Tensor,
               lengths: Optional[List[int]] = None
               ) -> Tuple[torch.Tensor, None]:
        """[B, T, nfeats] -> ([T / 2^down_t, B, 512], None)."""
        w = self.encoder.model[0].weight
        z = self.encoder(features.to(w.dtype).transpose(1, 2))
        return z.permute(2, 0, 1), None

    def decode(self, z: torch.Tensor,
               lengths: Optional[List[int]] = None) -> torch.Tensor:
        """[L, B, 512] -> [B, L * 2^down_t, nfeats]."""
        w = self.decoder.model[0].weight
        return self.decoder(z.to(w.dtype).permute(1, 2, 0)).transpose(1, 2)

    def forward(self, features: torch.Tensor,
                lengths: Optional[List[int]] = None):
        z, dist = self.encode(features, lengths)
        return self.decode(z, lengths), z, dist
