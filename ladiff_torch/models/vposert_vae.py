"""VPoser-style MLP VAE over whole clips, the reference's
``vae_type: "vposert"`` branch (counterpart of
``ladiff_tpu/models/vposert_vae.py``).

[B, 196, 263] is flattened, BatchNorm'd and run through a 512-wide MLP to a
Normal(mu, softplus(logvar)); an MLP decodes [1, B, latent] back to
[B, 196, 263].  The BatchNorms always use their running averages (the JAX
module's ``use_running_average=True``), in training mode too, so they are
``F.batch_norm(..., training=False)`` and their buffers never move.
Dropout (after the encoder's second BatchNorm and the decoder's first
layer) acts in training mode with draws from an explicit generator.

Parameter names are the reference's ``nn.Sequential`` slots
(``encoder_net.{1,4}`` BatchNorms with their running statistics,
``encoder_net.{2,6,7}``, ``encoder_net.8.mu`` / ``.logvar``,
``decoder_net.{0,3,5}``), so its state dict loads as it is.  Plain PyTorch
on every device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.transformer import _drop
from ladiff_torch.utils.device import resolve_device

__all__ = ["VPosert"]


class _NormalDistDecoder(nn.Module):
    def __init__(self, num_neurons: int, latent_dim: int):
        super().__init__()
        self.mu = nn.Linear(num_neurons, latent_dim)
        self.logvar = nn.Linear(num_neurons, latent_dim)


def _frozen_bn(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=bn.eps)


class VPosert(nn.Module):
    def __init__(self, frames: int = 196, nfeats: int = 263,
                 num_neurons: int = 512, latent_dim: int = 256,
                 dropout: float = 0.1, device=None):
        super().__init__()
        N, n_in = num_neurons, frames * nfeats
        self.frames, self.nfeats, self.dropout = frames, nfeats, dropout
        self.encoder_net = nn.Sequential(
            nn.Flatten(), nn.BatchNorm1d(n_in), nn.Linear(n_in, N),
            nn.LeakyReLU(), nn.BatchNorm1d(N), nn.Dropout(dropout),
            nn.Linear(N, N), nn.Linear(N, N),
            _NormalDistDecoder(N, latent_dim))
        self.decoder_net = nn.Sequential(
            nn.Linear(latent_dim, N), nn.LeakyReLU(), nn.Dropout(dropout),
            nn.Linear(N, N), nn.LeakyReLU(), nn.Linear(N, n_in))
        self.to(resolve_device(device))

    def _rate(self) -> float:
        return self.dropout if self.training else 0.0

    def dist_params(self, features: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, frames, nfeats] (or [B, frames * nfeats]) -> (mu, scale),
        scale = softplus(logvar head)."""
        e = self.encoder_net
        x = features.reshape(features.shape[0], -1).to(e[2].weight.dtype)
        x = F.leaky_relu(e[2](_frozen_bn(e[1], x)), 0.01)
        x = _drop(_frozen_bn(e[4], x), self._rate(), generator)
        x = e[7](e[6](x))
        return e[8].mu(x), F.softplus(e[8].logvar(x))

    def encode(self, features: torch.Tensor,
               lengths: Optional[torch.Tensor] = None, *,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None, sample_mean: bool = False
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """(z [1, B, latent], (mu, scale)): the mean where ``sample_mean`` or
        where neither a generator nor ``eps`` is given, else mu + scale eps
        (``eps`` [B, latent] drawn from ``generator`` when None).  Lengths
        are accepted and unused: the clip length is in the flatten."""
        mu, scale = self.dist_params(features, generator)
        if sample_mean or (generator is None and eps is None):
            z = mu
        else:
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator,
                                  device=mu.device, dtype=mu.dtype)
            z = mu + scale * eps.to(device=mu.device, dtype=mu.dtype)
        return z[None], (mu, scale)

    def decode(self, z: torch.Tensor, lengths: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[1, B, latent] -> [B, frames, nfeats]."""
        d = self.decoder_net
        x = F.leaky_relu(d[0](z[0].to(d[0].weight.dtype)), 0.01)
        x = F.leaky_relu(d[3](_drop(x, self._rate(), generator)), 0.01)
        return d[5](x).reshape(-1, self.frames, self.nfeats)

    def forward(self, features: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """(feats_rst, z, (mu, scale))."""
        z, dist = self.encode(features, lengths, generator=generator,
                              eps=eps)
        return self.decode(z, lengths, generator), z, dist
