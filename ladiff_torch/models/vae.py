"""LA-VAE (counterpart of ``ladiff_tpu/models/vae.py``).

``encode``: ``2 * max_it`` learned distribution tokens are prepended to the
embedded frames, the learned ``query_pos_encoder`` is added over the whole
stream, and the skip encoder runs under the frame mask and the
``ceil(len / FRAME_PER_LATENT)`` mask on both token halves; the first
``max_it`` output tokens are ``mu``, the next ``logvar``; the reparameterised
sample has its inactive rows zeroed.  ``decode``: zero frame queries plus
the learned ``query_pos_decoder`` cross-attend to the latent memory through
the skip decoder; ``final_layer`` maps to features and padded frames are
zeroed.  ``add_noise`` is the DVAE input corruption.

Training mode is ``module.training`` (dropout; the layers then run through
the training kernels: kernels 8 and 9 per layer, or with
``train_whole_layer`` kernel 12 for the encoder's layers and kernel 13 for
the decoder's).  Random draws come from an explicit
``torch.Generator`` on the tensors' device; ``encode`` also takes the
Gaussian ``eps`` as a tensor.
``compute_dtype`` (set by ``LADiffSystem``) is the activations' type where
it differs from the parameters' (float32 parameters, bf16 compute).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ladiff_torch.ops.embeddings import PositionEmbeddingLearned1D
from ladiff_torch.ops.transformer import (SkipTransformerDecoder,
                                          SkipTransformerEncoder, linear)
from ladiff_torch.utils.masks import latent_valid_mask, lengths_to_mask

__all__ = ["LAVae", "WHOLE_LAYER_OPTIONS"]


def _randn(shape, generator, device, dtype):
    return torch.randn(shape, generator=generator, device=device).to(dtype)


# which skip stacks run their training layers as one whole-layer kernel
# (kernel 12 the encoder's, kernel 13 the decoder's): the values of the JAX
# package's LADIFF_TRAIN_WHOLE_LAYER
WHOLE_LAYER_OPTIONS = ("0", "1", "enc", "dec")


class LAVae(nn.Module):
    def __init__(self, nfeats: int, latent_dim: Sequence[int] = (7, 256),
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, max_it: int = 5,
                 frame_per_latent: int = 48, activation: str = "gelu",
                 dropout: float = 0.0, dvae: bool = False,
                 percentage_noised: float = 0.0,
                 train_whole_layer: str = "0"):
        super().__init__()
        D = int(latent_dim[-1])
        if train_whole_layer not in WHOLE_LAYER_OPTIONS:
            raise ValueError(
                f"train_whole_layer should be one of {WHOLE_LAYER_OPTIONS}, "
                f"not {train_whole_layer!r}")
        self.max_it = max_it
        self.frame_per_latent = frame_per_latent
        self.dvae = dvae
        self.percentage_noised = percentage_noised
        self.compute_dtype: Optional[torch.dtype] = None
        self.skel_embedding = nn.Linear(nfeats, D)
        self.final_layer = nn.Linear(D, nfeats)
        self.global_motion_token = nn.Parameter(torch.randn(2 * max_it, D))
        self.query_pos_encoder = PositionEmbeddingLearned1D(D)
        self.query_pos_decoder = PositionEmbeddingLearned1D(D)
        self.encoder = SkipTransformerEncoder(
            D, num_heads, num_layers, ff_size, activation, dropout,
            whole_layer=train_whole_layer in ("1", "enc"))
        self.decoder = SkipTransformerDecoder(
            D, num_heads, num_layers, ff_size, activation, dropout,
            whole_layer=train_whole_layer in ("1", "dec"))

    @property
    def dtype(self) -> torch.dtype:
        """The activations' type."""
        return self.compute_dtype or self.final_layer.weight.dtype

    def add_noise(self, features: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """DVAE corruption: ``int(T * F * percentage_noised)`` flattened
        (frame, feature) positions, drawn with replacement and the same for
        every sample, get unit-Gaussian noise added."""
        B, T, Fd = features.shape
        total = T * Fd
        n_corrupt = int(total * self.percentage_noised)
        dev = features.device
        idx = torch.randint(0, total, (n_corrupt,), generator=generator,
                            device=dev)
        col_mask = torch.zeros(total, dtype=features.dtype, device=dev)
        col_mask[idx] = 1.0
        noise = _randn((B, total), generator, dev, features.dtype) * col_mask
        return features + noise.reshape(B, T, Fd)

    def encode(self, features: torch.Tensor, lengths: torch.Tensor, *,
               eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               sample_mean: bool = False, fact: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
        """Features [B, T, nfeats] -> (z [B, max_it, D], mu, logvar,
        latent_valid [B, max_it]).  ``eps`` [B, max_it, D] is the Gaussian
        noise of the sample (drawn from ``generator`` when None);
        ``sample_mean`` returns mu; ``fact`` scales the deviation from mu:
        z = mu + fact * (sample - mu)."""
        B, T, _ = features.shape
        n_lat = self.max_it
        dtype = self.dtype
        features = features.to(dtype)
        if self.dvae and self.percentage_noised > 0.0 and self.training:
            features = self.add_noise(features, generator)
        frame_valid = lengths_to_mask(lengths, T)
        x = linear(self.skel_embedding, features)
        tokens = self.global_motion_token.to(dtype)[None].expand(B, -1, -1)
        lat_valid = latent_valid_mask(lengths, self.frame_per_latent, n_lat)
        aug_valid = torch.cat([lat_valid, lat_valid, frame_valid], dim=1)
        xseq = self.query_pos_encoder(torch.cat([tokens, x], dim=1))
        out = self.encoder(xseq, aug_valid, generator=generator)
        mu, logvar = out[:, :n_lat], out[:, n_lat:2 * n_lat]
        if sample_mean:
            z = mu
        else:
            if eps is None:
                eps = _randn(mu.shape, generator, mu.device, mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * eps.to(device=mu.device,
                                                        dtype=mu.dtype)
            if fact is not None:
                z = mu + fact * (z - mu)
        z = torch.where(lat_valid[:, :, None], z,
                        torch.zeros((), dtype=z.dtype, device=z.device))
        return z, mu, logvar, lat_valid

    def decode(self, z: torch.Tensor, lengths: torch.Tensor, nframes: int,
               latent_valid: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               return_cross_weights: bool = False):
        """Latents [B, max_it, D] -> features [B, nframes, nfeats]; with
        ``return_cross_weights`` ``(features, weights)``, the weights of each
        decoder layer's cross-attention [B, nframes, max_it] averaged over
        the heads, in execution order (the per-block decoder route)."""
        B, _, D = z.shape
        dtype = self.dtype
        frame_valid = lengths_to_mask(lengths, nframes)
        if latent_valid is None:
            latent_valid = latent_valid_mask(lengths, self.frame_per_latent,
                                             z.shape[1])
        queries = self.query_pos_decoder(
            torch.zeros(B, nframes, D, dtype=dtype, device=z.device))
        out = self.decoder(queries, z.to(dtype), tgt_key_valid=frame_valid,
                           memory_key_valid=latent_valid,
                           generator=generator,
                           return_cross_weights=return_cross_weights)
        if return_cross_weights:
            out, weights = out
        feats = linear(self.final_layer, out)
        feats = torch.where(frame_valid[:, :, None], feats,
                            torch.zeros((), dtype=feats.dtype,
                                        device=feats.device))
        return (feats, weights) if return_cross_weights else feats
