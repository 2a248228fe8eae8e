"""ACTOR-style VAE, the action family's stage-1 model (counterpart of
``ladiff_tpu/models/actor_vae.py``).

``encode``: ``encoder.mu_token`` and ``encoder.logvar_token`` (always
valid) are prepended to the embedded frames, a sine PE is added over the
stream, and ``num_layers`` post-norm encoder layers run under the frame
mask; the first two output tokens are mu and logvar, the reparameterised
sample is ``mu + exp(logvar / 2) eps``.  It returns the LA-VAE's 4-tuple
(z, mu, logvar [B, 1, D], latent_valid [B, 1] all true), so the system
layer reads both VAEs alike.  ``decode``: zero queries plus the sine PE run
through ``num_layers`` post-norm decoder layers that cross-attend to the
single latent, then ``decoder.final_layer``; padded frames are zeroed.

Parameter names are the reference's: ``encoder.skel_embedding``,
``encoder.mu_token``, ``encoder.logvar_token``,
``encoder.seqTransEncoder.layers.{i}.*``,
``decoder.seqTransDecoder.layers.{i}.*``, ``decoder.final_layer``; the
sine tables are buffers outside the state dict.  The layers take the
kernels as the LA-VAE's do (``ops/transformer.py``): at inference kernel 5
tails the encoder's layers (its 62-token attention stays plain, below
kernel 10's 64-token gate) and K2 runs the decoder's; in training kernels 8
and 9, or with ``train_whole_layer`` kernels 12 (encoder) and 13
(decoder).  Random draws come from an explicit ``torch.Generator``;
``encode`` also takes the Gaussian ``eps`` as a tensor.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ladiff_torch.models.vae import WHOLE_LAYER_OPTIONS
from ladiff_torch.ops.embeddings import PositionEmbeddingSine1D
from ladiff_torch.ops.transformer import (TransformerDecoderLayer,
                                          TransformerEncoderLayer, linear)
from ladiff_torch.utils.masks import lengths_to_mask

__all__ = ["ActorVae"]


class _Stack(nn.Module):
    """``layers``: the reference's ``nn.TransformerEncoder`` /
    ``nn.TransformerDecoder`` naming."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class ActorVae(nn.Module):
    def __init__(self, nfeats: int, latent_dim: Sequence[int] = (1, 256),
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, activation: str = "gelu",
                 dropout: float = 0.0, train_whole_layer: str = "0"):
        super().__init__()
        if train_whole_layer not in WHOLE_LAYER_OPTIONS:
            raise ValueError(
                f"train_whole_layer should be one of {WHOLE_LAYER_OPTIONS}, "
                f"not {train_whole_layer!r}")
        D = int(latent_dim[-1])
        self.d_model = D
        self.compute_dtype: Optional[torch.dtype] = None
        enc_whole = train_whole_layer in ("1", "enc")
        dec_whole = train_whole_layer in ("1", "dec")
        self.encoder = nn.Module()
        self.encoder.skel_embedding = nn.Linear(nfeats, D)
        self.encoder.mu_token = nn.Parameter(torch.randn(D))
        self.encoder.logvar_token = nn.Parameter(torch.randn(D))
        self.encoder.seqTransEncoder = _Stack([
            TransformerEncoderLayer(D, num_heads, ff_size, activation,
                                    dropout, enc_whole)
            for _ in range(num_layers)])
        self.decoder = nn.Module()
        self.decoder.seqTransDecoder = _Stack([
            TransformerDecoderLayer(D, num_heads, ff_size, activation,
                                    dropout, dec_whole)
            for _ in range(num_layers)])
        self.decoder.final_layer = nn.Linear(D, nfeats)
        self.pe = PositionEmbeddingSine1D(D)

    @property
    def dtype(self) -> torch.dtype:
        """The activations' type."""
        return self.compute_dtype or self.decoder.final_layer.weight.dtype

    def encode(self, features: torch.Tensor, lengths: torch.Tensor, *,
               eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
        """Features [B, T, nfeats] -> (z, mu, logvar [B, 1, D], latent_valid
        [B, 1]).  ``eps`` [B, 1, D] is the sample's Gaussian noise (drawn
        from ``generator`` when None)."""
        B, T, _ = features.shape
        dtype, enc = self.dtype, self.encoder
        x = linear(enc.skel_embedding, features.to(dtype))
        tokens = torch.stack([enc.mu_token, enc.logvar_token]).to(dtype)
        xseq = self.pe(torch.cat([tokens[None].expand(B, -1, -1), x], dim=1))
        valid = torch.cat([torch.ones(B, 2, dtype=torch.bool,
                                      device=x.device),
                           lengths_to_mask(lengths, T)], dim=1)
        for layer in enc.seqTransEncoder.layers:
            xseq = layer(xseq, valid, generator=generator)
        mu, logvar = xseq[:, :1], xseq[:, 1:2]
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        z = mu + torch.exp(0.5 * logvar) * eps.to(device=mu.device,
                                                    dtype=mu.dtype)
        return z, mu, logvar, torch.ones(B, 1, dtype=torch.bool,
                                         device=z.device)

    def decode(self, z: torch.Tensor, lengths: torch.Tensor, nframes: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Latent [B, 1, D] -> features [B, nframes, nfeats], padded frames
        zero."""
        B, _, D = z.shape
        dtype = self.dtype
        frame_valid = lengths_to_mask(lengths, nframes)
        out = self.pe(torch.zeros(B, nframes, D, dtype=dtype,
                                  device=z.device))
        memory = z.to(dtype)
        for layer in self.decoder.seqTransDecoder.layers:
            out = layer(out, memory, tgt_key_valid=frame_valid,
                        generator=generator)
        feats = linear(self.decoder.final_layer, out)
        return torch.where(frame_valid[:, :, None], feats,
                           torch.zeros((), dtype=feats.dtype,
                                       device=feats.device))
