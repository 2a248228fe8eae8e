"""MotionCLIP: a motion autoencoder whose latent lives in CLIP's text space,
and its ViT-B/32 text tower (counterpart of
``ladiff_tpu/models/motionclip.py``).

- ``MotionClipMotionEncoder``: frames embedded by ``skel_embedding``, a
  learned ``mu_query`` token prepended, a sine PE over ``max_len + 1`` rows,
  ``num_layers`` post-norm encoder layers under the frame mask; token 0 is
  the latent [B, latent_dim].
- ``MotionClipMotionDecoder``: sine-PE queries cross-attend to the one
  latent row through ``num_layers`` post-norm decoder layers, then
  ``final_layer``; padded frames are zero.
- ``MotionClip``: the two, with ``clip_alignment`` (the cosine matrix
  between motion latents and text features).
- ``MotionClipTextEncoder``: texts -> [B, 1, 512] (or the last hidden state
  [B, 77, 512]): the port's ``CLIPTextTower`` at ViT-B/32's text geometry
  (width 512, 8 heads, 12 layers, projection 512).

Parameter names are the JAX module's in torch form (``skel_embedding``,
``mu_query``, ``layers.{i}.*`` with the encoder / decoder layers' own
names, ``final_layer``); the sine tables are buffers outside the state
dict.  The layers are ``ops/transformer.py``'s, so their route gates
decide kernel or plain part: in bf16 at inference each self-attention over
at least 64 tokens is kernel 10 (head width 128 at the default 4 heads);
D 512 is past kernel 5's and K2's gates, so the FFN tails and the
decoder's cross-attention are plain parts.  The text tower runs K3 and K4
in bf16 (width 512).  Dropout draws come from the ``generator`` passed to
``forward``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ladiff_torch.models.clip_text import ClipTextEncoder, _load_hf_state
from ladiff_torch.ops.embeddings import sinusoidal_position_table
from ladiff_torch.ops.transformer import (TransformerDecoderLayer,
                                          TransformerEncoderLayer)
from ladiff_torch.utils.device import resolve_device
from ladiff_torch.utils.masks import lengths_to_mask

__all__ = ["MotionClipTextEncoder", "MotionClipMotionEncoder",
           "MotionClipMotionDecoder", "MotionClip"]


def _sine_table(rows: int, d: int) -> torch.Tensor:
    return torch.from_numpy(sinusoidal_position_table(rows, d))


class MotionClipMotionEncoder(nn.Module):
    """feats [B, T, F], lengths [B] -> z [B, latent_dim] (token 0)."""

    def __init__(self, nfeats: int, latent_dim: int = 512,
                 num_layers: int = 8, num_heads: int = 4,
                 ff_size: int = 1024, dropout: float = 0.1,
                 activation: str = "gelu", max_len: int = 196,
                 device=None):
        super().__init__()
        self.skel_embedding = nn.Linear(nfeats, latent_dim)
        self.mu_query = nn.Parameter(0.02 * torch.randn(1, latent_dim))
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(latent_dim, num_heads, ff_size,
                                    activation, dropout)
            for _ in range(num_layers)])
        self.register_buffer("pe", _sine_table(max_len + 1, latent_dim),
                             persistent=False)
        self.to(resolve_device(device))

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, _ = feats.shape
        w = self.skel_embedding.weight
        x = self.skel_embedding(feats.to(w.dtype))
        mu = self.mu_query.to(x.dtype)[None].expand(B, 1, -1)
        x = torch.cat([mu, x], dim=1) + self.pe[:T + 1].to(x.dtype)[None]
        valid = torch.cat([torch.ones(B, 1, dtype=torch.bool,
                                      device=x.device),
                           lengths_to_mask(lengths.to(x.device), T)], dim=1)
        for layer in self.layers:
            x = layer(x, valid, generator=generator)
        return x[:, 0]


class MotionClipMotionDecoder(nn.Module):
    """z [B, latent_dim], lengths [B] -> feats [B, nframes, nfeats]."""

    def __init__(self, nfeats: int, latent_dim: int = 512,
                 num_layers: int = 8, num_heads: int = 4,
                 ff_size: int = 1024, dropout: float = 0.1,
                 activation: str = "gelu", max_len: int = 196,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(latent_dim, num_heads, ff_size,
                                    activation, dropout)
            for _ in range(num_layers)])
        self.final_layer = nn.Linear(latent_dim, nfeats)
        self.register_buffer("pe", _sine_table(max_len, latent_dim),
                             persistent=False)
        self.to(resolve_device(device))

    def forward(self, z: torch.Tensor, lengths: torch.Tensor, nframes: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B = z.shape[0]
        dtype = self.final_layer.weight.dtype
        x = self.pe[:nframes].to(dtype)[None].expand(B, -1, -1)
        memory = z[:, None, :].to(dtype)
        valid = lengths_to_mask(lengths.to(z.device), nframes)
        for layer in self.layers:
            x = layer(x, memory, tgt_key_valid=valid, generator=generator)
        out = self.final_layer(x)
        return torch.where(valid[..., None], out, torch.zeros(
            (), dtype=out.dtype, device=out.device))


class MotionClip(nn.Module):
    """Motion autoencoder whose latent is aligned with CLIP text space."""

    def __init__(self, nfeats: int, latent_dim: int = 512,
                 num_layers: int = 8, num_heads: int = 4,
                 ff_size: int = 1024, dropout: float = 0.1,
                 max_len: int = 196, device=None):
        super().__init__()
        kw = dict(nfeats=nfeats, latent_dim=latent_dim,
                  num_layers=num_layers, num_heads=num_heads,
                  ff_size=ff_size, dropout=dropout, max_len=max_len,
                  device=device)
        self.encoder = MotionClipMotionEncoder(**kw)
        self.decoder = MotionClipMotionDecoder(**kw)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """-> (reconstruction [B, T, F], z [B, latent_dim])."""
        z = self.encoder(feats, lengths, generator)
        return self.decoder(z, lengths, feats.shape[1], generator), z

    def encode(self, feats, lengths, generator=None):
        return self.encoder(feats, lengths, generator)

    def decode(self, z, lengths, nframes: int, generator=None):
        return self.decoder(z, lengths, nframes, generator)

    @staticmethod
    def clip_alignment(z_motion: torch.Tensor,
                       z_text: torch.Tensor) -> torch.Tensor:
        """Cosine similarity matrix [B, B] between motion latents and CLIP
        text features."""
        zm = z_motion / (z_motion.norm(dim=-1, keepdim=True) + 1e-8)
        zt = z_text / (z_text.norm(dim=-1, keepdim=True) + 1e-8)
        return zm @ zt.T


class MotionClipTextEncoder(ClipTextEncoder):
    """texts -> [B, 1, 512] pooled features (or [B, 77, 512] with
    ``last_hidden_state``): ``ClipTextEncoder`` at ViT-B/32's text
    geometry, with its tokenizers and its 77-token buckets in pooled mode
    (causal attention and EOT pooling make the pooled feature independent
    of trailing padding; the JAX class always runs 77 tokens).  Loads an
    HF CLIP checkpoint from ``modelpath`` (``pytorch_model.bin`` or
    ``model.safetensors``, the text tower's keys; a checkpoint without a
    text projection gets the identity, as the JAX loader gives it)."""

    tower_geometry = dict(width=512, heads=8, num_layers=12,
                          projection_dim=512)
    text_encoded_dim = 512

    def _load(self, modelpath: str) -> None:
        state = _load_hf_state(modelpath)
        if state is None:
            return
        own = self.tower.state_dict()
        load: Dict[str, torch.Tensor] = {k: v for k, v in state.items()
                                         if k in own}
        if "text_projection.weight" not in load:
            proj = state.get("text_projection")
            load["text_projection.weight"] = (
                proj.T.contiguous() if proj is not None else torch.from_numpy(
                    np.eye(512, dtype=np.float32)))
        self.tower.load_state_dict(load)
