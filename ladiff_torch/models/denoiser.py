"""LA-denoiser, the ``MD_TRANS`` text path (counterpart of
``ladiff_tpu/models/denoiser.py``).

Latents [B, MAX_IT, D] with a per-sample latent-row mask; sinusoidal
timestep embedding at ``text_encoded_dim`` (768) projected by
Linear-SiLU-Linear to D; pooled CLIP text projected by ReLU + Linear; the
skip encoder over ``MDTransformerLayer``.  Parameter names follow the
reference (``time_embedding.linear_1``, ``emb_proj.1``, ``query_pos.pe``,
``encoder.*``).  In training mode (``module.train()``) the MD layers take
their unfused route with ``dropout``; masks and kernel seeds come from the
``generator`` passed to ``forward``.  ``compute_dtype`` (set by
``LADiffSystem``) is the activations' type where it differs from the
parameters' (float32 parameters, bf16 compute).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.embeddings import (PositionEmbeddingLearned1D,
                                         TimestepEmbedding,
                                         timestep_embedding)
from ladiff_torch.ops.stylization import MDSkipTransformerEncoder
from ladiff_torch.ops.transformer import linear

__all__ = ["LADenoiser"]


class LADenoiser(nn.Module):
    def __init__(self, nfeats: int = 263, latent_dim: Sequence[int] = (7, 256),
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, text_encoded_dim: int = 768,
                 flip_sin_to_cos: bool = True, freq_shift: int = 0,
                 dropout: float = 0.0):
        super().__init__()
        D = int(latent_dim[-1])
        self.d_model = D
        self.text_encoded_dim = text_encoded_dim
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.compute_dtype: Optional[torch.dtype] = None
        self.time_embedding = TimestepEmbedding(text_encoded_dim, D)
        if text_encoded_dim != D:
            self.emb_proj = nn.Sequential(nn.ReLU(),
                                          nn.Linear(text_encoded_dim, D))
        self.query_pos = PositionEmbeddingLearned1D(D)
        self.encoder = MDSkipTransformerEncoder(D, D, num_heads, num_layers,
                                                ff_size, dropout)

    @property
    def dtype(self) -> torch.dtype:
        """The activations' type."""
        return self.compute_dtype or self.query_pos.pe.dtype

    def compute_time_embedding(self, timesteps: torch.Tensor) -> torch.Tensor:
        """[N] timesteps -> [N, D]; samplers build the whole table once."""
        t_emb = timestep_embedding(
            timesteps, self.text_encoded_dim,
            flip_sin_to_cos=self.flip_sin_to_cos,
            downscale_freq_shift=float(self.freq_shift)).to(self.dtype)
        return self.time_embedding(t_emb)

    def project_text(self, encoder_hidden_states: torch.Tensor
                     ) -> torch.Tensor:
        """[B, N, 768] text features (pooled, N = 1, or the full context)
        -> [B, N, D]; step-invariant."""
        text = encoder_hidden_states.to(self.dtype)
        if text.shape[-1] == self.d_model:
            return text
        return linear(self.emb_proj[1], F.relu(text))

    def precompute_md_prep(self, text_emb_latent: torch.Tensor,
                           time_table: torch.Tensor,
                           with_params: bool = True) -> List[dict]:
        """Per-layer text values [B, D] and AdaLN rows for every sampling
        step [S, 2D] (see ``MDTransformerLayer.compute_prep``)."""
        return self.encoder.precompute_prep(text_emb_latent.to(self.dtype),
                                            time_table.to(self.dtype),
                                            with_params)

    def precompute_md_stack(self) -> dict:
        """The stacked [L, ...] layer tensors, skip Linears and final
        LayerNorm for the whole-stack kernel, in the activations' type;
        built once before a sampling loop."""
        return self.encoder.stacked_params(self.dtype)

    def stack_md_prep(self, prep_all: List[dict]):
        """``precompute_md_prep`` laid out for the whole-stack kernel:
        values [L, B, D] and AdaLN tables [S, L, 2D]."""
        return self.encoder.stack_prep(prep_all)

    def forward(self, sample: torch.Tensor,
                timesteps: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                latent_valid: Optional[torch.Tensor] = None,
                time_emb: Optional[torch.Tensor] = None,
                text_emb_latent: Optional[torch.Tensor] = None,
                md_prep: Optional[Union[List[dict], dict]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """sample [B, n_lat, D] noisy latents -> predicted noise."""
        sample = sample.to(self.dtype)
        if time_emb is None:
            time_emb = self.compute_time_embedding(timesteps)
        time_emb = time_emb.to(self.dtype)
        if text_emb_latent is None:
            text_emb_latent = self.project_text(encoder_hidden_states)
        text_emb_latent = text_emb_latent.to(self.dtype)
        xseq = self.query_pos(sample)
        return self.encoder(xseq, text_emb_latent, time_emb, latent_valid,
                            prep=md_prep, generator=generator)
