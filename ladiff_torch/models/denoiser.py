"""LA-denoiser (counterpart of ``ladiff_tpu/models/denoiser.py``), the
text and the action condition, in its two wirings.

Text (``condition="text"``): sinusoidal timestep embedding at
``text_encoded_dim`` (768) projected by Linear-SiLU-Linear to D; pooled
CLIP text projected by ReLU + Linear.  Action (``condition="action"``, the
action family): the sinusoidal width is D; the condition is a learned
class table ``emb_proj.action_embedding`` [nclasses, D] (``EmbedAction``):
one token [B, 1, D] per sample, zeros for the unconditional branch, and in
training each sample's token is dropped (zeroed) with probability
``guidance_uncondp``.

  * ``md_trans=True`` (the published LADiff model): latents [B, MAX_IT, D]
    with a per-sample latent-row mask through the skip encoder over
    ``MDTransformerLayer``.
  * ``md_trans=False``: the plain skip encoder (``SkipTransformerEncoder``,
    the reference's vanilla post-norm layers with the denoiser's
    activation, or pre-norm ones with ``normalize_before``, which the MD
    wiring ignores as the JAX package does) over the tokens ``[latents;
    time; text]``, positional embedding over the whole sequence and no key
    mask (the reference passes none, so padded rows attend); the output is
    the first ``n_lat`` rows.
    With ``diffusion_only`` (feature-space diffusion, the novae family)
    ``pose_embd`` (nfeats -> D) embeds the feature frames, the tokens are
    ``[time; text; frames]``, ``pose_proj`` (D -> nfeats) maps the frame rows
    back and ``frame_valid`` zeroes the padded frames.

Autoregressive conditioning (the ARDIFF family): ``enclat`` [B, n_cond, D]
conditioning latents join the stream after the sample's rows, with the row
mask ``[latent_valid or ones; enclat_valid or ones]`` where either is given;
the output is the sample's rows.  In the MD wiring that mask is the layers'
row mask; the plain wiring passes a key mask over ``[stream; time; text]``
only where both ``enclat_valid`` and a stream mask exist (never with
``diffusion_only``), as the JAX package does.

``position_embedding`` is "learned" (``query_pos.pe``) or "sine" (no
parameter).  Parameter names follow the reference (``time_embedding.linear_1``,
``emb_proj.1``, ``query_pos.pe``, ``pose_embd``, ``pose_proj``,
``encoder.*``).  In training mode (``module.train()``) the layers take
their training route with ``dropout``; masks and kernel seeds come from the
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
                                         PositionEmbeddingSine1D,
                                         TimestepEmbedding,
                                         timestep_embedding)
from ladiff_torch.ops.stylization import MDSkipTransformerEncoder
from ladiff_torch.ops.transformer import SkipTransformerEncoder, linear

__all__ = ["LADenoiser", "EmbedAction"]


class EmbedAction(nn.Module):
    """The learned action-class table with the unconditional drop of
    classifier-free guidance."""

    def __init__(self, num_actions: int, latent_dim: int,
                 guidance_uncondp: float = 0.1):
        super().__init__()
        self.guidance_uncondp = guidance_uncondp
        self.action_embedding = nn.Parameter(
            nn.init.xavier_uniform_(torch.empty(num_actions, latent_dim)))

    def forward(self, action_ids: torch.Tensor, force_mask: bool = False,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B] class ids -> [B, D]; ``force_mask`` gives zeros.  In training
        mode a sample's row is zeroed where ``drop`` [B, 1] (bool, the
        caller's Bernoulli(``guidance_uncondp``) draw) is true."""
        out = self.action_embedding[action_ids.long()]
        if force_mask:
            return torch.zeros_like(out)
        if self.training and self.guidance_uncondp > 0.0:
            if drop is None:
                raise ValueError("EmbedAction in training mode needs the "
                                 "drop mask")
            out = out * (~drop.to(out.device)).to(out.dtype)
        return out


class LADenoiser(nn.Module):
    def __init__(self, nfeats: int = 263, latent_dim: Sequence[int] = (7, 256),
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, text_encoded_dim: int = 768,
                 flip_sin_to_cos: bool = True, freq_shift: int = 0,
                 dropout: float = 0.0, md_trans: bool = True,
                 diffusion_only: bool = False, activation: str = "gelu",
                 position_embedding: str = "learned",
                 condition: str = "text", nclasses: int = 12,
                 guidance_uncondp: float = 0.1,
                 normalize_before: bool = False):
        super().__init__()
        D = int(latent_dim[-1])
        if diffusion_only and md_trans:
            raise ValueError("diffusion_only runs the plain wiring "
                             "(md_trans=False)")
        if condition not in ("text", "action"):
            raise ValueError(f"condition {condition!r}: text or action")
        if position_embedding not in ("learned", "sine"):
            raise ValueError(f"position_embedding {position_embedding!r}: "
                             "learned or sine")
        self.d_model = D
        self.text_encoded_dim = text_encoded_dim
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.md_trans = md_trans
        self.diffusion_only = diffusion_only
        self.condition = condition
        self.compute_dtype: Optional[torch.dtype] = None
        # the sinusoidal time embedding is text_encoded_dim wide for text, D
        # for action
        self.time_sin_dim = text_encoded_dim if condition == "text" else D
        self.time_embedding = TimestepEmbedding(self.time_sin_dim, D)
        if condition == "action":
            self.emb_proj = EmbedAction(nclasses, D, guidance_uncondp)
        elif text_encoded_dim != D:
            self.emb_proj = nn.Sequential(nn.ReLU(),
                                          nn.Linear(text_encoded_dim, D))
        if diffusion_only:
            self.pose_embd = nn.Linear(nfeats, D)
            self.pose_proj = nn.Linear(D, nfeats)
        self.query_pos = (PositionEmbeddingLearned1D(D)
                          if position_embedding == "learned"
                          else PositionEmbeddingSine1D(D))
        if md_trans:
            self.encoder = MDSkipTransformerEncoder(D, D, num_heads,
                                                    num_layers, ff_size,
                                                    dropout)
        else:
            self.encoder = SkipTransformerEncoder(
                D, num_heads, num_layers, ff_size, activation, dropout,
                normalize_before=normalize_before)

    @property
    def dtype(self) -> torch.dtype:
        """The activations' type."""
        return self.compute_dtype or self.time_embedding.linear_1.weight.dtype

    def compute_time_embedding(self, timesteps: torch.Tensor) -> torch.Tensor:
        """[N] timesteps -> [N, D]; samplers build the whole table once."""
        t_emb = timestep_embedding(
            timesteps, self.time_sin_dim,
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

    def embed_action(self, action_ids: torch.Tensor,
                     force_mask: bool = False) -> torch.Tensor:
        """[B] class ids -> [B, 1, D] condition tokens in the activations'
        type; ``force_mask`` gives the zeroed unconditional branch."""
        return self.emb_proj(action_ids, force_mask=force_mask)[:, None].to(
            self.dtype)

    def precompute_md_prep(self, text_emb_latent: torch.Tensor,
                           time_table: torch.Tensor,
                           with_params: bool = True) -> List[dict]:
        """Per-layer text values [B, D] and AdaLN rows for every sampling
        step [S, 2D] (see ``MDTransformerLayer.compute_prep``)."""
        assert self.md_trans
        return self.encoder.precompute_prep(text_emb_latent.to(self.dtype),
                                            time_table.to(self.dtype),
                                            with_params)

    def precompute_md_stack(self) -> dict:
        """The stacked [L, ...] layer tensors, skip Linears and final
        LayerNorm for the whole-stack kernel, in the activations' type;
        built once before a sampling loop."""
        assert self.md_trans
        return self.encoder.stacked_params(self.dtype)

    def stack_md_prep(self, prep_all: List[dict]):
        """``precompute_md_prep`` laid out for the whole-stack kernel:
        values [L, B, D] and AdaLN tables [S, L, 2D]."""
        assert self.md_trans
        return self.encoder.stack_prep(prep_all)

    def forward(self, sample: torch.Tensor,
                timesteps: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                latent_valid: Optional[torch.Tensor] = None,
                time_emb: Optional[torch.Tensor] = None,
                text_emb_latent: Optional[torch.Tensor] = None,
                md_prep: Optional[Union[List[dict], dict]] = None,
                generator: Optional[torch.Generator] = None,
                frame_valid: Optional[torch.Tensor] = None,
                enclat: Optional[torch.Tensor] = None,
                enclat_valid: Optional[torch.Tensor] = None,
                cond_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample [B, n_lat, D] noisy latents (``diffusion_only``: [B, T,
        nfeats] noisy feature frames, ``frame_valid`` [B, T]) -> predicted
        noise of the same shape.  ``latent_valid`` masks the MD wiring's
        latent rows; the plain wiring passes no key mask unless ``enclat``
        rows need hiding.  ``enclat`` [B, n_cond, D] and ``enclat_valid``
        [B, n_cond]: the autoregressive conditioning rows.  With the action
        condition ``encoder_hidden_states`` are class ids [B] and
        ``cond_drop`` [B, 1, 1] (bool, required in training mode) the
        samples whose token is dropped."""
        B, n_lat = sample.shape[:2]
        sample = sample.to(self.dtype)
        if time_emb is None:
            time_emb = self.compute_time_embedding(timesteps)
        time_emb = time_emb.to(self.dtype)
        if text_emb_latent is None and self.condition == "action":
            drop = None if cond_drop is None else cond_drop.reshape(B, 1)
            text_emb_latent = self.emb_proj(encoder_hidden_states,
                                            drop=drop)[:, None]
        elif text_emb_latent is None:
            text_emb_latent = self.project_text(encoder_hidden_states)
        text_emb_latent = text_emb_latent.to(self.dtype)
        if self.diffusion_only:
            sample = linear(self.pose_embd, sample)
        stream, stream_valid = sample, latent_valid
        if enclat is not None:
            stream = torch.cat([sample, enclat.to(self.dtype)], dim=1)
            stream_valid = None
            if latent_valid is not None or enclat_valid is not None:
                ones = lambda n: torch.ones(B, n, dtype=torch.bool,
                                            device=sample.device)
                stream_valid = torch.cat([
                    ones(n_lat) if latent_valid is None else latent_valid,
                    ones(enclat.shape[1]) if enclat_valid is None
                    else enclat_valid], dim=1)
        if self.md_trans:
            xseq = self.query_pos(stream)
            return self.encoder(xseq, text_emb_latent, time_emb,
                                stream_valid, prep=md_prep,
                                generator=generator)[:, :n_lat]
        emb_tokens = torch.cat([time_emb[:, None], text_emb_latent], dim=1)
        if not self.diffusion_only:
            key_valid = None
            if enclat_valid is not None and stream_valid is not None:
                key_valid = torch.cat([stream_valid, torch.ones(
                    B, emb_tokens.shape[1], dtype=torch.bool,
                    device=sample.device)], dim=1)
            xseq = self.query_pos(torch.cat([stream, emb_tokens], dim=1))
            return self.encoder(xseq, key_valid,
                                generator=generator)[:, :n_lat]
        xseq = self.query_pos(torch.cat([emb_tokens, stream], dim=1))
        tokens = self.encoder(xseq, generator=generator)
        out = linear(self.pose_proj, tokens[:, emb_tokens.shape[1]:])
        if frame_valid is not None:
            out = torch.where(frame_valid[:, :, None], out,
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device))
        return out
