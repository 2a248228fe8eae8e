"""LA-VAE (counterpart of ``ladiff_tpu/models/vae.py``).

``encode``: ``2 * n_lat`` learned distribution tokens are prepended to the
embedded frames, the ``query_pos_encoder`` is added over the whole stream,
and the skip encoder runs under the frame mask and the
``ceil(len / FRAME_PER_LATENT)`` mask on both token halves; the first
``n_lat`` output tokens are ``mu``, the next ``logvar``; the reparameterised
sample has its inactive rows zeroed.  ``decode``: zero frame queries plus
the ``query_pos_decoder`` cross-attend to the latent memory through the
skip decoder under the same length mask on the memory rows;
``final_layer`` maps to features and padded frames are zeroed.
``add_noise`` is the DVAE input corruption.

The ablation switches (the reference's ``TRAIN.ABLATION``), as the JAX
package has them:

  * ``n_lat`` is ``max_it`` or, with ``max_it`` 0, ``latent_dim[0]``;
    without ``lad`` or with ``max_it`` 0 every latent and token row is
    valid in the encoder and z is not zeroed (MLD's fixed-size latent set).
    The decoder still masks memory rows past ``ceil(len /
    FRAME_PER_LATENT)`` unless it is given ``latent_valid``, as the JAX
    package's ``decode`` does;
  * ``mlp_dist``: ``latent_dim[0]`` distribution tokens, and
    ``dist_layer`` (D -> 2D) over their outputs gives mu and logvar as its
    halves;
  * ``test_efficiency``: the decoder runs without the memory mask.

The module options that no configuration reaches: ``normalize_before``
(pre-norm skip stacks, run in plain parts), ``arch="all_encoder"`` (the
decode is a skip encoder over ``[z; queries]`` with z's rows valid) and
``position_embedding="sine"`` (fixed sine PEs, no parameter).

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

from ladiff_torch.ops.embeddings import (PositionEmbeddingLearned1D,
                                         PositionEmbeddingSine1D)
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
                 train_whole_layer: str = "0", lad: bool = True,
                 mlp_dist: bool = False, test_efficiency: bool = False,
                 arch: str = "encoder_decoder",
                 normalize_before: bool = False,
                 position_embedding: str = "learned"):
        super().__init__()
        D = int(latent_dim[-1])
        if train_whole_layer not in WHOLE_LAYER_OPTIONS:
            raise ValueError(
                f"train_whole_layer should be one of {WHOLE_LAYER_OPTIONS}, "
                f"not {train_whole_layer!r}")
        if arch not in ("encoder_decoder", "all_encoder"):
            raise ValueError(f"arch {arch!r}: encoder_decoder or all_encoder")
        if position_embedding not in ("learned", "sine"):
            raise ValueError(f"position_embedding {position_embedding!r}: "
                             "learned or sine")
        if mlp_dist and max_it and int(latent_dim[0]) != max_it:
            raise ValueError(
                f"mlp_dist (MLP_DIST) with max_it (MAX_IT) {max_it}: its "
                f"latent_dim[0] = {latent_dim[0]} tokens give that many mu "
                f"rows against a {max_it}-row latent mask, which the JAX "
                "package cannot trace; set MAX_IT 0 or latent_dim[0] = MAX_IT")
        self.max_it = max_it
        self.n_lat = max_it or int(latent_dim[0])
        self.frame_per_latent = frame_per_latent
        self.lad = lad
        self.mlp_dist = mlp_dist
        self.test_efficiency = test_efficiency
        self.arch = arch
        self.dvae = dvae
        self.percentage_noised = percentage_noised
        self.compute_dtype: Optional[torch.dtype] = None
        self.skel_embedding = nn.Linear(nfeats, D)
        self.final_layer = nn.Linear(D, nfeats)
        if mlp_dist:
            # reference ladiff_vae.py:110-113
            self.dist_layer = nn.Linear(D, 2 * D)
        n_tok = int(latent_dim[0]) if mlp_dist else 2 * self.n_lat
        self.global_motion_token = nn.Parameter(torch.randn(n_tok, D))
        pe = (PositionEmbeddingLearned1D if position_embedding == "learned"
              else PositionEmbeddingSine1D)
        self.query_pos_encoder = pe(D)
        self.query_pos_decoder = pe(D)
        self.encoder = SkipTransformerEncoder(
            D, num_heads, num_layers, ff_size, activation, dropout,
            whole_layer=train_whole_layer in ("1", "enc"),
            normalize_before=normalize_before)
        stack = (SkipTransformerDecoder if arch == "encoder_decoder"
                 else SkipTransformerEncoder)
        self.decoder = stack(
            D, num_heads, num_layers, ff_size, activation, dropout,
            whole_layer=train_whole_layer in ("1", "dec"),
            normalize_before=normalize_before)

    @property
    def length_aware(self) -> bool:
        """Whether the latent rows past ``ceil(len / FRAME_PER_LATENT)`` are
        masked in the encoder and zeroed in z."""
        return bool(self.max_it and self.lad)

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
        """Features [B, T, nfeats] -> (z [B, n_lat, D], mu, logvar,
        latent_valid [B, n_lat]).  ``eps`` [B, n_lat, D] is the Gaussian
        noise of the sample (drawn from ``generator`` when None);
        ``sample_mean`` returns mu; ``fact`` scales the deviation from mu:
        z = mu + fact * (sample - mu)."""
        B, T, _ = features.shape
        n_lat = self.n_lat
        dtype = self.dtype
        features = features.to(dtype)
        if self.dvae and self.percentage_noised > 0.0 and self.training:
            features = self.add_noise(features, generator)
        frame_valid = lengths_to_mask(lengths, T)
        x = linear(self.skel_embedding, features)
        tokens = self.global_motion_token.to(dtype)[None].expand(B, -1, -1)
        n_tok = tokens.shape[1]
        if self.length_aware:
            lat_valid = latent_valid_mask(lengths, self.frame_per_latent,
                                          n_lat)
        else:
            lat_valid = torch.ones(B, n_lat, dtype=torch.bool,
                                   device=lengths.device)
        aug_valid = torch.cat([torch.cat([lat_valid, lat_valid],
                                         dim=1)[:, :n_tok], frame_valid],
                              dim=1)
        xseq = self.query_pos_encoder(torch.cat([tokens, x], dim=1))
        out = self.encoder(xseq, aug_valid, generator=generator)[:, :n_tok]
        if self.mlp_dist:
            mu, logvar = linear(self.dist_layer, out).chunk(2, dim=-1)
        else:
            mu, logvar = out[:, :n_lat], out[:, n_lat:]
        if sample_mean:
            z = mu
        else:
            if eps is None:
                eps = _randn(mu.shape, generator, mu.device, mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * eps.to(device=mu.device,
                                                        dtype=mu.dtype)
            if fact is not None:
                z = mu + fact * (z - mu)
        if self.length_aware:
            z = torch.where(lat_valid[:, :, None], z,
                            torch.zeros((), dtype=z.dtype, device=z.device))
        return z, mu, logvar, lat_valid

    def decode(self, z: torch.Tensor, lengths: torch.Tensor, nframes: int,
               latent_valid: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               return_cross_weights: bool = False):
        """Latents [B, L, D] -> features [B, nframes, nfeats]; with
        ``return_cross_weights`` ``(features, weights)``, the weights of each
        decoder layer's cross-attention [B, nframes, L] averaged over the
        heads, in execution order (the per-block decoder route).  The
        memory rows past ``ceil(len / FRAME_PER_LATENT)`` are masked unless
        ``latent_valid`` [B, L] is given, whatever ``lad``, and none with
        ``test_efficiency`` (the JAX package's ``decode``)."""
        B, L, D = z.shape
        dtype = self.dtype
        frame_valid = lengths_to_mask(lengths, nframes)
        if latent_valid is None:
            latent_valid = latent_valid_mask(lengths, self.frame_per_latent,
                                             L)
        queries = self.query_pos_decoder(
            torch.zeros(B, nframes, D, dtype=dtype, device=z.device))
        if self.arch == "all_encoder":
            if return_cross_weights:
                raise ValueError("the all_encoder decoder has no "
                                 "cross-attention weights to return")
            xseq = self.query_pos_decoder(torch.cat([z.to(dtype), queries],
                                                    dim=1))
            valid = torch.cat([torch.ones(B, L, dtype=torch.bool,
                                          device=z.device), frame_valid],
                              dim=1)
            out = self.decoder(xseq, valid, generator=generator)[:, L:]
        else:
            out = self.decoder(
                queries, z.to(dtype), tgt_key_valid=frame_valid,
                memory_key_valid=(None if self.test_efficiency
                                  else latent_valid),
                generator=generator,
                return_cross_weights=return_cross_weights)
        if return_cross_weights:
            out, weights = out
        feats = linear(self.final_layer, out)
        feats = torch.where(frame_valid[:, :, None], feats,
                            torch.zeros((), dtype=feats.dtype,
                                        device=feats.device))
        return (feats, weights) if return_cross_weights else feats
