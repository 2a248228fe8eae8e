"""LADiff system (counterpart of ``ladiff_tpu/models/ladiff.py``).

Generation: text embeddings -> CFG DDIM over the latent set -> LA-VAE
decode -> features (-> joints).  Stage-1 training: ``vae_forward`` is the
reconstruction pass with its losses (encode -> decode -> SmoothL1 on
features and joints + KL).

``dtype`` is the compute type (bf16 on CUDA, the kernels' type) and
``param_dtype`` the parameters' storage type, the same unless given: the
trainer keeps float32 parameters and computes in bf16.

The state dict carries ``vae.*`` and ``denoiser.*`` keys in the reference
torch LADiff layout.  ``diffusion_reverse`` computes the step-invariant work
once before the step loop: the text projection, the timestep-embedding
table of every DDIM step, and each MD layer's text value and AdaLN rows.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ladiff_torch.data.humanml.motion_repr import recover_from_ric
from ladiff_torch.diffusion.sampling import ddim_sample, make_cfg_denoise_fn
from ladiff_torch.diffusion.schedulers import ddim_timesteps, make_schedule
from ladiff_torch.losses.mld import LossWeights, vae_loss
from ladiff_torch.models.denoiser import LADenoiser
from ladiff_torch.models.vae import LAVae
from ladiff_torch.utils.device import resolve_device, resolve_dtype
from ladiff_torch.utils.masks import latent_valid_mask

__all__ = ["LADiffSystem"]


class LADiffSystem(nn.Module):
    def __init__(self, nfeats: int, njoints: int, max_frames: int = 196,
                 latent_dim: Sequence[int] = (7, 256), ff_size: int = 1024,
                 num_layers: int = 9, num_heads: int = 4, max_it: int = 5,
                 frame_per_latent: int = 48, text_encoded_dim: int = 768,
                 guidance_scale: float = 7.5,
                 num_inference_timesteps: int = 50,
                 num_train_timesteps: int = 1000,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None,
                 dropout: float = 0.0, dvae: bool = False,
                 percentage_noised: float = 0.0,
                 weights: Optional[LossWeights] = None,
                 device=None, dtype: Optional[torch.dtype] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(device, dtype)
        self.dtype = dtype
        self.weights = weights or LossWeights()
        self.nfeats, self.njoints = nfeats, njoints
        self.max_frames = max_frames
        self.latent_dim = tuple(int(v) for v in latent_dim)
        self.max_it = max_it
        self.frame_per_latent = frame_per_latent
        self.guidance_scale = guidance_scale
        self.num_inference_timesteps = num_inference_timesteps
        self.schedule = make_schedule(num_train_timesteps)
        self.vae = LAVae(nfeats, latent_dim, ff_size, num_layers, num_heads,
                         max_it, frame_per_latent, dropout=dropout,
                         dvae=dvae, percentage_noised=percentage_noised)
        self.vae.compute_dtype = dtype
        self.denoiser = LADenoiser(nfeats, latent_dim, ff_size, num_layers,
                                   num_heads, text_encoded_dim)
        for name, v in (("mean", mean), ("std", std)):
            self.register_buffer(
                name, None if v is None else torch.as_tensor(
                    np.asarray(v, np.float32)), persistent=False)
        self.to(device=device, dtype=param_dtype or dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.denoiser.query_pos.pe.device

    def feats2joints(self, feats: torch.Tensor) -> torch.Tensor:
        """Denormalize + RIC recovery -> joints [..., T, J, 3]."""
        feats = feats.float()
        if self.mean is not None:
            feats = feats * self.std.float() + self.mean.float()
        return recover_from_ric(feats, self.njoints)

    @torch.no_grad()
    def diffusion_reverse(self, text_emb_cond: torch.Tensor,
                          text_emb_uncond: torch.Tensor,
                          lengths: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          num_inference_timesteps: Optional[int] = None,
                          init_latents: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """CFG DDIM sampling of latents [B, max_it, D] (float32)."""
        B = text_emb_cond.shape[0]
        D = self.latent_dim[-1]
        dev = self.device
        lengths = lengths.to(dev)
        lat_valid = latent_valid_mask(lengths, self.frame_per_latent,
                                      self.max_it)
        steps = num_inference_timesteps or self.num_inference_timesteps
        den = self.denoiser
        text_cond = den.project_text(text_emb_cond.to(dev))
        text_uncond = den.project_text(text_emb_uncond.to(dev))
        ts, _ = ddim_timesteps(self.schedule.num_train_timesteps, steps, 1)
        time_table = den.compute_time_embedding(
            torch.as_tensor(ts.astype(np.int64), device=dev))
        text2 = (torch.cat([text_uncond, text_cond], dim=0)
                 if self.guidance_scale > 1.0 else text_cond)
        prep_all = den.precompute_md_prep(text2, time_table)

        def denoise(latents, step, text, valid):
            time_emb = time_table[step][None].expand(latents.shape[0], -1)
            md_prep = [{"value": p["value"], "ca_ss": p["ca_ss"][step],
                        "ffn_ss": p["ffn_ss"][step]} for p in prep_all]
            return den(latents, latent_valid=valid, time_emb=time_emb,
                       text_emb_latent=text, md_prep=md_prep)

        guided = make_cfg_denoise_fn(denoise, text_uncond, text_cond,
                                     self.guidance_scale)
        return ddim_sample(guided, self.schedule, (B, self.max_it, D), steps,
                           latent_valid=lat_valid, generator=generator,
                           init_latents=init_latents, device=dev)

    @torch.no_grad()
    def generate(self, text_emb_cond: torch.Tensor,
                 text_emb_uncond: torch.Tensor, lengths: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 nframes: Optional[int] = None,
                 num_inference_timesteps: Optional[int] = None,
                 init_latents: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pooled text embeddings [B, 1, 768] -> (features [B, nframes,
        nfeats], latents [B, max_it, D])."""
        z = self.diffusion_reverse(text_emb_cond, text_emb_uncond, lengths,
                                   generator, num_inference_timesteps,
                                   init_latents)
        feats = self.vae.decode(z.to(self.dtype), lengths.to(self.device),
                                nframes or self.max_frames)
        return feats, z

    def vae_forward(self, batch: Dict[str, torch.Tensor], train: bool = True,
                    generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None):
        """Stage-1 reconstruction pass and its losses: returns
        ``(total, (logs, aux))``.  ``batch``: "motion" [B, T, nfeats] and
        "length" [B].  ``train`` switches the VAE's mode (dropout, the
        training kernels); differentiable in the VAE's parameters when
        ``train``; the VAE's mode is restored afterwards.  ``generator``
        drives dropout and, unless ``eps`` [B, max_it, D] is given, the
        latent sample."""
        dev = self.device
        feats_ref = batch["motion"].to(dev)
        lengths = batch["length"].to(dev)
        was_training = self.vae.training
        self.vae.train(train)
        try:
            z, mu, logvar, lat_valid = self.vae.encode(
                feats_ref, lengths, eps=eps, generator=generator)
            feats_rst = self.vae.decode(z, lengths, feats_ref.shape[1],
                                        generator=generator)
        finally:
            self.vae.train(was_training)
        joints_rst = self.feats2joints(feats_rst)
        joints_ref = self.feats2joints(feats_ref)
        total, logs = vae_loss(feats_rst, feats_ref, joints_rst, joints_ref,
                               mu, logvar, self.weights)
        aux = {"feats_rst": feats_rst, "z": z, "latent_valid": lat_valid,
               "joints_rst": joints_rst, "joints_ref": joints_ref}
        return total, (logs, aux)
