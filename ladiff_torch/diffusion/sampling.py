"""Diffusion sampling loops (counterpart of
``ladiff_tpu/diffusion/sampling.py``): classifier-free guidance with the
batch doubled to [uncond; cond], and a reverse loop (DDIM, eta 0 or above,
or ancestral DDPM) that re-zeroes inactive latent rows after every step and
can keep every step's latents."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ladiff_torch.diffusion.schedulers import (DiffusionSchedule,
                                               ddim_timesteps)

__all__ = ["ddim_sample", "make_cfg_denoise_fn"]


def make_cfg_denoise_fn(denoise_fn: Callable[..., torch.Tensor],
                        text_emb_uncond: torch.Tensor,
                        text_emb_cond: torch.Tensor,
                        guidance_scale: float):
    """``denoise_fn(latents, step, text, valid)`` -> eps; returns a guided
    ``fn(latents, step, valid)`` that runs one denoiser call on 2B."""
    do_cfg = guidance_scale > 1.0
    text2 = (torch.cat([text_emb_uncond, text_emb_cond], dim=0)
             if do_cfg else text_emb_cond)

    def fn(latents: torch.Tensor, step: int,
           latent_valid: Optional[torch.Tensor]) -> torch.Tensor:
        if not do_cfg:
            return denoise_fn(latents, step, text2, latent_valid).float()
        B = latents.shape[0]
        valid = (None if latent_valid is None
                 else torch.cat([latent_valid, latent_valid], dim=0))
        out = denoise_fn(torch.cat([latents, latents], dim=0), step, text2,
                         valid).float()
        eps_uncond, eps_text = out[:B], out[B:]
        return eps_uncond + guidance_scale * (eps_text - eps_uncond)

    return fn


def ddim_sample(guided_denoise_fn, schedule: DiffusionSchedule, shape: tuple,
                num_inference_steps: int, *,
                latent_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                init_latents: Optional[torch.Tensor] = None,
                device: Optional[torch.device] = None,
                steps_offset: int = 1, eta: float = 0.0, kind: str = "ddim",
                return_trajectory: bool = False):
    """The reverse process over float32 latents ``shape``.

    ``kind``: "ddim" (deterministic at ``eta`` 0) or "ddpm" (ancestral, on
    the grid without the offset).  The initial noise comes from
    ``init_latents`` when given (the tests hand in the JAX package's noise),
    else from ``generator``, as does each step's noise of DDPM or of DDIM
    with eta > 0.  Rows that ``latent_valid`` marks inactive stay exactly
    zero through every step.  With ``return_trajectory`` it returns
    (latents, every step's latents [steps, *shape])."""
    if kind not in ("ddim", "ddpm"):
        raise ValueError(f"unknown sampler kind {kind}")
    if init_latents is None:
        latents = torch.randn(shape, generator=generator, device=device,
                              dtype=torch.float32)
    else:
        latents = init_latents.to(device=device, dtype=torch.float32)
    latents = latents * schedule.init_noise_sigma
    keep = None if latent_valid is None else latent_valid[:, :, None]
    if keep is not None:
        latents = torch.where(keep, latents, torch.zeros_like(latents))
    ts, prev_ts = ddim_timesteps(schedule.num_train_timesteps,
                                 num_inference_steps,
                                 steps_offset if kind == "ddim" else 0)
    trajectory = []
    for i, (t, t_prev) in enumerate(zip(ts.tolist(), prev_ts.tolist())):
        eps = guided_denoise_fn(latents, i, latent_valid)
        noise = None
        if kind == "ddpm" or eta > 0.0:
            noise = torch.randn(latents.shape, generator=generator,
                                device=latents.device, dtype=latents.dtype)
        if kind == "ddpm":
            latents = schedule.ddpm_step(eps, t, latents, noise,
                                         prev_timestep=t_prev)
        else:
            latents = schedule.ddim_step(eps, t, t_prev, latents, eta=eta,
                                         noise=noise)
        if keep is not None:
            latents = torch.where(keep, latents, torch.zeros_like(latents))
        if return_trajectory:
            trajectory.append(latents)
    if return_trajectory:
        return latents, torch.stack(trajectory)
    return latents
