"""Progressive distillation of the denoiser (counterpart of
``ladiff_tpu/training/distill.py``; the ``distill`` training stage).

A student denoiser learns to take in one DDIM step of its S-step grid what
the frozen teacher takes in two steps of the 2S-step grid (Salimans & Ho
2022), with the teacher queried under the production classifier-free
guidance, so that the student samples at guidance 1 (no doubled batch).

One loss evaluation: a random position on the student's grid per sample,
the frozen encode (or the feature frames themselves, ``vae_type`` "no"),
``add_noise``, two guided teacher half-steps without a graph (eval mode:
the inference kernels), the x0 that one DDIM jump from x_t to the
teacher's end point implies (``ddim_solve_eps_x0``; at the grid's last
position, where the teacher's mid-point falls below 0, the x0 of the
teacher's one guided step), the student in training mode, and the squared
x0 error weighted by the truncated SNR max(SNR, 1).  Inactive latent rows
are zeroed only where the system is length-aware (``lad``).  The teacher's
half-steps go through the system's schedule, so with ``PREDICT_EPSILON``
false they read its outputs as clean latents; the one-step target and the
student's x0 read the outputs as noise whatever the prediction type, as
the JAX package's distill does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ladiff_torch.diffusion.schedulers import ddim_solve_eps_x0
from ladiff_torch.models.ladiff import LADiffSystem, _mode
from ladiff_torch.utils.masks import lengths_to_mask

__all__ = ["distill_forward"]


def _teacher_guided_eps(system: LADiffSystem, teacher: nn.Module,
                        x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                        uncond: torch.Tensor,
                        lat_valid: Optional[torch.Tensor],
                        frame_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The teacher's epsilon (float32) under the system's guidance: one
    call on the doubled batch [uncond; cond] with per-sample timesteps."""
    if system.guidance_scale <= 1.0:
        return teacher(x, t, cond, lat_valid, frame_valid=frame_valid).float()
    two = lambda v: None if v is None else torch.cat([v, v], dim=0)
    cond2 = torch.cat([uncond.to(cond.dtype).expand(cond.shape), cond], dim=0)
    eps = teacher(two(x), two(t), cond2, two(lat_valid),
                  frame_valid=two(frame_valid)).float()
    eps_u, eps_c = eps.chunk(2, dim=0)
    return eps_u + system.guidance_scale * (eps_c - eps_u)


def distill_forward(system: LADiffSystem, student: nn.Module,
                    teacher: nn.Module, batch: Dict[str, torch.Tensor],
                    uncond_emb: torch.Tensor, student_steps: int,
                    train: bool = True,
                    generator: Optional[torch.Generator] = None,
                    i: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None):
    """One progressive-distillation loss: returns ``(total, (logs,
    aux))`` with logs ``distill_x0``, ``raw_x0_mse``, ``total``.

    ``student`` and ``teacher`` are denoisers of ``system``'s shape; the
    system gives the frozen VAE and the schedule.  ``student_steps`` S must
    divide the training grid with an even ratio.  ``train`` switches the
    student's mode (dropout, the training routes); both modes are restored
    afterwards.  Every draw comes from ``generator`` on the system's device
    unless given: ``i`` [B] the grid positions in 0 .. S - 1, ``noise`` the
    forward process's, ``eps`` [B, n_latents, D] the encode's; the student's
    dropout always comes from ``generator``."""
    schedule = system.schedule
    N, S = schedule.num_train_timesteps, int(student_steps)
    ratio = N // S
    if S * ratio != N or ratio % 2:
        raise ValueError(
            f"student_steps={S} must divide num_train_timesteps={N} with an "
            "even step ratio (the teacher runs the 2S grid)")
    dev = system.device
    feats_ref = batch["motion"].to(dev)
    lengths = batch["length"].to(dev)
    cond = batch["text_emb"].to(dev)
    uncond = uncond_emb.to(dev)
    B = feats_ref.shape[0]
    if system.vae is None:
        z0, lat_valid = feats_ref.float(), None
        frame_valid = lengths_to_mask(lengths, feats_ref.shape[1])
    else:
        with _mode(system.vae, False), torch.no_grad():
            z0, _, _, lat_valid = system.vae.encode(
                feats_ref, lengths, eps=eps, generator=generator)
        z0, frame_valid = z0.float(), None

    def zero_invalid(x):
        if not (system.lad and lat_valid is not None):
            return x
        return torch.where(lat_valid[:, :, None], x,
                           torch.zeros((), dtype=x.dtype, device=dev))

    if i is None:
        i = torch.randint(0, S, (B,), generator=generator, device=dev)
    i = i.to(dev).long()
    t = (S - 1 - i) * ratio + 1
    t_mid = t - ratio // 2
    t_prev = t - ratio
    if noise is None:
        noise = torch.randn(z0.shape, generator=generator, device=dev)
    noise = noise.to(device=dev, dtype=z0.dtype)
    x_t = zero_invalid(schedule.add_noise(z0, noise, t))

    # the frozen teacher's two guided half-steps; at t = 1 the mid-point is
    # below 0: there the target is the teacher's one guided step, and the
    # second call runs at the clamped mid-point and is discarded
    t_mid_safe = t_mid.clamp_min(0)
    with _mode(teacher, False), torch.no_grad():
        eps1 = _teacher_guided_eps(system, teacher, x_t, t, cond, uncond,
                                   lat_valid, frame_valid)
        x_mid = zero_invalid(schedule.ddim_step(eps1, t, t_mid_safe, x_t))
        eps2 = _teacher_guided_eps(system, teacher, x_mid, t_mid_safe, cond,
                                   uncond, lat_valid, frame_valid)
        x_prev = zero_invalid(schedule.ddim_step(eps2, t_mid_safe, t_prev,
                                                 x_mid))
        a_t = schedule.table(dev)[t].reshape((B,) + (1,) * (x_t.dim() - 1))
        x0_two, _ = ddim_solve_eps_x0(schedule, x_t, x_prev, t, t_prev)
        x0_one = (x_t - (1.0 - a_t).sqrt() * eps1) / a_t.sqrt()
        last = (t_mid < 0).reshape(a_t.shape)
        x0_target = zero_invalid(torch.where(last, x0_one, x0_two))

    with _mode(student, train):
        eps_student = student(x_t, t, cond, lat_valid, generator=generator,
                              frame_valid=frame_valid).float()
    x0_student = zero_invalid(
        (x_t - (1.0 - a_t).sqrt() * eps_student) / a_t.sqrt())
    sq = (x0_student - x0_target) ** 2
    total = (torch.clamp(a_t / (1.0 - a_t), min=1.0) * sq).mean()
    logs = {"distill_x0": total, "raw_x0_mse": sq.mean().detach(),
            "total": total}
    return total, (logs, {"latent_valid": lat_valid, "t": t})
