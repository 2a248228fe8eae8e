"""Diffusion schedules as alpha tables (counterpart of
``ladiff_tpu/diffusion/schedulers.py``): ``linear``, ``scaled_linear`` and
``squaredcos_cap_v2`` betas; ``epsilon``, ``sample`` and ``v_prediction``
outputs; the DDIM step (eta 0 or above, the noise passed in), the ancestral
DDPM step, the forward process ``add_noise`` of denoiser training, and the
inversion of one DDIM jump (``ddim_solve_eps_x0``).  A sampling loop's
timesteps are host ints, so its coefficients are host floats; the DDIM step
also takes per-sample [B] integer tensors (the distillation step), whose
coefficients are gathered from the alpha table on the sample's device."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["DiffusionSchedule", "make_schedule", "ddim_timesteps",
           "ddim_solve_eps_x0"]


def _make_betas(num_train_timesteps: int, beta_start: float, beta_end: float,
                beta_schedule: str) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    if beta_schedule == "scaled_linear":
        # sqrt-space linspace, squared (diffusers semantics)
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        def abar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(num_train_timesteps, dtype=np.float64)
        return np.minimum(1 - abar((ts + 1) / num_train_timesteps)
                          / abar(ts / num_train_timesteps), 0.999)
    raise ValueError(f"unknown beta schedule {beta_schedule}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    alphas_cumprod: np.ndarray      # [N] float32
    final_alpha_cumprod: float      # acp[0] when set_alpha_to_one=False
    num_train_timesteps: int
    prediction_type: str = "epsilon"

    # the alpha table on each device it was asked for (add_noise runs every
    # training step and must not copy from the host each time)
    _tables: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    init_noise_sigma = 1.0

    def table(self, device: torch.device) -> torch.Tensor:
        """``alphas_cumprod`` as a float32 tensor on ``device``."""
        table = self._tables.get(device)
        if table is None:
            table = torch.as_tensor(self.alphas_cumprod, device=device)
            self._tables[device] = table
        return table

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) sampling (diffusers ``add_noise``): ``timesteps``
        [B] integers on x0's device, one per sample."""
        acp = self.table(x0.device)[timesteps]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        sqrt_acp = acp.sqrt().reshape(shape).to(x0.dtype)
        sqrt_1macp = (1.0 - acp).sqrt().reshape(shape).to(x0.dtype)
        return sqrt_acp * x0 + sqrt_1macp * noise

    def _alpha(self, timestep: Union[int, torch.Tensor], before_zero: float,
               like: torch.Tensor):
        """acp[timestep] as a host float, ``before_zero`` for a timestep
        below 0; for a [B] tensor of timesteps a float32 tensor [B, 1, ...]
        that broadcasts against ``like``."""
        if isinstance(timestep, torch.Tensor):
            table = self.table(like.device)
            t = timestep.to(like.device)
            a = torch.where(t >= 0, table[t.clamp_min(0)],
                            torch.full_like(table[:1], before_zero))
            return a.reshape((-1,) + (1,) * (like.dim() - 1))
        if timestep < 0:
            return before_zero
        return float(self.alphas_cumprod[timestep])

    def _predict_x0_eps(self, model_output: torch.Tensor,
                        sample: torch.Tensor, a_t):
        """(x0, eps) from the model's output at a timestep of acp a_t."""
        sa, sb = _sqrt(a_t), _sqrt(1.0 - a_t)
        if self.prediction_type == "epsilon":
            x0 = (sample - sb * model_output) / sa
            eps = model_output
        elif self.prediction_type == "sample":
            x0 = model_output
            eps = (sample - sa * x0) / sb
        elif self.prediction_type == "v_prediction":
            x0 = sa * sample - sb * model_output
            eps = sa * model_output + sb * sample
        else:
            raise ValueError(f"unknown prediction type {self.prediction_type}")
        return x0, eps

    def ddim_step(self, model_output: torch.Tensor,
                  timestep: Union[int, torch.Tensor],
                  prev_timestep: Union[int, torch.Tensor],
                  sample: torch.Tensor, eta: float = 0.0,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One DDIM update x_t -> x_{t-dt} (diffusers ``DDIMScheduler.step``);
        with ``eta`` > 0 it adds ``sigma * noise``, the caller's draw.  The
        timesteps are host ints or [B] integer tensors, one per sample; a
        previous timestep below 0 takes ``final_alpha_cumprod``."""
        a_t = self._alpha(timestep, self.final_alpha_cumprod, sample)
        a_prev = self._alpha(prev_timestep, self.final_alpha_cumprod, sample)
        x0, eps = self._predict_x0_eps(model_output, sample, a_t)
        sigma = 0.0
        if eta > 0.0:
            if noise is None:
                raise ValueError("ddim_step with eta > 0 needs the noise")
            sigma = eta * _sqrt((1.0 - a_prev) / (1.0 - a_t)
                                * (1.0 - a_t / a_prev))
        prev = _sqrt(a_prev) * x0 + _sqrt(1.0 - a_prev - sigma ** 2) * eps
        if eta > 0.0:
            prev = prev + sigma * noise
        return prev

    def ddpm_step(self, model_output: torch.Tensor, timestep: int,
                  sample: torch.Tensor, noise: torch.Tensor,
                  prev_timestep: Optional[int] = None) -> torch.Tensor:
        """One ancestral DDPM update (diffusers ``DDPMScheduler.step``,
        fixed-small variance) with the effective beta of a jump of several
        steps: ``prev_timestep`` defaults to t - 1, the full grid; ``noise``
        is the caller's draw, unused at t = 0."""
        t = timestep
        t_prev = t - 1 if prev_timestep is None else prev_timestep
        a_t = self._alpha(t, 1.0, sample)
        a_prev = self._alpha(t_prev, 1.0, sample)
        alpha_jump = a_t / a_prev
        beta_t = 1.0 - alpha_jump
        beta_prod_t = 1.0 - a_t
        x0, _ = self._predict_x0_eps(model_output, sample, a_t)
        coef_x0 = math.sqrt(a_prev) * beta_t / beta_prod_t
        coef_xt = math.sqrt(alpha_jump) * (1.0 - a_prev) / beta_prod_t
        mean = coef_x0 * x0 + coef_xt * sample
        variance = max((1.0 - a_prev) / beta_prod_t * beta_t, 1e-20)
        return mean + math.sqrt(variance) * noise if t > 0 else mean


def _sqrt(v):
    """sqrt of a table value, rounded through float32 like the tables (a
    tensor's own sqrt)."""
    if isinstance(v, torch.Tensor):
        return v.sqrt()
    return float(np.sqrt(np.float32(v)))


def make_schedule(num_train_timesteps: int = 1000,
                  beta_start: float = 0.00085, beta_end: float = 0.012,
                  beta_schedule: str = "scaled_linear",
                  prediction_type: str = "epsilon",
                  set_alpha_to_one: bool = False) -> DiffusionSchedule:
    betas = _make_betas(num_train_timesteps, beta_start, beta_end,
                        beta_schedule)
    acp = np.cumprod(1.0 - betas)
    final = 1.0 if set_alpha_to_one else float(np.float32(acp[0]))
    return DiffusionSchedule(alphas_cumprod=acp.astype(np.float32),
                             final_alpha_cumprod=final,
                             num_train_timesteps=num_train_timesteps,
                             prediction_type=prediction_type)


def ddim_solve_eps_x0(schedule: DiffusionSchedule, x_t: torch.Tensor,
                      x_next: torch.Tensor, t: torch.Tensor,
                      t_next: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unique (x0, eps) consistent with both states of one DDIM jump:

        x_t    = sqrt(a_t)    x0 + sqrt(1 - a_t)    eps
        x_next = sqrt(a_next) x0 + sqrt(1 - a_next) eps

    (the progressive-distillation target).  ``t`` / ``t_next`` are [B]
    integer tensors on x_t's device; ``t_next`` < 0 takes the schedule's
    final_alpha_cumprod, as ``ddim_step`` does."""
    a_t = schedule._alpha(t, schedule.final_alpha_cumprod, x_t)
    a_n = schedule._alpha(t_next, schedule.final_alpha_cumprod, x_t)
    sa_t, sb_t = a_t.sqrt(), (1.0 - a_t).sqrt()
    sa_n, sb_n = a_n.sqrt(), (1.0 - a_n).sqrt()
    det = sa_n * sb_t - sa_t * sb_n  # > 0 whenever a_next > a_t
    eps = (sa_n * x_t - sa_t * x_next) / det
    x0 = (sb_t * x_next - sb_n * x_t) / det
    return x0, eps


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int,
                   steps_offset: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Descending timestep grid and the previous-step grid."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
    ts = ts.astype(np.int32) + steps_offset
    return ts, ts - step_ratio
