"""Diffusion schedules as alpha tables (counterpart of
``ladiff_tpu/diffusion/schedulers.py``): scaled-linear betas, DDIM with
``set_alpha_to_one=False``, ``steps_offset=1`` and eta 0, and the forward
process ``add_noise`` of denoiser training."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["DiffusionSchedule", "make_schedule", "ddim_timesteps"]


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

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) sampling (diffusers ``add_noise``): ``timesteps``
        [B] integers on x0's device, one per sample."""
        table = self._tables.get(x0.device)
        if table is None:
            table = torch.as_tensor(self.alphas_cumprod, device=x0.device)
            self._tables[x0.device] = table
        acp = table[timesteps]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        sqrt_acp = acp.sqrt().reshape(shape).to(x0.dtype)
        sqrt_1macp = (1.0 - acp).sqrt().reshape(shape).to(x0.dtype)
        return sqrt_acp * x0 + sqrt_1macp * noise

    def ddim_step(self, model_output: torch.Tensor, timestep: int,
                  prev_timestep: int, sample: torch.Tensor) -> torch.Tensor:
        """One deterministic (eta 0) DDIM update x_t -> x_{t-dt}
        (diffusers ``DDIMScheduler.step``); timesteps are host ints."""
        a_t = float(self.alphas_cumprod[timestep])
        a_prev = (float(self.alphas_cumprod[prev_timestep])
                  if prev_timestep >= 0 else self.final_alpha_cumprod)
        if self.prediction_type == "epsilon":
            x0 = (sample - _sqrt(1.0 - a_t) * model_output) / _sqrt(a_t)
            eps = model_output
        elif self.prediction_type == "sample":
            x0 = model_output
            eps = (sample - _sqrt(a_t) * x0) / _sqrt(1.0 - a_t)
        else:
            raise ValueError(f"unknown prediction type {self.prediction_type}")
        return _sqrt(a_prev) * x0 + _sqrt(1.0 - a_prev) * eps


def _sqrt(v: float) -> float:
    """sqrt of a table value, rounded through float32 like the tables."""
    return float(np.sqrt(np.float32(v)))


def make_schedule(num_train_timesteps: int = 1000,
                  beta_start: float = 0.00085, beta_end: float = 0.012,
                  prediction_type: str = "epsilon",
                  set_alpha_to_one: bool = False) -> DiffusionSchedule:
    """Scaled-linear betas (sqrt-space linspace, squared)."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    final = 1.0 if set_alpha_to_one else float(np.float32(acp[0]))
    return DiffusionSchedule(alphas_cumprod=acp.astype(np.float32),
                             final_alpha_cumprod=final,
                             num_train_timesteps=num_train_timesteps,
                             prediction_type=prediction_type)


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int,
                   steps_offset: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Descending timestep grid and the previous-step grid."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
    ts = ts.astype(np.int32) + steps_offset
    return ts, ts - step_ratio
