"""Training steps (counterpart of ``ladiff_tpu/training/trainer.py``):
stage 1 (``vae_train_step``, the LA-VAE), stage 2 (``diffusion_train_step``,
the denoiser against the frozen VAE; its autoregressive form for an
``ardiff`` system), the joint stage (``vae_diffusion_train_step``, both
trees) and progressive distillation (``distill_train_step``, the student
denoiser against a frozen teacher, ``training/distill.py``).  Which
parameters a step trains is the optimizer's business: stage 1 holds
``system.vae.parameters()``, stages 2 and distill
``system.denoiser.parameters()``, the joint stage ``system.parameters()``.

Optimizer: ``torch.optim.AdamW`` with lr 1e-4, betas (0.9, 0.999), eps 1e-8,
weight decay 1e-2, the same update as the JAX package's ``optax.adamw``;
an optional global-norm clip scales the gradients by
``clip / max(norm, clip)`` first.

Mixed precision: the system is built with ``param_dtype=torch.float32`` and
a bf16 compute type, so parameters, gradients and both AdamW moments are
float32 while activations are bf16.  The casts are explicit, not
``torch.autocast``: every plain product casts its weight to the
activation's type (``ops/transformer.py`` ``linear`` / ``layer_norm``,
``ops/attention.py``), and the training kernels' ``autograd.Function``s
cast the float32 weights to bf16 on the way in and return float32
gradients.  Losses reduce in float32 (``losses/mld.py``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from ladiff_torch.models.ladiff import LADiffSystem
from ladiff_torch.training.distill import distill_forward

__all__ = ["make_optimizer", "global_norm", "vae_train_step",
           "diffusion_train_step", "vae_diffusion_train_step",
           "distill_train_step"]


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                   weight_decay: float = 1e-2,
                   grad_clip: Optional[float] = None) -> torch.optim.AdamW:
    """AdamW over ``params``; ``grad_clip`` is applied by the train step."""
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    opt.grad_clip = grad_clip
    return opt


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The l2 norm over all gradients, in float32."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def _update(optimizer: torch.optim.Optimizer, total: torch.Tensor,
            logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Backward of ``total``, optional global-norm clip, AdamW update.
    Returns the logs (detached scalars) with ``grad_norm``, the norm before
    clipping."""
    total.backward()
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    norm = global_norm(grads)
    clip = getattr(optimizer, "grad_clip", None)
    if clip:
        scale = clip / torch.clamp(norm, min=clip)
        for g in grads:
            g.mul_(scale.to(g.dtype))
    optimizer.step()
    logs = {k: v.detach() for k, v in logs.items()}
    logs["grad_norm"] = norm.detach()
    return logs


def vae_train_step(system: LADiffSystem, optimizer: torch.optim.Optimizer,
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """One stage-1 step on ``batch`` ("motion", "length"): loss, gradients
    of the VAE's parameters, optional clip, AdamW update.  Returns the logs
    (detached scalars) including ``grad_norm``, the norm before clipping."""
    optimizer.zero_grad(set_to_none=True)
    total, (logs, _) = system.vae_forward(batch, train=True,
                                          generator=generator, eps=eps)
    return _update(optimizer, total, logs)


def diffusion_train_step(system: LADiffSystem,
                         optimizer: torch.optim.Optimizer,
                         batch: Dict[str, torch.Tensor],
                         uncond_emb: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         **draws: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One stage-2 step on ``batch`` ("motion", "length", "text_emb"): the
    denoiser's noise-prediction loss with the VAE frozen (no VAE parameter
    gets a gradient), optional clip, AdamW update.  ``draws`` are
    ``diffusion_forward``'s optional tensors (``noise``, ``timesteps``,
    ``cond_drop``, ``eps``), or ``diffusion_forward_ar``'s for an
    ``ardiff`` system (also ``latent_idx``, ``coin``)."""
    optimizer.zero_grad(set_to_none=True)
    forward = (system.diffusion_forward_ar if system.ardiff
               else system.diffusion_forward)
    total, (logs, _) = forward(batch, uncond_emb, train=True,
                               generator=generator, **draws)
    return _update(optimizer, total, logs)


def vae_diffusion_train_step(system: LADiffSystem,
                             optimizer: torch.optim.Optimizer,
                             batch: Dict[str, torch.Tensor],
                             uncond_emb: torch.Tensor,
                             generator: Optional[torch.Generator] = None
                             ) -> Dict[str, torch.Tensor]:
    """One joint-stage step on ``batch`` ("motion", "length", "text_emb"):
    reconstruction, noise-prediction and generation losses together,
    gradients of both trees, optional clip, AdamW update."""
    optimizer.zero_grad(set_to_none=True)
    total, (logs, _) = system.vae_diffusion_forward(
        batch, uncond_emb, train=True, generator=generator)
    return _update(optimizer, total, logs)


def distill_train_step(system: LADiffSystem, teacher: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       batch: Dict[str, torch.Tensor],
                       uncond_emb: torch.Tensor, student_steps: int,
                       generator: Optional[torch.Generator] = None,
                       **draws: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One progressive-distillation step on ``batch`` ("motion", "length",
    "text_emb"): the student (``system.denoiser``, whose parameters the
    optimizer holds) against the frozen ``teacher`` denoiser and VAE,
    optional clip, AdamW update.  ``draws`` are ``distill_forward``'s
    optional tensors (``i``, ``noise``, ``eps``)."""
    optimizer.zero_grad(set_to_none=True)
    total, (logs, _) = distill_forward(
        system, system.denoiser, teacher, batch, uncond_emb, student_steps,
        train=True, generator=generator, **draws)
    return _update(optimizer, total, logs)
