"""Training steps (counterpart of ``ladiff_tpu/training/trainer.py``), the
stage-1 (LA-VAE) step.

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

__all__ = ["make_optimizer", "global_norm", "vae_train_step"]


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
