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
gradients.  Losses reduce in float32 (``losses/mld.py``).  Without mixed
precision (the published configurations) the same Functions run their
float32 chains on the card, with nothing to cast.

Parallel layouts (counterpart of ``_jit_step``'s meshes): ``StageLoss`` is
one stage's loss as a module whose only registered child is the trained
tree (the frozen VAE of stage 2 and the distill teacher stay outside it),
and ``make_parallel_step`` wraps it for a layout on a ``("data", "model")``
mesh: ``DistributedDataParallel`` over the ``data`` dim (DP), FSDP2 over it
(``parallel/fsdp.py``), tensor parallelism over ``model`` with DDP over
``data`` (``parallel/tp.py``), or sequence parallelism over ``model`` with
DDP over the world (``parallel/sp.py``).  Each rank takes its rows of the
global batch and of the step's draws (``global_draws``), and the logs are
the global values, all-reduced.  ``grad_norm`` and the clip read the
global norm under every layout: FSDP's and TP's gradients are shards, whose
squares are summed over their group.  The pipeline layout's step is
``parallel/pp.py``'s.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from ladiff_torch.models.ladiff import LADiffSystem
from ladiff_torch.training.distill import distill_forward

__all__ = ["make_optimizer", "global_norm", "vae_train_step",
           "diffusion_train_step", "vae_diffusion_train_step",
           "distill_train_step", "StageLoss", "stage_step", "global_draws",
           "parallel_grad_norm", "make_parallel_step", "LAYOUTS"]

LAYOUTS = ("dp", "fsdp", "tp", "sp")


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


def parallel_grad_norm(params: Iterable[torch.nn.Parameter], group=None
                       ) -> torch.Tensor:
    """The l2 norm over the whole gradient, in float32, where some
    gradients are shards: FSDP2's ``DTensor`` gradients and those of
    tensor-parallel parameters (``tp_dim``) have their squares summed over
    ``group`` (the mesh dim they are sharded on); the others are whole on
    every rank."""
    from torch.distributed.tensor import DTensor
    whole, shards = [], []
    for p in params:
        g = p.grad
        if isinstance(g, DTensor):
            shards.append(g.to_local())
        elif getattr(p, "tp_dim", None) is not None:
            shards.append(g)
        else:
            whole.append(g)
    dev = (whole or shards)[0].device
    sq = lambda gs: sum(((g.float() ** 2).sum() for g in gs),
                        torch.zeros((), device=dev))
    local = torch.stack([sq(whole), sq(shards)])
    if shards and group is not None:
        part = local[1:].clone()
        dist.all_reduce(part, group=group)
        local = torch.cat([local[:1], part])
    return torch.sqrt(local.sum())


def _update(optimizer: torch.optim.Optimizer, total: torch.Tensor,
            logs: Dict[str, torch.Tensor],
            after_backward: Optional[Callable[[], None]] = None,
            norm_fn: Callable = None) -> Dict[str, torch.Tensor]:
    """Backward of ``total``, ``after_backward`` (a layout's gradient
    reduction), optional global-norm clip, AdamW update.  Returns the logs
    (detached scalars) with ``grad_norm``, the norm before clipping
    (``norm_fn`` of the parameters with a gradient, ``global_norm`` of
    their gradients by default)."""
    from torch.distributed.tensor import DTensor
    total.backward()
    if after_backward is not None:
        after_backward()
    params = [p for group in optimizer.param_groups
              for p in group["params"] if p.grad is not None]
    norm = (global_norm([p.grad for p in params]) if norm_fn is None
            else norm_fn(params))
    clip = getattr(optimizer, "grad_clip", None)
    if clip:
        scale = clip / torch.clamp(norm, min=clip)
        for p in params:
            g = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
            g.mul_(scale.to(g.dtype))
    optimizer.step()
    logs = {k: v.detach() for k, v in logs.items()}
    logs["grad_norm"] = norm.detach()
    return logs


def stage_step(optimizer: torch.optim.Optimizer, loss: "StageLoss",
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               **draws) -> Dict[str, torch.Tensor]:
    """One step of a stage on one device: ``loss`` (a ``StageLoss``) on
    ``batch``, its backward, optional clip, AdamW update; the logs with
    ``grad_norm``."""
    optimizer.zero_grad(set_to_none=True)
    total, logs = loss(batch, generator=generator, **draws)
    return _update(optimizer, total, logs)


def vae_train_step(system: LADiffSystem, optimizer: torch.optim.Optimizer,
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """One stage-1 step on ``batch`` ("motion", "length"): loss, gradients
    of the VAE's parameters, optional clip, AdamW update.  Returns the logs
    (detached scalars) including ``grad_norm``, the norm before clipping."""
    return stage_step(optimizer, StageLoss(system, "vae"), batch,
                      generator, eps=eps)


def diffusion_train_step(system: LADiffSystem,
                         optimizer: torch.optim.Optimizer,
                         batch: Dict[str, torch.Tensor],
                         uncond_emb: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         **draws: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One stage-2 step on ``batch`` ("motion", "length", and "text_emb" or,
    for the action condition, "action" class ids): the denoiser's
    noise-prediction loss with the VAE frozen (no VAE parameter gets a
    gradient), optional clip, AdamW update.  ``draws`` are
    ``diffusion_forward``'s optional tensors (``noise``, ``timesteps``,
    ``cond_drop``, ``eps``), or ``diffusion_forward_ar``'s for an
    ``ardiff`` system (also ``latent_idx``, ``coin``)."""
    return stage_step(optimizer, StageLoss(system, "diffusion", uncond_emb),
                      batch, generator, **draws)


def vae_diffusion_train_step(system: LADiffSystem,
                             optimizer: torch.optim.Optimizer,
                             batch: Dict[str, torch.Tensor],
                             uncond_emb: torch.Tensor,
                             generator: Optional[torch.Generator] = None
                             ) -> Dict[str, torch.Tensor]:
    """One joint-stage step on ``batch`` ("motion", "length", "text_emb"):
    reconstruction, noise-prediction and generation losses together,
    gradients of both trees, optional clip, AdamW update."""
    return stage_step(optimizer,
                      StageLoss(system, "vae_diffusion", uncond_emb),
                      batch, generator)


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
    return stage_step(optimizer, StageLoss(system, "distill", uncond_emb,
                                           teacher, student_steps),
                      batch, generator, **draws)


class StageLoss(nn.Module):
    """One training stage's loss as a module: ``forward(batch,
    generator=None, **draws)`` -> (total, logs).  Its one registered child,
    ``trained``, is the tree the stage trains (``system.vae`` in stage
    ``vae``, ``system.denoiser`` in ``diffusion`` and ``distill``, the whole
    system in ``vae_diffusion``), so a wrapper (DDP, FSDP2) sees exactly the
    trained parameters; the frozen VAE of stage 2 and the distill
    ``teacher`` are held outside it.  ``draws`` are the stage's forward's
    optional tensors (``global_draws``)."""

    def __init__(self, system: LADiffSystem, stage: str,
                 uncond_emb: Optional[torch.Tensor] = None,
                 teacher: Optional[nn.Module] = None,
                 student_steps: Optional[int] = None):
        super().__init__()
        if stage not in ("vae", "diffusion", "vae_diffusion", "distill"):
            raise ValueError(f"unsupported stage {stage}")
        self.stage = stage
        self.trained = (system.vae if stage == "vae" else system
                        if stage == "vae_diffusion" else system.denoiser)
        # plain attributes, not children: the wrappers must not see them
        object.__setattr__(self, "system", system)
        object.__setattr__(self, "teacher", teacher)
        self.uncond_emb, self.student_steps = uncond_emb, student_steps

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, **draws):
        s = self.system
        if self.stage == "vae":
            total, (logs, _) = s.vae_forward(batch, train=True,
                                             generator=generator, **draws)
        elif self.stage == "diffusion":
            forward = s.diffusion_forward_ar if s.ardiff else \
                s.diffusion_forward
            total, (logs, _) = forward(batch, self.uncond_emb, train=True,
                                       generator=generator, **draws)
        elif self.stage == "vae_diffusion":
            total, (logs, _) = s.vae_diffusion_forward(
                batch, self.uncond_emb, train=True, generator=generator,
                **draws)
        else:
            total, (logs, _) = distill_forward(
                s, s.denoiser, self.teacher, batch, self.uncond_emb,
                self.student_steps, train=True, generator=generator, **draws)
        return total, logs


def global_draws(system: LADiffSystem, stage: str, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 student_steps: Optional[int] = None,
                 frames: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Every draw of one step of ``stage`` for the global batch, from
    ``generator`` on the system's device, by the names the stage's forward
    takes: ``eps`` (the encode's sample noise), ``cond_drop``, ``noise``,
    ``timesteps``; ``latent_u`` and ``coin`` for an ``ardiff`` system;
    ``i`` for distill; the joint stage's ``diffusion_draws`` and
    ``init_latents``.  Each rank keeps its rows (``parallel/mesh.py``
    ``take_rows``), so a step's result does not depend on the world size.
    ``frames``: the batch's frame count, for feature-space diffusion's
    noise [B, frames, nfeats].  Dropout and the DVAE corruption draw from
    the generator passed to the forward instead, on each rank."""
    B = int(batch_size)
    g = {"generator": generator, "device": system.device}
    D = system.latent_dim[-1]
    lat = (B, system.n_latents, D)
    feat = (B, frames, system.nfeats)

    def eps():
        return {} if system.vae is None else {"eps": torch.randn(lat, **g)}

    def diffusion():
        d = eps()
        if system.guidance_uncondp > 0.0:
            d["cond_drop"] = (torch.rand((B, 1, 1), **g)
                              < system.guidance_uncondp)
        if system.ardiff:
            d["latent_u"] = torch.rand((B,), **g)
            d["coin"] = torch.rand((), **g) < 1.0 / 3
            d["noise"] = torch.randn((B, 1, D), **g)
        else:
            d["noise"] = torch.randn(lat if system.vae is not None else feat,
                                     **g)
        d["timesteps"] = torch.randint(
            0, system.schedule.num_train_timesteps, (B,), **g)
        return d

    if stage == "vae":
        return eps()
    if stage == "diffusion":
        return diffusion()
    if stage == "vae_diffusion":
        return {**eps(), "diffusion_draws": diffusion(),
                "init_latents": torch.randn(lat, **g)}
    if stage == "distill":
        return {"i": torch.randint(0, int(student_steps), (B,), **g),
                "noise": torch.randn(lat if system.vae is not None else feat,
                                     **g), **eps()}
    raise ValueError(f"unsupported stage {stage}")


def make_parallel_step(system: LADiffSystem, stage: str, layout: str, mesh,
                       optimizer_factory: Optional[Callable] = None,
                       uncond_emb: Optional[torch.Tensor] = None,
                       teacher: Optional[nn.Module] = None,
                       student_steps: Optional[int] = None):
    """One stage's training step under ``layout`` ("dp", "fsdp", "tp" or
    "sp") on ``mesh`` (``parallel/mesh.make_mesh``; the ``model`` dim is
    the TP or SP width). Wraps the stage's ``StageLoss`` (sharding the
    trained tree in place for "fsdp" and "tp") and builds the optimizer
    over the resulting parameters with ``optimizer_factory(params)``
    (``make_optimizer``, AdamW at lr 1e-4, by default). Returns ``(step,
    optimizer, module)``: ``step(batch, generator=None,
    dropout_generator=None, draws=None)`` takes the global (padded)
    batch, draws the step's ``global_draws`` from ``generator`` unless
    ``draws`` are given, runs this rank's rows and returns the global
    logs with ``grad_norm``."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    from ladiff_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                            all_reduce_mean, shard_batch)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of "
                         f"{LAYOUTS}")
    module = StageLoss(system, stage, uncond_emb, teacher, student_steps)
    data_group, model_group = (mesh.get_group(DATA_AXIS),
                               mesh.get_group(MODEL_AXIS))
    dev = system.device
    # the denoiser's collapsed cross-attention (query, key, norm) gets no
    # gradient with one text token
    ddp_kw = dict(find_unused_parameters=stage != "vae",
                  device_ids=[dev.index] if dev.type == "cuda" else None)
    scope, shard_group = contextlib.nullcontext, None
    if layout == "fsdp":
        from ladiff_torch.parallel.fsdp import fully_shard_layers
        wrapped = fully_shard_layers(module, mesh[DATA_AXIS],
                                     md_layers=stage != "vae_diffusion")
        shard_group = data_group
    elif layout == "tp":
        from ladiff_torch.parallel.tp import tensor_parallel
        tensor_parallel(module.trained, model_group)
        wrapped = DDP(module, process_group=data_group, **ddp_kw)
        shard_group = model_group
    elif layout == "sp":
        from ladiff_torch.parallel.sp import sequence_parallel
        if stage != "vae":
            raise ValueError("sequence parallelism shards the VAE's tokens: "
                             f"stage vae only, not {stage!r}")
        wrapped = DDP(module, **ddp_kw)
        scope = lambda: sequence_parallel(model_group)
    else:
        wrapped = DDP(module, process_group=data_group, **ddp_kw)
    optimizer = (optimizer_factory or make_optimizer)(
        module.trained.parameters())
    norm_fn = lambda params: parallel_grad_norm(params, shard_group)

    def step(batch, generator=None, dropout_generator=None, draws=None):
        if draws is None:
            draws = global_draws(system, stage, len(batch["motion"]),
                                 generator, student_steps,
                                 frames=batch["motion"].shape[1])
        optimizer.zero_grad(set_to_none=True)
        with scope():
            total, logs = wrapped(shard_batch(batch, mesh),
                                  generator=dropout_generator,
                                  **shard_batch(draws, mesh))
        logs = _update(optimizer, total, logs, norm_fn=norm_fn)
        return all_reduce_mean(logs)

    return step, optimizer, module
