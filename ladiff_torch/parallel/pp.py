"""Pipeline parallelism (GPipe) over the denoiser's MD skip stack
(counterpart of ``ladiff_tpu/parallel/pp.py``).

The L MD layers are split into S contiguous stages, one per rank of the
pipe group (the first S ranks of the world; the others take no part, as
``make_pipe_mesh(n_pipe)`` leaves the other devices unused), and a batch
flows through as ``n_micro`` microbatches.  Each stage runs its K = L / S
layers on a microbatch's carry and sends it on; the last stage banks the
outputs, which are broadcast to every stage, and the final LayerNorm and
everything outside the stack run replicated on every stage.

The U-Net skips ride in the carry, as in ``_pipeline_apply``: a skip pushed
by input block i is popped by output block nb - 1 - i, which generally lives
on a later stage, so the carry is (x, skip buffer [nb, mb, T, D]) and every
layer runs one program,

    x <- cat(x, skips[pop]) @ wlin.T + blin     (identity-extended wlin for
                                                 layers without a skip GEMM)
    x <- MD layer(x)
    skips[push] <- x                            (input blocks)

with ``stack_stage_params`` laying the skip GEMMs out per stage.

Where the port differs from the JAX package, and why (the math is the
same): the JAX schedule is one SPMD program whose ``ppermute`` hops
``jax.grad`` transposes into the backward schedule.  Torch has no such
transpose, so the backward is written out (``_Pipeline``): each stage keeps
its microbatches' graphs from the forward and, in reverse microbatch order,
receives the gradient of its output carry from the next stage, runs its
part of the backward and sends the gradient of its input carry to the stage
before.  The text and time rows are replicated inputs: their gradients are
summed over the stages; the stack's parameters' gradients, each on the
stage that owns the layer, are summed over the stages after the backward
(``reduce_stage_grads``), so every stage holds the same parameters and
takes the same update, as the JAX package's replicated state does.
``torch.distributed.pipelining`` is not used: its stages pass activations
only between adjacent stages' modules, and the skip buffer would need a
module boundary of its own per layer.

Deterministic by design, as in the JAX package: the stack runs in eval
mode (no dropout) under the schedule, every module of it on its plain
route (``plain_routes``): the MD layer in training is already unfused.  The
rest of the step keeps its kernels (stage 2's frozen VAE encode runs
kernels 5 and 10).  Stage
``diffusion``, the ``MD_TRANS`` denoiser, not autoregressive
(``TRAIN.PIPELINE_STAGES`` in the loop).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ladiff_torch.ops.cuda_common import plain_routes
from ladiff_torch.ops.pp_hook import pp_encoder_override
from ladiff_torch.ops.transformer import layer_norm

__all__ = ["PIPE_AXIS", "make_pipe_group", "stack_stage_params",
           "make_pipeline_encoder", "pipeline_encoder_forward",
           "reduce_stage_grads", "make_pp_diffusion_train_step"]

PIPE_AXIS = "pipe"


def make_pipe_group(n_pipe: int):
    """The process group of the first ``n_pipe`` ranks (every rank of the
    world calls this, as ``new_group`` requires)."""
    if n_pipe > dist.get_world_size():
        raise ValueError(f"{n_pipe} pipeline stages need as many ranks, the "
                         f"world has {dist.get_world_size()}")
    return dist.new_group(list(range(n_pipe)))


def stack_stage_params(encoder, n_stages: int) -> Dict[str, list]:
    """The encoder's layers and skip GEMMs per stage: "layers" [S][K] MD
    layers, "wlin" [S][K] weights [D, 2D] and "blin" [S][K] biases [D] —
    the ``linear_blocks`` parameters themselves for output blocks (so
    gradients reach them), an identity extension (cat(x, skip) -> x) for
    input and middle blocks."""
    blocks = encoder.ordered_blocks()
    L, S = len(blocks), n_stages
    if L % S:
        raise ValueError(f"n_stages {S} must divide num_layers {L}")
    nb = (L - 1) // 2
    w0 = encoder.linear_blocks[0].weight if nb else encoder.norm.weight
    D = encoder.norm.normalized_shape[0]
    eye = torch.cat([torch.eye(D), torch.zeros(D, D)], dim=1).to(w0)
    wlin, blin = [], []
    for l in range(L):
        if l > nb:
            lin = encoder.linear_blocks[l - nb - 1]
            wlin.append(lin.weight)
            blin.append(lin.bias)
        else:
            wlin.append(eye)
            blin.append(torch.zeros(D, dtype=eye.dtype, device=eye.device))
    K = L // S
    per_stage = lambda xs: [xs[s * K:(s + 1) * K] for s in range(S)]
    return {"layers": per_stage(blocks), "wlin": per_stage(wlin),
            "blin": per_stage(blin)}


class _Schedule:
    """One call's GPipe schedule on this rank's stage."""

    def __init__(self, staged, group, n_micro, L, valid):
        self.group, self.n_micro = group, n_micro
        self.S, self.s = dist.get_world_size(group), dist.get_rank(group)
        self.layers = staged["layers"][self.s]
        self.wlin, self.blin = staged["wlin"][self.s], staged["blin"][self.s]
        self.nb, self.K = (L - 1) // 2, L // self.S
        self.valid = valid
        self.grad = torch.is_grad_enabled()

    def _peer(self, s):
        return dist.get_global_rank(self.group, s)

    def _stage(self, x, skips, xf, emb, valid):
        nb = self.nb
        for k, layer in enumerate(self.layers):
            l = self.s * self.K + k
            pop = min(max(2 * nb - l, 0), max(nb - 1, 0))
            x = F.linear(torch.cat([x, skips[pop]], dim=-1),
                         self.wlin[k].to(x.dtype), self.blin[k].to(x.dtype))
            x = layer(x, xf, emb, valid)
            if l < nb:
                skips = skips[:l] + [x] + skips[l + 1:]
        return x, torch.stack(skips)

    def forward(self, x, xf, emb):
        B, T, D = x.shape
        mb = B // self.n_micro
        nbk = max(self.nb, 1)
        y = x.new_empty(B, T, D)
        self.saved = []
        for m in range(self.n_micro):
            rows = slice(m * mb, (m + 1) * mb)
            if self.s == 0:
                carry = torch.cat([x[rows][None],
                                   x.new_zeros(nbk, mb, T, D)])
            else:
                carry = x.new_empty(1 + nbk, mb, T, D)
                dist.recv(carry, self._peer(self.s - 1), group=self.group)
            with torch.set_grad_enabled(self.grad):
                carry = carry.detach().requires_grad_(self.grad)
                xf_m = xf[rows].detach().requires_grad_(self.grad)
                emb_m = emb[rows].detach().requires_grad_(self.grad)
                valid = None if self.valid is None else self.valid[rows]
                xo, sko = self._stage(carry[0], list(carry[1:]), xf_m,
                                      emb_m, valid)
            self.saved.append((carry, xf_m, emb_m, xo, sko))
            if self.s < self.S - 1:
                dist.send(torch.cat([xo[None], sko]).detach().contiguous(),
                          self._peer(self.s + 1), group=self.group)
            else:
                y[rows] = xo.detach()
        dist.broadcast(y, self._peer(self.S - 1), group=self.group)
        return y

    def backward(self, gy):
        B, T, D = gy.shape
        mb = B // self.n_micro
        nbk = max(self.nb, 1)
        gx = gy.new_zeros(B, T, D)
        xf_rows, emb_rows = [], []
        zero = lambda t, g: torch.zeros_like(t) if g is None else g
        for m in reversed(range(self.n_micro)):
            rows = slice(m * mb, (m + 1) * mb)
            carry, xf_m, emb_m, xo, sko = self.saved[m]
            if self.s == self.S - 1:
                g_out = torch.cat([gy[rows][None], torch.zeros_like(sko)])
            else:
                g_out = gy.new_empty(1 + nbk, mb, T, D)
                dist.recv(g_out, self._peer(self.s + 1), group=self.group)
            torch.autograd.backward([xo, sko], [g_out[0], g_out[1:]])
            g_in = zero(carry, carry.grad)
            if self.s > 0:
                dist.send(g_in.contiguous(), self._peer(self.s - 1),
                          group=self.group)
            else:
                gx[rows] = g_in[0]
            xf_rows.append(zero(xf_m, xf_m.grad))
            emb_rows.append(zero(emb_m, emb_m.grad))
        self.saved = None
        gxf = torch.cat(xf_rows[::-1])
        gemb = torch.cat(emb_rows[::-1])
        for g in (gxf, gemb):
            dist.all_reduce(g, group=self.group)
        dist.broadcast(gx, self._peer(0), group=self.group)
        return gx, gxf, gemb


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule, x, xf, emb):
        ctx.schedule = schedule
        return schedule.forward(x, xf, emb)

    @staticmethod
    def backward(ctx, gy):
        return (None, *ctx.schedule.backward(gy.contiguous()))


def make_pipeline_encoder(encoder, *, group, n_micro: int):
    """Stages ``encoder`` (an ``MDSkipTransformerEncoder``) once over
    ``group`` and returns ``forward(x, xf, emb, latent_valid=None)``: the
    encoder's output [B, T, D] on every rank of the group, equal to
    ``encoder(x, xf, emb, latent_valid)`` in eval mode.  B must split into
    ``n_micro`` microbatches.  Differentiable in x, xf, emb and the
    encoder's parameters (``reduce_stage_grads`` after the backward gives
    every stage the whole gradient)."""
    staged = stack_stage_params(encoder, dist.get_world_size(group))
    L = len(encoder.ordered_blocks())

    def forward(x, xf, emb, latent_valid=None):
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{n_micro} microbatches")
        was = encoder.training
        encoder.train(False)
        try:
            with plain_routes():
                y = _Pipeline.apply(
                    _Schedule(staged, group, n_micro, L, latent_valid),
                    x, xf, emb)
        finally:
            encoder.train(was)
        return layer_norm(encoder.norm, y)

    return forward


def pipeline_encoder_forward(encoder, x, xf, emb, latent_valid, *, group,
                             n_micro: int) -> torch.Tensor:
    """One-shot ``make_pipeline_encoder(...)(x, xf, emb, latent_valid)``."""
    return make_pipeline_encoder(encoder, group=group,
                                 n_micro=n_micro)(x, xf, emb, latent_valid)


def _stack_params(encoder) -> List[torch.nn.Parameter]:
    return [p for name, p in encoder.named_parameters()
            if not name.startswith("norm.")]


def reduce_stage_grads(encoder, group) -> None:
    """After a pipelined backward: every stack parameter's gradient summed
    over the stages (each layer's gradient lives on its own stage), so
    every stage holds the whole gradient.  A parameter no stage reached
    keeps no gradient, as on one device."""
    params = _stack_params(encoder)
    ref = params[0]
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.float32, device=ref.device)
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1) for p in params])
    dist.all_reduce(has, group=group)
    dist.all_reduce(flat, group=group)
    offset = 0
    for p, h in zip(params, has.tolist()):
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).clone() if h else None
        offset += n


def make_pp_diffusion_train_step(system, *, group, n_micro: int):
    """The stage-2 step with the denoiser's MD skip stack pipelined over
    ``group``: ``step(optimizer, batch, uncond_emb, generator=None,
    **draws)`` -> logs, the same loss as ``trainer.diffusion_train_step``
    (``diffusion_forward``), the batch and every draw alike on every stage
    (microbatching is the parallelism)."""
    from ladiff_torch.training.trainer import StageLoss, _update
    encoder = system.denoiser.encoder
    pipe = make_pipeline_encoder(encoder, group=group, n_micro=n_micro)

    def override(enc, x, xf, emb, latent_valid):
        return pipe(x, xf, emb, latent_valid)

    def step(optimizer, batch, uncond_emb,
             generator: Optional[torch.Generator] = None, **draws):
        optimizer.zero_grad(set_to_none=True)
        with pp_encoder_override(override):
            total, logs = StageLoss(system, "diffusion", uncond_emb)(
                batch, generator=generator, **draws)
        return _update(optimizer, total, logs,
                       after_backward=lambda: reduce_stage_grads(encoder,
                                                                 group))

    return step
