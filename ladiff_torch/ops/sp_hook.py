"""Sequence-parallel hook (counterpart of ``ladiff_tpu/ops/sp_hook.py``).

``parallel/sp.py`` shards the VAE's token axis over a process group.  The
JAX package re-pins the residual stream to the sequence sharding between
blocks and lets XLA insert the attention's gathers; here the collectives
are explicit, at three points the skip stacks and layers of
``ops/transformer.py`` call, each the identity outside a
``seq_sharding(group)`` scope:

  shard_tokens   at a stack's entry: pad the tokens to a multiple of the
                 group size (masked keys), keep this rank's block, and the
                 whole padded key mask for the attention
  gather_tokens  the keys and values of a self-attention: every rank's
                 block, in rank order (differentiable)
  the unshard    at a stack's exit (``shard_tokens``' third result): the
                 whole sequence again, the padding cut

LayerNorm, FFN and the skip GEMMs then run on the local tokens only.  Both
gathers are differentiable with a summing backward (an all-reduce of the
gathered gradient, then this rank's block): every rank computes the same
loss from the gathered stream, so each parameter's gradient is the group
size times the true one on every rank, uniformly, and the data-parallel
mean over all ranks (``DistributedDataParallel`` over the world) gives the
true gradient.  Lives in ``ops/`` so ``ops/transformer.py`` can import it
without a cycle.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["seq_sharding", "shard_tokens", "gather_tokens"]

# the sequence-parallel process group, or None
_SEQ = contextvars.ContextVar("ladiff_seq_group", default=None)


@contextlib.contextmanager
def seq_sharding(group):
    """Within this scope the skip stacks run on this rank's block of the
    tokens of ``group``."""
    tok = _SEQ.set(group)
    try:
        yield
    finally:
        _SEQ.reset(tok)


class _GatherTokens(torch.autograd.Function):
    """[B, c, D] blocks -> [B, n * c, D] in rank order; backward: the summed
    gradient's block of this rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        c = grad.shape[1] // n
        return grad[:, r * c:(r + 1) * c], None


def gather_tokens(x: torch.Tensor) -> torch.Tensor:
    """The whole (padded) token stream of every rank's block ``x``; ``x``
    itself outside a ``seq_sharding`` scope."""
    group = _SEQ.get()
    if group is None:
        return x
    return _GatherTokens.apply(x, group)


def shard_tokens(x: torch.Tensor, key_valid: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            Callable[[torch.Tensor], torch.Tensor]]:
    """(this rank's block of ``x`` [B, S, D], the key mask of the whole
    padded stream [B, S_pad], the unshard for the stack's output).  Outside
    a ``seq_sharding`` scope: ``(x, key_valid, identity)``."""
    group = _SEQ.get()
    if group is None:
        return x, key_valid, lambda y: y
    n, r = dist.get_world_size(group), dist.get_rank(group)
    B, S, D = x.shape
    c = -(-S // n)
    pad = c * n - S
    valid = (torch.ones(B, S, dtype=torch.bool, device=x.device)
             if key_valid is None else key_valid.bool())
    if pad:
        x = torch.cat([x, x.new_zeros(B, pad, D)], dim=1)
        valid = torch.cat([valid, valid.new_zeros(B, pad)], dim=1)
    return (x[:, r * c:(r + 1) * c], valid,
            lambda y: gather_tokens(y)[:, :S])
