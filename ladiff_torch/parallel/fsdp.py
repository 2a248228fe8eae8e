"""Fully-sharded data parallelism (ZeRO-3) over the mesh's ``data`` dim
(counterpart of ``ladiff_tpu/parallel/fsdp.py``).

Every trained parameter, and with it both AdamW moments, is sharded over
the ranks that split the batch: FSDP2 ``fully_shard`` on each transformer
layer (``TransformerEncoderLayer``, ``TransformerDecoderLayer``,
``MDTransformerLayer``; the outermost where they nest; the MD layers of the
joint stage stay with the root), then on the root,
the stage's loss module, which holds the rest.  A layer's parameters are
all-gathered before its forward and again before its backward, and its
gradients reduce-scattered after it.

Where the layout differs from the JAX package's, and why (the results do
not; the tests hold the results, not the layout):

  * FSDP2 shards dim 0 of every parameter, padded where it does not
    divide.  The JAX rule (``fsdp_spec_for``) shards the largest divisible
    dim and leaves a leaf with none replicated: GSPMD needs an even split,
    FSDP2 pads.
  * The gradients are FSDP2's one-device gradients summed in another
    order.  ``fully_shard`` puts an identity autograd node on each wrapped
    module's inputs (its post-backward hook); the engine then runs the
    backward's nodes in another order, and an activation that several
    nodes feed (a layer's input: its attention, its residual, the skip
    buffer) sums its gradient's parts in another order.  In bf16 those
    sums round at bf16's precision, so at world size 1 FSDP2 differs from
    the one-process step by about 1e-2 per tensor where DDP is equal to
    it bit for bit; in float32 by about 1e-6.  ``fsdp_autograd_graph``
    puts the same nodes on a module without sharding it: the one-process
    step then equals FSDP2's at world size 1 bit for bit.
  * The kernels stay on.  The JAX package traces its FSDP step under
    ``no_pallas()`` because the SPMD partitioner cannot split a custom
    call; FSDP2 unshards a layer's parameters before each wrapped forward,
    so kernels 8, 9, 12 and 13 see whole weights, and their
    ``autograd.Function``s' weight gradients land on the unsharded
    parameters that FSDP2 reduce-scatters.  Routes are chosen from the
    module before any launch, as on one device.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["fully_shard_layers", "fsdp_autograd_graph"]


def _layer_types(md_layers: bool):
    from ladiff_torch.ops.stylization import MDTransformerLayer
    from ladiff_torch.ops.transformer import (TransformerDecoderLayer,
                                              TransformerEncoderLayer)
    return (TransformerEncoderLayer, TransformerDecoderLayer) + (
        (MDTransformerLayer,) if md_layers else ())


def _outer_layers(module: nn.Module, types):
    for child in module.children():
        if isinstance(child, types):
            yield child
        else:
            yield from _outer_layers(child, types)


def fully_shard_layers(root: nn.Module, mesh, md_layers: bool = True
                       ) -> nn.Module:
    """``fully_shard`` each outermost transformer layer under ``root``, then
    ``root`` itself, over ``mesh`` (the ``data`` dim's 1-D mesh).  Returns
    ``root``, whose forward must be the one that is called (FSDP2 unshards
    the root's own parameters in its pre-forward hook).  ``md_layers``
    false leaves the MD layers in the root's group: the joint stage's
    sampler reads their parameters outside their forward (the
    step-invariant precompute of ``diffusion_reverse``), so there they are
    gathered with the root for the whole step."""
    from torch.distributed.fsdp import fully_shard
    for layer in list(_outer_layers(root, _layer_types(md_layers))):
        fully_shard(layer, mesh=mesh)
    fully_shard(root, mesh=mesh)
    return root


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return grads


def _identity_inputs(module, args, kwargs):
    keys = [i for i, a in enumerate(args)
            if torch.is_tensor(a) and a.requires_grad]
    names = [k for k, a in kwargs.items()
             if torch.is_tensor(a) and a.requires_grad]
    if not keys and not names:
        return None
    out = iter(_Identity.apply(*[args[i] for i in keys],
                               *[kwargs[k] for k in names]))
    args = list(args)
    for i in keys:
        args[i] = next(out)
    for k in names:
        kwargs[k] = next(out)
    return tuple(args), kwargs


def fsdp_autograd_graph(root: nn.Module, md_layers: bool = True
                        ) -> nn.Module:
    """Puts on each layer that ``fully_shard_layers(root, ...)`` would wrap
    the identity autograd node that ``fully_shard`` puts on a wrapped
    module's inputs, and shards nothing: ``root``'s backward then sums
    every gradient in FSDP2's order, so a one-process step equals the
    FSDP2 step at world size 1 bit for bit.  A control for checks; returns
    ``root``."""
    for layer in _outer_layers(root, _layer_types(md_layers)):
        layer.register_forward_pre_hook(_identity_inputs, with_kwargs=True)
    return root
