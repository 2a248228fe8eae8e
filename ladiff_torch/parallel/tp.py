"""Tensor parallelism over the mesh's ``model`` dim (counterpart of
``ladiff_tpu/parallel/tp.py``): Megatron's layout on a ``data x model``
mesh.

  ``linear1.weight``        [F, D]   column parallel: rows sharded (dim 0)
  ``linear1.bias``          [F]      dim 0
  ``linear2.weight``        [D, F]   row parallel: columns sharded (dim 1)
  ``self_attn.in_proj_weight`` / ``multihead_attn.in_proj_weight``
                            [3D, D]  dim 0, contiguous rows
  ``in_proj_bias``          [3D]     dim 0
  ``out_proj.weight``       [D, D]   row parallel (dim 1)

The table (``_COL`` / ``_ROW`` / ``_VEC``) is the JAX package's leaf for
leaf, in the reference torch names, which the parameters keep: a torch
``Linear`` weight is the JAX kernel transposed, so the JAX table's dim 1 of
a column-parallel kernel is dim 0 here and dim 0 of a row-parallel one is
dim 1.  A leaf whose dim does not divide by the ``model`` width stays
replicated, as ``tp_spec_for`` leaves it.  Everything else (LayerNorms, the
row-parallel biases, embeddings, the skip GEMMs) stays replicated.

The collectives are Megatron's, explicit: a column-parallel product's input
passes ``_CopyToModel`` (identity forward, gradient all-reduced), a
row-parallel product's partial sums ``_ReduceFromModel`` (all-reduce
forward, identity backward) before its bias.  Attention runs replicated
after an all-gather of the in_proj output (``_GatherFromModel``, whose
backward keeps this rank's columns), which is what GSPMD does with the
packed ``[D, 3D]`` split: its contiguous columns do not align with the q / k
/ v blocks or the heads, and a head-interleaved re-layout would break the
reference's packing.  ``out_proj`` then takes this rank's columns of the
context (``_ScatterToModel``).  Replicated parameters see the same
activations and gradients on every rank of the ``model`` dim, so their
gradients agree there; the ``data`` dim averages every gradient
(``DistributedDataParallel`` over the data group).

Every layer that holds a shard takes its plain route (``plain_forward``,
the JAX package's ``no_pallas()`` narrowed to the sharded layers): a
column-parallel shard is not a kernel's whole layer.  The rest of the step
keeps its kernels, so stage 2's frozen VAE encode, which is not sharded,
runs kernels 5 and 10 as on one device; the JAX package traces the whole
step under ``no_pallas()`` because GSPMD cannot split a custom call.  Sharded parameters carry ``tp_dim`` and ``tp_group``
so that ``mesh.full_state_dict`` writes them whole and the trainer's norm
sums their squares over the group.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.attention import MultiHeadAttention
from ladiff_torch.ops.attention_kernel import masked_attention_plain
from ladiff_torch.ops.cuda_common import plain_forward

__all__ = ["tp_dim_for", "tensor_parallel", "ColumnParallelLinear",
           "RowParallelLinear", "TPMultiHeadAttention"]

# (parent module name or None, leaf name) -> sharded; matched against the
# last two components of a parameter's name, as the JAX table is
_COL = {("linear1", "weight"), (None, "in_proj_weight")}
_ROW = {("linear2", "weight"), ("out_proj", "weight")}
_VEC = {("linear1", "bias"), (None, "in_proj_bias")}


def tp_dim_for(name: str, shape: Sequence[int], n_model: int
               ) -> Optional[int]:
    """The dim of parameter ``name`` (dotted, torch layout) sharded over an
    ``n_model``-wide ``model`` dim, or None where it stays replicated."""
    parts = name.split(".")
    keys = {(parts[-2] if len(parts) >= 2 else None, parts[-1]),
            (None, parts[-1])}
    if len(shape) == 2:
        if keys & _COL and shape[0] % n_model == 0:
            return 0
        if keys & _ROW and shape[1] % n_model == 0:
            return 1
    if len(shape) == 1 and keys & _VEC and shape[0] % n_model == 0:
        return 0
    return None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """Every rank's last-dim block, in rank order; backward: this rank's
    block of the gradient (the gathered result is used alike everywhere)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.group), None


class _ScatterToModel(torch.autograd.Function):
    """This rank's last-dim block; backward: every rank's block gathered."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _block(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather_last(grad, ctx.group), None


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _block(x: torch.Tensor, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    c = x.shape[-1] // n
    return x[..., r * c:(r + 1) * c].contiguous()


def _shard(p: torch.Tensor, dim: Optional[int], group) -> nn.Parameter:
    """This rank's block of ``p`` on ``dim`` (the whole of it where None),
    marked for ``full_state_dict`` and the trainer's norm."""
    if dim is None:
        return nn.Parameter(p.detach().clone(), requires_grad=p.requires_grad)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = nn.Parameter(p.detach().chunk(n, dim)[r].clone(),
                       requires_grad=p.requires_grad)
    out.tp_dim, out.tp_group = dim, group
    return out


class ColumnParallelLinear(nn.Module):
    """``linear1``'s rows of this rank: [.., D] -> [.., F / n]."""

    tensor_parallel = True

    def __init__(self, lin: nn.Linear, group):
        super().__init__()
        self.group = group
        self.in_features, self.out_features = lin.in_features, lin.out_features
        self.weight = _shard(lin.weight, 0, group)
        self.bias = _shard(lin.bias, 0, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.group)
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class RowParallelLinear(nn.Module):
    """``linear2`` / ``out_proj`` on this rank's columns: takes this rank's
    block of the input (a whole input is cut to it), sums the partial
    products over the group, adds the replicated bias."""

    tensor_parallel = True

    def __init__(self, lin: nn.Linear, group):
        super().__init__()
        self.group = group
        self.in_features, self.out_features = lin.in_features, lin.out_features
        self.weight = _shard(lin.weight, 1, group)
        self.bias = _shard(lin.bias, None, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.weight.shape[1]:
            x = _ScatterToModel.apply(x, self.group)
        y = _ReduceFromModel.apply(
            F.linear(x, self.weight.to(x.dtype)), self.group)
        return y + self.bias.to(y.dtype)


class TPMultiHeadAttention(MultiHeadAttention):
    """``MultiHeadAttention`` with its in_proj rows sharded (where 3D
    divides) and ``out_proj`` row parallel (where D divides): q, k and v
    come from the all-gathered projection, the attention itself runs
    replicated through its plain version."""

    def __init__(self, attn: MultiHeadAttention, group):
        nn.Module.__init__(self)
        n = dist.get_world_size(group)
        self.d_model, self.num_heads = attn.d_model, attn.num_heads
        self.dropout, self.group = attn.dropout, group
        dim = tp_dim_for("in_proj_weight", attn.in_proj_weight.shape, n)
        self.in_proj_sharded = dim is not None
        self.in_proj_weight = _shard(attn.in_proj_weight, dim, group)
        self.in_proj_bias = _shard(attn.in_proj_bias, dim, group)
        self.out_proj = attn.out_proj

    def forward(self, query, key, value, key_valid=None, generator=None,
                return_weights: bool = False, plain: bool = False):
        D, dt = self.d_model, query.dtype
        w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        done = []

        def project(x, i):
            # one projection (and gather) per distinct input tensor
            for src, y in done:
                if src is x:
                    return y[..., i * D:(i + 1) * D]
            h = x.to(dt)
            if self.in_proj_sharded:
                y = _GatherFromModel.apply(
                    F.linear(_CopyToModel.apply(h, self.group), w, b),
                    self.group)
            else:
                y = F.linear(h, w, b)
            done.append((x, y))
            return y[..., i * D:(i + 1) * D]

        out = masked_attention_plain(
            project(query, 0), project(key, 1), project(value, 2), key_valid,
            num_heads=self.num_heads,
            dropout_rate=self.dropout if self.training else 0.0,
            generator=generator, return_weights=return_weights)
        if return_weights:
            out, weights = out
        if getattr(self.out_proj, "tensor_parallel", False):
            out = self.out_proj(out)
        else:
            out = F.linear(out, self.out_proj.weight.to(dt),
                           self.out_proj.bias.to(dt))
        return (out, weights) if return_weights else out


def _convert(module: nn.Module, group, n: int) -> None:
    for name, child in list(module.named_children()):
        new = child
        if isinstance(child, MultiHeadAttention):
            new = TPMultiHeadAttention(child, group)
        elif type(child) is nn.Linear:
            dim = tp_dim_for(f"{name}.weight", child.weight.shape, n)
            if dim == 0:
                new = ColumnParallelLinear(child, group)
            elif dim == 1:
                new = RowParallelLinear(child, group)
        if new is not child:
            setattr(module, name, new)
        _convert(new, group, n)


def tensor_parallel(module: nn.Module, group) -> nn.Module:
    """Shards ``module``'s table leaves over ``group`` (the mesh's ``model``
    dim) in place: ``MultiHeadAttention``s become ``TPMultiHeadAttention``,
    ``linear1`` / ``linear2`` / ``out_proj`` ``Linear``s column / row
    parallel.  Parameter names are unchanged.  Each transformer layer that
    then holds a shard runs its forward on the plain routes
    (``plain_forward``).  Returns ``module``."""
    from ladiff_torch.ops.stylization import MDTransformerLayer
    from ladiff_torch.ops.transformer import (TransformerDecoderLayer,
                                              TransformerEncoderLayer)
    _convert(module, group, dist.get_world_size(group))
    layers = (TransformerEncoderLayer, TransformerDecoderLayer,
              MDTransformerLayer)
    for layer in module.modules():
        if isinstance(layer, layers) and any(
                getattr(p, "tp_dim", None) is not None
                for p in layer.parameters()):
            plain_forward(layer)
    return module
