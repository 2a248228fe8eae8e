"""Process group, device mesh and the batch rule (counterpart of
``ladiff_tpu/parallel/mesh.py``).

The reference trains with Lightning DDP over up to 8 GPUs; the JAX package
puts that data parallelism in by default over a ``("data", "model")`` mesh
of every device.  Here the ranks are processes started by ``torchrun``
(``init_distributed``): each runs on ``cuda:LOCAL_RANK`` with NCCL, or on
the CPU with gloo when the caller names the CPU.  Without torchrun's
environment the world size is 1 and no process group is started.

``make_mesh(n_data, n_model)`` is a 2-D ``DeviceMesh`` with dims ``("data",
"model")`` over the whole world (the JAX mesh takes a prefix of the devices;
a torchrun world is sized for its layout).  The ``model`` dim carries tensor
parallelism (``parallel/tp.py``) or, standing for ``seq``, sequence
parallelism (``parallel/sp.py``).

The batch rule: ``TRAIN.BATCH_SIZE`` is the global batch, as in the JAX
package.  Every rank loads the same global batch, pads it to a multiple of
the data width by repeating its last row (``pad_batch``, the JAX loop's
``_pad_batch``) and keeps its own rows (``take_rows``).  Every loss of
``losses/mld.py`` is a plain mean over tensors whose shapes then agree on
every rank, so the mean of the ranks' losses is the global mean.  Every
draw of a step is made for the global batch from the step's generator, the
same on every rank, and each rank keeps its rows of it
(``training/trainer.py`` ``global_draws``): the results do not depend on
the world size.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "init_distributed", "is_distributed",
           "world_size", "rank", "make_mesh", "pad_to_multiple", "pad_batch",
           "take_rows", "shard_batch", "all_reduce_mean", "gather_rows",
           "eval_split", "data_parallel_rows", "full_state_dict"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(device=None, backend: Optional[str] = None
                     ) -> torch.device:
    """Starts the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) and returns this rank's device: ``cuda:LOCAL_RANK``
    with NCCL unless ``device`` names the CPU, which takes gloo.
    ``backend`` names another backend explicitly (gloo over CUDA tensors,
    where ranks share one card).  Without torchrun's environment nothing is
    started and ``device`` is returned as the entry points resolve it."""
    from ladiff_torch.utils.device import resolve_device
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        return resolve_device(device)
    cpu = device is not None and torch.device(device).type == "cpu"
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device("cpu") if cpu else resolve_device(f"cuda:{local}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("gloo" if cpu else "nccl"))
    return dev


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: Optional[str] = None):
    """The ``("data", "model")`` ``DeviceMesh`` over the world; ``n_data``
    defaults to the world size over ``n_model``.  ``device_type``: "cuda"
    or "cpu" (default: the default group's backend, gloo -> "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh
    world = world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks, the world has {world}")
    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def pad_batch(batch: Dict[str, Any], multiple: int) -> Dict[str, Any]:
    """The batch dim padded up to a multiple of ``multiple`` by repeating
    the last row (arrays, tensors and lists alike), so it splits evenly."""
    n = len(batch["motion"] if "motion" in batch else
            next(iter(batch.values())))
    rem = pad_to_multiple(n, multiple) - n
    if rem == 0:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            out[k] = np.concatenate([v, np.repeat(v[-1:], rem, axis=0)])
        elif isinstance(v, torch.Tensor):
            out[k] = torch.cat([v, v[-1:].expand(rem, *v.shape[1:])])
        else:
            out[k] = list(v) + [v[-1]] * rem
    return out


def take_rows(tree, index: int, n: int):
    """Row block ``index`` of ``n`` of every [B, ...] leaf of ``tree``
    (dicts, tensors, arrays, lists); 0-dim tensors (a batch-wide draw) and
    None stay as they are."""
    if n == 1 or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: take_rows(v, index, n) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, np.ndarray)) and tree.ndim == 0:
        return tree
    size = len(tree)
    if size % n:
        raise ValueError(f"{size} rows do not split over {n} ranks")
    b = size // n
    return tree[index * b:(index + 1) * b]


def shard_batch(batch, mesh):
    """This rank's rows of a (padded) global batch over the mesh's ``data``
    dim."""
    return take_rows(batch, mesh.get_local_rank(DATA_AXIS),
                     mesh.size(mesh.mesh_dim_names.index(DATA_AXIS)))


def all_reduce_mean(logs: Dict[str, torch.Tensor], group=None
                    ) -> Dict[str, torch.Tensor]:
    """Each scalar log's mean over the ranks of ``group`` (one
    collective)."""
    if not is_distributed():
        return logs
    keys = sorted(logs)
    vec = torch.stack([logs[k].detach().float() for k in keys])
    dist.all_reduce(vec, group=group)
    vec /= dist.get_world_size(group)
    return dict(zip(keys, vec.unbind()))


def gather_rows(tree, group=None):
    """Every tensor leaf of ``tree`` all-gathered over ``group`` and
    concatenated on dim 0 in rank order."""
    if isinstance(tree, dict):
        return {k: gather_rows(v, group) for k, v in tree.items()}
    parts = [torch.empty_like(tree) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tree.contiguous(), group=group)
    return torch.cat(parts)


def eval_split(batch_size: int) -> Tuple[int, int]:
    """(this rank's row block, number of blocks) for a data-parallel
    evaluation batch: the world splits it where its size divides the batch
    (the JAX package's ``mesh if bs % n_dev == 0 else None``), else every
    rank runs the whole batch."""
    n = world_size()
    if n > 1 and batch_size % n == 0:
        return rank(), n
    return 0, 1


def data_parallel_rows(fn: Callable, batch_size: int, rows: Dict[str, Any],
                       **kwargs):
    """``fn(**rows, **kwargs)`` on this rank's rows of ``rows`` (keyword
    arguments whose leaves are [batch_size, ...]; ``eval_split``), its
    outputs (a dict of tensors with the batch first) all-gathered in rank
    order: every rank returns the whole batch's outputs."""
    index, n = eval_split(batch_size)
    if n == 1:
        return fn(**rows, **kwargs)
    return gather_rows(fn(**take_rows(rows, index, n), **kwargs))


def full_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded entry whole, on every
    rank (collective: every rank calls it): FSDP2's ``DTensor`` parameters
    through ``full_tensor()``, tensor-parallel shards (``parallel/tp.py``
    marks them with ``tp_dim`` / ``tp_group``) all-gathered on their dim.
    A checkpoint written from it loads at any world size."""
    from torch.distributed.tensor import DTensor
    out = {}
    for k, v in module.state_dict(keep_vars=True).items():
        if isinstance(v, DTensor):
            v = v.full_tensor()
        elif getattr(v, "tp_dim", None) is not None:
            parts = [torch.empty_like(v) for _ in range(
                dist.get_world_size(v.tp_group))]
            dist.all_gather(parts, v.detach().contiguous(), group=v.tp_group)
            v = torch.cat(parts, dim=v.tp_dim)
        out[k] = v.detach()
    return out
