"""Rank processes of the parallel-layout tests
(``tests/test_torch_parallel*.py``).

Imports only torch, numpy and ``ladiff_torch``: the JAX references run in
the pytest process.  ``spawn(world, jobs, inputs, tmp)`` starts ``world``
ranks through ``torch.multiprocessing``'s spawn context, each capped at one
intra-op thread, with a file-store rendezvous under ``tmp`` (xdist workers
run side by side, so no TCP port).  Inputs and results pass as ``.npz``
files of flat "/"-joined keys; ``jobs`` is a list of (name, spec) pairs run
in order on every rank, each a function of this module, whose returned
arrays rank 0 writes under ``name/``.
"""
from __future__ import annotations

import json
import os
import time
import traceback
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist


# -- npz of nested dicts ------------------------------------------------------

def flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        elif v is not None:
            out[key] = v.detach().cpu().numpy() if isinstance(
                v, torch.Tensor) else np.asarray(v)
    return out


def unflatten(flat) -> dict:
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def load_npz(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return unflatten({k: z[k] for k in z.files})


def tensors(tree):
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.long() if t.dtype in (torch.int32, torch.int64) else t


# -- the port's systems -----------------------------------------------------

def build_system(spec: dict, state: dict):
    """A port ``LADiffSystem`` on the CPU from ``spec["system"]`` (keyword
    arguments; ``"synthetic_smpl"`` gives the action family's synthetic
    SMPL body) with the converted parameters ``state``."""
    from ladiff_torch.models.ladiff import LADiffSystem
    kw = dict(spec["system"])
    n_verts = kw.pop("synthetic_smpl", None)
    if n_verts:
        from ladiff_torch.smpl.body_model import SMPLModel
        from ladiff_torch.transforms.rotation2xyz import Rotation2xyz
        kw["rot2xyz"] = Rotation2xyz(SMPLModel.synthetic(n_verts=n_verts))
    for k in ("mean", "std"):
        if k in kw:
            kw[k] = np.asarray(kw[k], np.float32)
    system = LADiffSystem(device="cpu", **kw)
    system.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state.items()}, strict=True)
    return system


def _prefix(stage: str) -> str:
    return {"vae": "vae.", "diffusion": "denoiser.", "distill": "denoiser.",
            "vae_diffusion": ""}[stage]


# -- jobs -------------------------------------------------------------------

def train_step(rank, world, spec, data) -> dict:
    """``spec``: stage, layout, n_model, steps, opt ("sgd" lr 1, or "adamw"
    lr 1e-3), fsdp_graph (FSDP2's autograd nodes on the trained tree,
    ``fsdp_autograd_graph``), routes (record each module's route gate,
    ``kernel_route``, as its forward starts); ``data``: "state", "batch",
    "draws" (a list per step under "draws/<i>"), "uncond".  Returns the
    trained tree's whole parameters after the steps, each step's logs, the
    AdamW moments (gathered whole, by "<name>:exp_avg" /
    "<name>:exp_avg_sq"), this rank's share of every sharded parameter and
    AdamW moment (``local_numel`` / ``full_numel``, and its dim 0,
    ``rows``), the tensor-parallel dims by name (``tp_dim``) and the route
    gates by module name (``kernel_route``)."""
    from torch.distributed.tensor import DTensor

    from ladiff_torch.parallel.mesh import full_state_dict, make_mesh
    from ladiff_torch.training.trainer import make_optimizer, \
        make_parallel_step
    stage = spec["stage"]
    system = build_system(spec, data["state"])
    teacher = None
    if stage == "distill":
        import copy
        teacher = copy.deepcopy(system.denoiser).requires_grad_(False)
    factory = ((lambda ps: torch.optim.SGD(ps, lr=1.0))
               if spec.get("opt", "sgd") == "sgd"
               else (lambda ps: make_optimizer(ps, 1e-3)))
    mesh = make_mesh(n_model=spec.get("n_model", 1), device_type="cpu")
    uncond = data.get("uncond")
    step, opt, module = make_parallel_step(
        system, stage, spec["layout"], mesh, optimizer_factory=factory,
        uncond_emb=None if uncond is None else tensors(uncond),
        teacher=teacher, student_steps=spec.get("student_steps"))
    if spec.get("fsdp_graph"):
        from ladiff_torch.parallel.fsdp import fsdp_autograd_graph
        fsdp_autograd_graph(module.trained)
    routes = {}
    if spec.get("routes"):  # each module's route gate, seen at its forward
        from ladiff_torch.ops.cuda_common import kernel_route
        probe = torch.zeros(1)
        for name, m in system.named_modules():
            m.register_forward_pre_hook(
                lambda mod, args, name=name: routes.__setitem__(
                    name, kernel_route(probe, "fused_masked_attention")))
    batch = tensors(data["batch"])
    out = {"logs": {}}
    for i in range(int(spec.get("steps", 1))):
        logs = step(batch, draws=tensors(data["draws"][str(i)]))
        out["logs"][str(i)] = {k: float(v) for k, v in logs.items()}
    prefix = _prefix(stage)
    out["params"] = {prefix + k: v for k, v in
                     full_state_dict(module.trained).items()}
    local, full, rows, tp, moments = {}, {}, {}, {}, {}
    for name, p in module.trained.named_parameters():
        for m, x in opt.state.get(p, {}).items():
            if m in ("exp_avg", "exp_avg_sq"):
                x = x.full_tensor() if isinstance(x, DTensor) else x
                moments[f"{prefix}{name}:{m}"] = x.detach().numpy()
        if isinstance(p, DTensor):
            for key, x in [(name, p)] + [
                    (f"{name}:{m}", opt.state.get(p, {}).get(m))
                    for m in ("exp_avg", "exp_avg_sq")]:
                if x is not None:
                    local[key], full[key] = x.to_local().numel(), x.numel()
                    rows[key] = x.shape[0]
        if getattr(p, "tp_dim", None) is not None:
            tp[prefix + name] = p.tp_dim
    out["local_numel"], out["full_numel"], out["rows"] = local, full, rows
    out["tp_dim"], out["moments"] = tp, moments
    out["kernel_route"] = routes
    out["world"] = world
    return out


def fsdp_graph(rank, world, spec, data) -> dict:
    """FSDP2's gradients (a step at lr 0) against the one-process backward
    of this rank's rows with FSDP2's autograd nodes and no sharding
    (``fsdp_autograd_graph``), and against the same without those nodes,
    each averaged over the ranks: the largest absolute difference of
    each, and how many tensors differ at all."""
    import copy

    from torch.distributed.tensor import DTensor

    from ladiff_torch.parallel.fsdp import fsdp_autograd_graph
    from ladiff_torch.parallel.mesh import make_mesh, shard_batch
    from ladiff_torch.training.trainer import StageLoss, make_parallel_step
    stage = spec["stage"]
    system = build_system(spec, data["state"])
    uncond = tensors(data["uncond"])
    batch, draws = tensors(data["batch"]), tensors(data["draws"]["0"])
    mesh = make_mesh(device_type="cpu")

    def one_process(graph):
        loss = StageLoss(copy.deepcopy(system), stage, uncond)
        if graph:
            fsdp_autograd_graph(loss.trained)
        total, _ = loss(shard_batch(batch, mesh), **shard_batch(draws, mesh))
        total.backward()
        out = {}
        for n, p in loss.trained.named_parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad)
                out[n] = p.grad / world
        return out

    want, plain = one_process(True), one_process(False)
    step, _, module = make_parallel_step(
        system, stage, "fsdp", mesh, uncond_emb=uncond,
        optimizer_factory=lambda ps: torch.optim.SGD(ps, lr=0.0))
    step(batch, draws=draws)
    got = {n: p.grad.full_tensor() if isinstance(p.grad, DTensor)
           else p.grad for n, p in module.trained.named_parameters()
           if p.grad is not None}
    out = {"n": len(got), "same_names": set(got) == set(want)}
    for key, ref in (("graph", want), ("plain", plain)):
        d = [float((got[n] - ref[n]).abs().max()) for n in got]
        out[f"{key}_max_abs"], out[f"{key}_n_differ"] = max(d), sum(
            x > 0 for x in d)
    return out


def text_features(texts) -> torch.Tensor:
    """Pooled text features [B, 1, 768] of each caption from a stable hash
    of it (the same in every process)."""
    import hashlib
    return torch.as_tensor(np.stack([np.random.RandomState(int.from_bytes(
        hashlib.sha256(t.encode()).digest()[:4], "little")).randn(1, 768)
        for t in texts]).astype(np.float32))


def _cfg(spec):
    from ladiff_torch.config import assemble_config
    return assemble_config(spec["cfg"], spec.get("assets"),
                           spec["overrides"])


def run_training_job(rank, world, spec, data) -> dict:
    """``run_training`` of the configuration file ``spec["cfg"]`` with
    ``spec["overrides"]`` on the CPU, ``spec["steps"]`` steps an epoch;
    returns the checkpoint directory."""
    import logging

    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.training.loop import run_training
    from ladiff_torch.utils.logger import create_logger
    cfg = _cfg(spec)
    logger = create_logger(cfg, phase="train")
    logger.setLevel(logging.WARNING)
    dm = get_datasets(cfg)[0]
    ckpt = run_training(cfg, dm, logger, text_encoder=text_features,
                        max_steps_per_epoch=spec.get("steps"), device="cpu")
    return {"ckpt_dir": np.array(ckpt)}


def sp_reconstruct(rank, world, spec, data) -> dict:
    """``sp_vae_reconstruct`` over the first ``n_seq`` ranks: the five
    outputs, and the VAE's gradient of ``sum(feats**2) + sum(mu**2)``
    averaged over the group."""
    from ladiff_torch.models.vae import LAVae
    from ladiff_torch.parallel.sp import sp_vae_reconstruct
    n = int(spec["n_seq"])
    group = dist.new_group(list(range(n)))
    if rank >= n:
        return {}
    vae = LAVae(**spec["vae"])
    vae.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in data["state"].items()}, strict=True)
    vae.eval()
    feats, z, mu, logvar, valid = sp_vae_reconstruct(
        vae, tensors(data["features"]), tensors(data["lengths"]),
        tensors(data["eps"]), group=group)
    (feats.pow(2).sum() + mu.pow(2).sum()).backward()
    grads = {}
    for name, p in vae.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        dist.all_reduce(g, group=group)
        grads[name] = g / n
    return {"out": {"feats": feats, "z": z, "mu": mu, "logvar": logvar,
                    "valid": valid}, "grads": grads}


def pp_encoder(rank, world, spec, data) -> dict:
    """``pipeline_encoder_forward`` of an MD skip stack over the first S
    ranks: the output, and the stack's gradient of ``sum(y * w)`` after
    ``reduce_stage_grads``."""
    from ladiff_torch.ops.stylization import MDSkipTransformerEncoder
    from ladiff_torch.parallel.pp import (make_pipe_group,
                                          pipeline_encoder_forward,
                                          reduce_stage_grads)
    S = int(spec["stages"])
    group = make_pipe_group(S)
    if rank >= S:
        return {}
    enc = MDSkipTransformerEncoder(**spec["encoder"])
    enc.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in data["state"].items()}, strict=True)
    x = tensors(data["x"]).requires_grad_()
    valid = tensors(data["valid"]).bool() if "valid" in data else None
    y = pipeline_encoder_forward(enc, x, tensors(data["xf"]),
                                 tensors(data["emb"]), valid, group=group,
                                 n_micro=int(spec["n_micro"]))
    (y * tensors(data["w"])).sum().backward()
    reduce_stage_grads(enc, group)
    return {"y": y, "grads": {n: p.grad for n, p in enc.named_parameters()
                              if p.grad is not None}}


def pp_step(rank, world, spec, data) -> dict:
    """One SGD(1.0) step of ``make_pp_diffusion_train_step`` over the first
    S ranks: the denoiser's parameters after it and the logs."""
    from ladiff_torch.parallel.pp import (make_pipe_group,
                                          make_pp_diffusion_train_step)
    S = int(spec["stages"])
    group = make_pipe_group(S)
    if rank >= S:
        return {}
    system = build_system(spec, data["state"])
    step = make_pp_diffusion_train_step(system, group=group,
                                        n_micro=int(spec["n_micro"]))
    opt = torch.optim.SGD(system.denoiser.parameters(), lr=1.0)
    logs = step(opt, tensors(data["batch"]), tensors(data["uncond"]),
                **tensors(data["draws"]["0"]))
    return {"logs": {"0": {k: float(v) for k, v in logs.items()}},
            "params": {"denoiser." + k: v for k, v in
                       system.denoiser.state_dict().items()}}


def eval_test(rank, world, spec, data) -> dict:
    """``ladiff_torch.test.run_test`` of the configuration file
    ``spec["cfg"]`` with ``spec["overrides"]`` and the state dict, with a
    text encoder of a hash of each caption: every metric's (mean, conf)."""
    import logging

    from ladiff_torch.test import run_test
    cfg = _cfg(spec)
    cfg["FOLDER_EXP"] = spec["folder"]
    logger = logging.getLogger(f"ranks.eval.{rank}")
    logger.setLevel(logging.WARNING)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in data["state"].items()}
    out = run_test(cfg, logger, text_encoder=text_features,
                   state_dict=state, device="cpu")
    return {k: np.array(v) for k, v in out.items()}


# -- the rank entry ----------------------------------------------------------

def _main(rank, world, store, jobs_json, in_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        data = load_npz(in_path)
        results = {}
        for name, job, spec in json.loads(jobs_json):
            results[name] = globals()[job](rank, world, spec,
                                           data.get(name, {}))
            dist.barrier()
        if rank == 0:
            np.savez(out_path, **flatten(results))
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def spawn(world: int, jobs, inputs: dict, tmp, timeout: float = 300.0
          ) -> dict:
    """Runs ``jobs`` ([(name, job function name, spec)]) on ``world``
    spawned ranks with ``inputs[name]`` each; returns rank 0's results by
    name."""
    import torch.multiprocessing as mp
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    in_path = os.path.join(tmp, "in.npz")
    out_path = os.path.join(tmp, "out.npz")
    np.savez(in_path, **flatten(inputs))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(
        r, world, os.path.join(tmp, "store"), json.dumps(jobs), in_path,
        out_path)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():  # a rank failed and left the others waiting
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")
    return load_npz(out_path)
