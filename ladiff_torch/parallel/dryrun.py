"""Multi-process dry run of every parallel layout (counterpart of the
repository's ``__graft_entry__.dryrun_multichip``):

    python -m ladiff_torch.parallel.dryrun 2 [--device cuda|cpu]

``dryrun_multiprocess(n, device)`` spawns ``n`` ranks on the card unless
``device`` is "cpu" (``utils/device.resolve_device``: no card raises) (rendezvous through a
file store in a temporary directory, so runs side by side never share a
port).  Each rank builds the same tiny system from one seed and runs one
step of every layout ``n`` admits, as the JAX dry run does: data
parallelism in stages ``vae`` and ``diffusion``; at ``n >= 2`` FSDP, tensor
parallelism (``model`` width 2, or ``n`` where 2 does not divide it) and
sequence parallelism (width ``n``, stage ``vae``); at ``n >= 3`` the
pipeline over 3 stages of a 9-layer MD stack (stage ``diffusion``); then
one data-parallel evaluation batch.  Ranks share a card where ``n`` exceeds
the cards there are, over gloo (NCCL refuses two ranks on one device); gloo
takes no send / recv for CUDA tensors, so there the pipeline is left out.
Returns rank 0's record: the backend, each step's loss and gradient norm,
the layouts ``n`` admits that were left out (``skipped``) and the
evaluation outputs' shapes.

``probe_collectives(n, device, backend)`` spawns ``n`` ranks that try each
collective the layouts use (all_reduce, broadcast, all_gather,
all_gather_into_tensor, reduce_scatter_tensor, send / recv) on a tensor of
``device`` and report which the backend takes: gloo takes a subset of them
for CUDA tensors, and ranks that share one card cannot use NCCL.

    python -m ladiff_torch.parallel.dryrun 2 --device cuda --probe
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["dryrun_multiprocess", "probe_collectives", "tiny_system"]

COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor",
               "send_recv")

D, H, FF, NFEATS, T = 48, 4, 96, 263, 32


def tiny_system(device, seed: int = 0, num_layers: int = 9,
                vae_num_layers: int = 3):
    """The dry run's system: d 48, 4 heads, ff 96, a 3-layer VAE and a
    9-layer MD denoiser, 32 frames, parameters from ``seed``."""
    from ladiff_torch.models.ladiff import LADiffSystem
    rng = np.random.RandomState(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return LADiffSystem(
            nfeats=NFEATS, njoints=22, max_frames=T, latent_dim=(7, D),
            ff_size=FF, num_layers=num_layers, vae_num_layers=vae_num_layers,
            num_heads=H, frame_per_latent=8, num_inference_timesteps=4,
            guidance_uncondp=0.1, dropout=0.0,
            mean=(rng.randn(NFEATS) * 0.1).astype(np.float32),
            std=np.ones(NFEATS, np.float32), device=device)


def _batch(B: int, device) -> Dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(1)
    lengths = torch.randint(8, T + 1, (B,), generator=g)
    return {k: v.to(device) for k, v in {
        "motion": torch.randn(B, T, NFEATS, generator=g),
        "length": lengths, "text_emb": torch.randn(B, 1, 768, generator=g),
        "word_embs": torch.randn(B, 22, 300, generator=g),
        "pos_ohot": torch.randn(B, 22, 15, generator=g),
        "text_len": torch.full((B,), 12)}.items()}


def _rank(rank: int, world: int, store: str, device: str, out: str) -> None:
    import torch.distributed as dist

    from ladiff_torch.evaluation.t2m_eval import T2MEvaluator, eval_step
    from ladiff_torch.parallel.mesh import make_mesh
    from ladiff_torch.parallel.pp import (make_pipe_group,
                                          make_pp_diffusion_train_step)
    from ladiff_torch.training.trainer import (global_draws,
                                               make_optimizer,
                                               make_parallel_step)
    torch.set_num_threads(1)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    dev = torch.device(f"cuda:{rank % cards}" if cards else "cpu")
    if cards:
        torch.cuda.set_device(dev)
    backend = "nccl" if cards and world <= cards else "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh_type = "cuda" if cards else "cpu"
    B = 2 * world
    batch = _batch(B, dev)
    uncond = torch.zeros(1, 1, 768, device=dev)
    record = {"world": world, "backend": backend, "steps": {},
              "skipped": []}

    def run(name, stage, layout, n_model=1):
        system = tiny_system(dev)
        mesh = make_mesh(n_model=n_model, device_type=mesh_type)
        step, _, _ = make_parallel_step(system, stage, layout, mesh,
                                        uncond_emb=uncond)
        logs = step({k: batch[k] for k in ("motion", "length", "text_emb")},
                    torch.Generator(device=dev).manual_seed(2))
        record["steps"][name] = {k: float(logs[k])
                                 for k in ("total", "grad_norm")}

    run("dp_vae", "vae", "dp")
    run("dp_diffusion", "diffusion", "dp")
    if world >= 2:
        n_tp = 2 if world % 2 == 0 else world
        run("fsdp_vae", "vae", "fsdp")
        run("fsdp_diffusion", "diffusion", "fsdp")
        run("tp_vae", "vae", "tp", n_tp)
        run("tp_diffusion", "diffusion", "tp", n_tp)
        run("sp_vae", "vae", "sp", world)
    # the pipeline's send / recv: gloo takes none for CUDA tensors
    if world >= 3 and cards and backend == "gloo":
        record["skipped"].append("pp_diffusion")
    elif world >= 3:
        group = make_pipe_group(3)
        if rank < 3:
            system = tiny_system(dev)
            step = make_pp_diffusion_train_step(system, group=group,
                                                n_micro=3)
            gen = torch.Generator(device=dev).manual_seed(2)
            pp_batch = {k: batch[k][:6] for k in ("motion", "length",
                                                  "text_emb")}
            logs = step(make_optimizer(system.denoiser.parameters()),
                        pp_batch, uncond,
                        **global_draws(system, "diffusion", 6, gen))
            record["steps"]["pp_diffusion"] = {
                k: float(logs[k]) for k in ("total", "grad_norm")}
    system = tiny_system(dev)
    evaluator = T2MEvaluator.random_init(NFEATS, device=dev)
    out_eval = eval_step(
        system, evaluator, batch, batch["text_emb"],
        uncond.expand(B, -1, -1), "diffusion",
        mean_eval=np.zeros(NFEATS, np.float32),
        std_eval=np.ones(NFEATS, np.float32),
        init_latents=torch.randn(B, 5, D, generator=torch.Generator()
                                 .manual_seed(3)).to(dev))
    record["eval_shapes"] = {k: list(v.shape) for k, v in out_eval.items()}
    bad = [k for k, v in record["steps"].items()
           if not all(np.isfinite(list(v.values())))]
    if bad:
        raise RuntimeError(f"rank {rank}: non-finite steps {bad}")
    if rank == 0:
        with open(out, "w") as f:
            json.dump(record, f)
    dist.barrier()
    dist.destroy_process_group()


def _probe_rank(rank: int, world: int, store: str, device: str,
                backend: str, name: str) -> None:
    import torch.distributed as dist
    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    x = torch.full((4,), float(rank + 1), device=dev)
    if name == "all_reduce":
        dist.all_reduce(x)
    elif name == "broadcast":
        dist.broadcast(x, 0)
    elif name == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(x.new_empty(4 * world), x)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(x.new_empty(4), x.repeat(world))
    elif rank == 0:
        dist.send(x, 1)
    elif rank == 1:
        dist.recv(x, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()


def probe_collectives(n: int = 2, device: str = "cuda",
                      backend: str = "gloo") -> dict:
    """Which of ``COLLECTIVES`` ``backend`` takes for tensors on
    ``device`` (every rank on card 0), each in ranks of its own (a
    collective the backend does not take may abort its process):
    {"collectives": {name: "ok" or how the ranks ended}}."""
    import torch.multiprocessing as mp
    record = {}
    for name in COLLECTIVES:
        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.get_context("spawn")
            procs = [ctx.Process(target=_probe_rank, args=(
                r, n, os.path.join(tmp, "store"), device, backend, name))
                for r in range(n)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(120)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in procs]
            record[name] = "ok" if not any(codes) else f"exit codes {codes}"
    return {"backend": backend, "device": device, "world": n,
            "collectives": record}


def dryrun_multiprocess(n: int, device: Optional[str] = None,
                        workdir: Optional[str] = None) -> dict:
    """Spawns ``n`` ranks on ``device`` (the card unless "cpu") and runs
    every layout ``n`` admits for one step (module docstring); returns
    rank 0's record.  Raises if a rank fails."""
    import torch.multiprocessing as mp

    from ladiff_torch.utils.device import resolve_device
    device = resolve_device(device).type
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        out = os.path.join(tmp, "record.json")
        mp.start_processes(_rank, args=(n, os.path.join(tmp, "store"),
                                        device, out),
                           nprocs=n, start_method="spawn")
        with open(out) as f:
            return json.load(f)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the card unless cpu is named")
    ap.add_argument("--probe", action="store_true",
                    help="probe gloo's collectives instead of the dry run")
    args = ap.parse_args()
    print(json.dumps(probe_collectives(args.n, args.device or "cuda")
                     if args.probe
                     else dryrun_multiprocess(args.n, args.device)))
    sys.exit(0)
