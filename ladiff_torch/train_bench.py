"""Training-step benchmark of the PyTorch port: stage-1 (LA-VAE) steps per
second on one GPU.

    python -m ladiff_torch.train_bench [--cpu] [--breakdown]

Protocol (the JAX package's ``scripts/train_bench.py``, stage ``vae_train``):
the published HumanML3D model (9 + 9 skip layers, d 256, ff 1024, 4 heads,
263 features, MAX_IT 5, FRAME_PER_LATENT 48, dropout 0.1), float32
parameters and AdamW moments with bf16 compute, batch 128 of 196-frame
motions with the length ramp ``40 + (8 i) mod 157``, the same seeded batch
every step, random weights from a seed.  After ``WARMUP`` untimed steps,
``ITERS`` steps are timed between two ``torch.cuda.synchronize()`` calls.

Prints one JSON line: {"stage", "batch", "ms_per_step", "samples_per_sec",
"device", ...}.  ``--cpu`` runs the plain PyTorch paths in float32 (a
sanity check; its numbers are not GPU numbers).  ``--breakdown`` (GPU only)
adds a second JSON line that says where a step's time goes: device time per
group of kernels from ``torch.profiler`` over the timed steps, the device's
idle share, and the plain (non-kernel) parts of the step run on their own at
the step's shapes (cross-attention, skip linears and in/out layers, loss and
joints, AdamW), each with its device time and its host wall time.
"""
from __future__ import annotations

import argparse
import json
import re
import time
from typing import Callable, Dict

import numpy as np
import torch

from ladiff_torch.models.ladiff import LADiffSystem
from ladiff_torch.training.trainer import make_optimizer, vae_train_step
from ladiff_torch.utils.device import resolve_device

__all__ = ["build", "make_batch", "measure", "breakdown", "main"]

BATCH, FRAMES, NFEATS, NJOINTS = 128, 196, 263, 22
DROPOUT, WARMUP, ITERS = 0.1, 2, 20


def build(device=None, dropout: float = DROPOUT, **overrides):
    """The published-scale system (float32 parameters; bf16 compute on
    CUDA) with random weights from seed 0, and its VAE optimizer."""
    device = resolve_device(device)
    kw = dict(nfeats=NFEATS, njoints=NJOINTS, max_frames=FRAMES,
              latent_dim=(7, 256), ff_size=1024, num_layers=9, num_heads=4,
              text_encoded_dim=768, num_inference_timesteps=50,
              mean=np.zeros(NFEATS, np.float32),
              std=np.ones(NFEATS, np.float32), dropout=dropout)
    kw.update(overrides)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        system = LADiffSystem(device=device, param_dtype=torch.float32, **kw)
    return system, make_optimizer(system.vae.parameters(), 1e-4)


def make_batch(batch: int = BATCH, frames: int = FRAMES,
               nfeats: int = NFEATS, device=None) -> Dict[str, torch.Tensor]:
    """The fixed synthetic batch: N(0, 1) motions from numpy seed 0 and the
    length ramp 40, 48, 56, ... wrapping inside [40, frames]."""
    span = max(frames - 39, 1)
    lengths = np.minimum(40 + (8 * np.arange(batch)) % span, frames)
    motion = np.random.RandomState(0).randn(batch, frames, nfeats)
    return {"motion": torch.as_tensor(motion.astype(np.float32),
                                      device=device),
            "length": torch.as_tensor(lengths.astype(np.int64),
                                      device=device)}


def measure(system, optimizer, batch, iters: int = ITERS,
            warmup: int = WARMUP) -> Dict:
    """``warmup`` untimed steps, then ``iters`` timed ones."""
    dev = system.device
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(warmup):
        logs = vae_train_step(system, optimizer, batch, gen)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        logs = vae_train_step(system, optimizer, batch, gen)
    if cuda:
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    B = int(batch["motion"].shape[0])
    return {"ms_per_step": dt * 1e3, "samples_per_sec": B / dt,
            "loss": float(logs["total"]),
            "grad_norm": float(logs["grad_norm"]),
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if cuda else None)}


# device-time groups of ``breakdown``: first matching pattern wins
_GROUPS = (
    ("train_self_attention fwd",
     r"linear_kernel|attn_fwd_kernel|out_proj_kernel"),
    ("train_self_attention bwd, without weight gradients",
     r"dctx_kernel|attn_bwd_kernel|dx_kernel"),
    ("train_postnorm_ffn fwd", r"train_ffn_fwd_kernel"),
    ("train_postnorm_ffn bwd, without weight gradients",
     r"train_ffn_bwd_kernel"),
    ("weight and bias gradients of both backwards",
     r"ladiff::(wgrad|colsum|reduce)_kernel"),
    ("AdamW", r"multi_tensor_apply|[Aa]dam"),
    ("library GEMMs", r"gemm|cutlass|nvjet|cublas"),
    ("memcpy and memset", r"[Mm]emcpy|[Mm]emset"),
    ("other ATen kernels", r""),
)


def _part_ms(fn: Callable[[], None], reps: int = 5) -> Dict[str, float]:
    """Device time (the sum of its kernels, from the profiler) and host
    wall time of one call of ``fn``, in ms."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    dev_us = sum(getattr(ev, "self_device_time_total", 0.0)
                 for ev in prof.key_averages())
    return {"device_ms": dev_us / reps / 1e3, "wall_ms": wall}


def breakdown(system, optimizer, batch, iters: int = 5) -> Dict:
    """Where a training step's time goes on the GPU (call after
    ``measure``, which leaves gradients in place for the AdamW row)."""
    from torch.profiler import ProfilerActivity, profile
    dev = system.device
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # device activity only: with CPU activity on, an operator's row would
    # repeat the time of the kernels it launched
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            vae_train_step(system, optimizer, batch, gen)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    groups = {name: 0.0 for name, _ in _GROUPS}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        for name, pat in _GROUPS:
            if re.search(pat, ev.key):
                groups[name] += us / iters / 1e3
                break
    device_ms = sum(groups.values())

    # the plain parts on their own, forward and backward, at the step's
    # shapes and in the step's types
    vae = system.vae
    B, T = batch["motion"].shape[:2]
    D = vae.final_layer.in_features
    dt = system.dtype
    lengths = batch["length"]
    from ladiff_torch.losses.mld import vae_loss
    from ladiff_torch.ops.transformer import _drop, layer_norm, linear
    from ladiff_torch.utils.masks import latent_valid_mask
    mv = latent_valid_mask(lengths, vae.frame_per_latent, vae.max_it)
    x = torch.randn(B, T, D, device=dev, dtype=dt, requires_grad=True)
    xe = torch.randn(B, T + 2 * vae.max_it, D, device=dev, dtype=dt,
                     requires_grad=True)
    mem = torch.randn(B, vae.max_it, D, device=dev, dtype=dt,
                      requires_grad=True)
    feats = torch.randn(B, T, vae.final_layer.out_features, device=dev,
                        dtype=dt, requires_grad=True)
    vae.train()

    def cross_attention():
        for layer in vae.decoder.ordered_blocks():
            t = layer_norm(layer.norm1, x)
            y = layer.multihead_attn(t, mem, mem, mv, generator=gen)
            (t + _drop(y, layer.dropout, gen)).float().sum().backward()

    def skip_linears():
        h = linear(vae.skel_embedding, batch["motion"].to(dt))
        h = vae.query_pos_encoder(h).float().sum()
        for stack, t in ((vae.encoder, xe), (vae.decoder, x)):
            for lin in stack.linear_blocks:
                h = h + linear(lin, torch.cat([t, t], -1)).float().sum()
            h = h + layer_norm(stack.norm, t).float().sum()
        h = h + linear(vae.final_layer, x).float().sum()
        h.backward()

    def loss_and_joints():
        total, _ = vae_loss(feats, batch["motion"],
                            system.feats2joints(feats),
                            system.feats2joints(batch["motion"]),
                            mem, mem, system.weights)
        total.backward()

    plain = {"cross-attention with norm1 and residual dropout, 9 layers":
             _part_ms(cross_attention),
             "skip linears, embedding, final norms and output layer":
             _part_ms(skip_linears),
             "loss and joints": _part_ms(loss_and_joints)}
    grads = {p: p.grad.clone() for p in vae.parameters()
             if p.grad is not None}

    def adamw():
        for p, g in grads.items():
            p.grad = g
        optimizer.step()

    plain["AdamW step"] = _part_ms(adamw)
    vae.eval()
    optimizer.zero_grad(set_to_none=True)
    return {"profiled_wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms,
            "device_ms_by_group": groups,
            "plain_parts_on_their_own": plain}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="plain PyTorch paths in float32 on the CPU")
    ap.add_argument("--breakdown", action="store_true",
                    help="a second line: where the step's time goes (GPU)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None
    system, optimizer = build(device)
    batch = make_batch(device=system.device)
    res = measure(system, optimizer, batch)
    if not (np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"])):
        raise SystemExit("non-finite loss or gradient norm")
    dev = system.device
    print(json.dumps({
        "stage": "vae_train", "batch": BATCH,
        "ms_per_step": round(res["ms_per_step"], 2),
        "samples_per_sec": round(res["samples_per_sec"], 1),
        "loss": res["loss"], "grad_norm": res["grad_norm"],
        "peak_mem_gb": res["peak_mem_gb"],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }))
    if args.breakdown:
        if dev.type != "cuda":
            raise SystemExit("--breakdown measures the GPU")
        out = breakdown(system, optimizer, batch)
        out["idle_share"] = (1.0 - out["device_ms_per_step"]
                             / res["ms_per_step"])
        print(json.dumps({"stage": "vae_train_breakdown", **out}))


if __name__ == "__main__":
    main()
