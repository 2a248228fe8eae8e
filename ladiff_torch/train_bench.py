"""Training-step benchmark of the PyTorch port: steps per second of the
three training stages on one GPU.

    python -m ladiff_torch.train_bench [--cpu] [--breakdown]
                                       [--whole-layer {0,1,enc,dec}]

Protocol (the JAX package's ``scripts/train_bench.py``): the published
HumanML3D model (9 + 9 skip VAE layers and the 9-layer MD-trans denoiser,
d 256, ff 1024, 4 heads, 263 features, MAX_IT 5, FRAME_PER_LATENT 48,
dropout 0.1), float32 parameters and AdamW moments with bf16 compute, batch
128 of 196-frame motions with the length ramp ``40 + (8 i) mod 157`` and
pooled text features ``RandomState(1).randn(B, 1, 768)``, a zero
unconditional embedding, the same seeded batch every step, random weights
from a seed.  Stages: ``vae_train`` (the LA-VAE), ``diffusion_train`` (the
denoiser against the frozen VAE), ``vae_diffusion_train`` (both trees, with
the 10-step guided sampling run and the decode of its latents).  After
``WARMUP`` untimed steps, ``ITERS`` steps are timed between two
``torch.cuda.synchronize()`` calls.

``--whole-layer`` runs the VAE's training layers as the whole-layer kernels
12 (encoder) and 13 (decoder), or only the named stack's ("0", the default,
keeps kernels 8 and 9 for both).

Prints one JSON line per stage: {"stage", "batch", "ms_per_step",
"samples_per_sec", "whole_layer", "device", ...}.  ``--cpu`` runs the plain
PyTorch paths in float32 (a sanity check; its numbers are not GPU
numbers).
``--breakdown`` (GPU only) adds a second JSON line per stage that says where
a step's time goes: device time per group of kernels from ``torch.profiler``
over the timed steps and the device's idle share; the host's time per step in
the step's own bookkeeping (mode switches, gradient norm, backward, AdamW)
from ``cProfile`` over as many further steps; for ``vae_train`` also the
plain (non-kernel) parts of the step run on their own at the step's shapes
(cross-attention, skip linears and in/out layers, loss and joints, AdamW),
each with its device time and its host wall time.
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
from ladiff_torch.training.trainer import (diffusion_train_step,
                                           make_optimizer,
                                           vae_diffusion_train_step,
                                           vae_train_step)
from ladiff_torch.utils.device import resolve_device

__all__ = ["STAGES", "build", "make_batch", "make_step", "measure",
           "breakdown", "main"]

BATCH, FRAMES, NFEATS, NJOINTS, TEXT_DIM = 128, 196, 263, 22, 768
DROPOUT, WARMUP, ITERS = 0.1, 2, 20
STAGES = ("vae_train", "diffusion_train", "vae_diffusion_train")


def build(device=None, dropout: float = DROPOUT, stage: str = "vae_train",
          **overrides):
    """The published-scale system (float32 parameters; bf16 compute on
    CUDA) with random weights from seed 0, and the optimizer of ``stage``:
    over the VAE, the denoiser, or both."""
    if stage not in STAGES:
        raise ValueError(f"stage should be one of {STAGES}, not {stage}")
    device = resolve_device(device)
    kw = dict(nfeats=NFEATS, njoints=NJOINTS, max_frames=FRAMES,
              latent_dim=(7, 256), ff_size=1024, num_layers=9, num_heads=4,
              text_encoded_dim=TEXT_DIM, num_inference_timesteps=50,
              mean=np.zeros(NFEATS, np.float32),
              std=np.ones(NFEATS, np.float32), dropout=dropout)
    kw.update(overrides)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        system = LADiffSystem(device=device, param_dtype=torch.float32, **kw)
    trained = {"vae_train": system.vae, "diffusion_train": system.denoiser,
               "vae_diffusion_train": system}[stage]
    return system, make_optimizer(trained.parameters(), 1e-4)


def make_batch(batch: int = BATCH, frames: int = FRAMES,
               nfeats: int = NFEATS, device=None) -> Dict[str, torch.Tensor]:
    """The fixed synthetic batch: N(0, 1) motions from numpy seed 0, the
    length ramp 40, 48, 56, ... wrapping inside [40, frames], and N(0, 1)
    pooled text features from numpy seed 1."""
    span = max(frames - 39, 1)
    lengths = np.minimum(40 + (8 * np.arange(batch)) % span, frames)
    motion = np.random.RandomState(0).randn(batch, frames, nfeats)
    text = np.random.RandomState(1).randn(batch, 1, TEXT_DIM)
    return {"motion": torch.as_tensor(motion.astype(np.float32),
                                      device=device),
            "length": torch.as_tensor(lengths.astype(np.int64),
                                      device=device),
            "text_emb": torch.as_tensor(text.astype(np.float32),
                                        device=device)}


def make_step(system, optimizer, batch,
              stage: str = "vae_train") -> Callable[[torch.Generator], Dict]:
    """``step(generator)``: one optimizer step of ``stage`` on ``batch``."""
    if stage == "vae_train":
        return lambda gen: vae_train_step(system, optimizer, batch, gen)
    uncond = torch.zeros(1, 1, TEXT_DIM, device=system.device)
    fn = {"diffusion_train": diffusion_train_step,
          "vae_diffusion_train": vae_diffusion_train_step}[stage]
    return lambda gen: fn(system, optimizer, batch, uncond, gen)


def measure(system, optimizer, batch, iters: int = ITERS,
            warmup: int = WARMUP, stage: str = "vae_train") -> Dict:
    """``warmup`` untimed steps of ``stage``, then ``iters`` timed ones."""
    dev = system.device
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    step = make_step(system, optimizer, batch, stage)
    for _ in range(warmup):
        logs = step(gen)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        logs = step(gen)
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
    ("fused_md_layer (guided sampling of the joint stage)",
     r"md_layer_kernel"),
    ("fused_masked_attention (frozen encode)", r"attn_tile_kernel"),
    ("fused_postnorm_ffn (frozen encode; kernel 9's forward at rate 0 too)",
     r"ffn_tail_fwd_kernel<\d+, false"),
    ("kernel 12 tail fwd (out-projection to LN2)", r"enc_tail_fwd_kernel"),
    ("kernel 12 tail bwd (dout to dctx)", r"enc_tail_bwd_kernel"),
    ("kernel 13 tail fwd (out-projection to LN3)", r"dec_tail_fwd_kernel"),
    ("kernel 13 tail bwd (dout to dctx) and memory gradient sums",
     r"dec_tail_bwd_|kv_reduce_kernel"),
    ("kernel 13 projections (qkv, the memory's k and v; dx, dmem)",
     r"linear64_kernel"),
    # kernel 8's products on the GEMM block (csrc/gemm_sm90.cuh: the tile
    # width, the epilogue, A and B MN-major)
    ("train_self_attention fwd (kernel 12's projection and the tiled"
     " attention of kernels 12 and 13 too)",
     r"gemm_sm90_kernel<\d+, [056], false, false>|attn_fwd_kernel"),
    ("train_self_attention bwd, without weight gradients (the tiled"
     " attention of kernels 12 and 13 and kernel 12's dx too)",
     r"dattn_kernel|gemm_sm90_kernel<\d+, [57], false, true>|attn_bwd_kernel"),
    ("train_postnorm_ffn fwd", r"ffn_tail_fwd_kernel"),
    ("train_postnorm_ffn bwd, without weight gradients",
     r"ffn_tail_bwd_kernel"),
    ("weight and bias gradients of both backwards",
     r"ladiff::(wgrad|colsum|reduce)_kernel|gemm_sm90_kernel<\d+, 8,"),
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


# host functions of ``_host_ms``: (row name, file suffix, function name)
_HOST_ROWS = (
    ("Module.train (mode switches of the stage forwards)",
     "nn/modules/module.py", "train"),
    ("global_norm", "training/trainer.py", "global_norm"),
    ("Tensor.backward", "torch/_tensor.py", "backward"),
    ("optimizer.step", "torch/optim/optimizer.py", "wrapper"),
)


def _host_ms(step: Callable, gen: torch.Generator, iters: int) -> Dict:
    """Host time per step under ``cProfile`` (which slows Python down, so
    read the rows against ``profiled_wall_ms_per_step`` beside them, not
    against an unprofiled step): cumulative ms in each ``_HOST_ROWS``
    function, counted once where it recurses, and its calls per step."""
    import cProfile
    import pstats
    sync = (torch.cuda.synchronize if gen.device.type == "cuda"
            else lambda: None)
    sync()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(iters):
        step(gen)
    sync()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    rows = {}
    for (path, _, fn), (_, ncalls, _, cum, _) in pstats.Stats(
            prof).stats.items():
        for name, suffix, want in _HOST_ROWS:
            if fn == want and path.replace("\\", "/").endswith(suffix):
                rows[name] = {"ms": cum / iters * 1e3,
                              "calls": ncalls / iters}
    return {"profiled_wall_ms_per_step": wall_ms, "ms_per_step": rows}


def breakdown(system, optimizer, batch, iters: int = 5,
              stage: str = "vae_train") -> Dict:
    """Where a training step's time goes on the GPU (call after
    ``measure``, which leaves gradients in place for the AdamW row)."""
    from torch.profiler import ProfilerActivity, profile
    dev = system.device
    gen = torch.Generator(device=dev).manual_seed(3)
    step = make_step(system, optimizer, batch, stage)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # device activity only: with CPU activity on, an operator's row would
    # repeat the time of the kernels it launched
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step(gen)
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
    out = {"profiled_wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms, "device_ms_by_group": groups,
           "host_under_cprofile": _host_ms(step, gen, iters)}
    if stage != "vae_train":
        return out

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
    mv = latent_valid_mask(lengths, vae.frame_per_latent, vae.n_lat)
    x = torch.randn(B, T, D, device=dev, dtype=dt, requires_grad=True)
    xe = torch.randn(B, T + vae.global_motion_token.shape[0], D, device=dev,
                     dtype=dt, requires_grad=True)
    mem = torch.randn(B, vae.n_lat, D, device=dev, dtype=dt,
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
    out["plain_parts_on_their_own"] = plain
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="plain PyTorch paths in float32 on the CPU")
    ap.add_argument("--breakdown", action="store_true",
                    help="a second line: where the step's time goes (GPU)")
    ap.add_argument("--whole-layer", default="0",
                    choices=("0", "1", "enc", "dec"),
                    help="VAE training layers as kernels 12 / 13")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None
    if args.breakdown and args.cpu:
        raise SystemExit("--breakdown measures the GPU")
    for stage in STAGES:
        system, optimizer = build(device, stage=stage,
                                  train_whole_layer=args.whole_layer)
        batch = make_batch(device=system.device)
        res = measure(system, optimizer, batch, stage=stage)
        if not (np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"])):
            raise SystemExit(f"{stage}: non-finite loss or gradient norm")
        dev = system.device
        print(json.dumps({
            "stage": stage, "batch": BATCH,
            "ms_per_step": round(res["ms_per_step"], 2),
            "samples_per_sec": round(res["samples_per_sec"], 1),
            "loss": res["loss"], "grad_norm": res["grad_norm"],
            "peak_mem_gb": res["peak_mem_gb"],
            "whole_layer": args.whole_layer,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
        }), flush=True)
        if args.breakdown:
            out = breakdown(system, optimizer, batch, stage=stage)
            out["idle_share"] = (1.0 - out["device_ms_per_step"]
                                 / res["ms_per_step"])
            print(json.dumps({"stage": f"{stage}_breakdown", **out}),
                  flush=True)
        del system, optimizer, batch


if __name__ == "__main__":
    main()
