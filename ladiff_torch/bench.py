"""Generation benchmark of the PyTorch port: DDIM-50 samples/s on one GPU.

    python -m ladiff_torch.bench [--md-stack | --full-context]

Protocol (the JAX package's ``bench.py``): batch 256 classifier-free-guided
(scale 7.5) DDIM-50 generation of 196-frame HumanML3D motions (263 feats)
at the published scale (9-layer MD-trans denoiser and 9-layer LA-VAE
decoder, d 256, ff 1024, 4 heads), bf16 weights and compute, random weights
from a seed.  Each batch encodes fresh captions with the CLIP ViT-L/14 text
tower inside the timed region: SOT + 8..28 random BPE ids + EOT at the
32-token bucket.  The unconditional embedding is a constant of the model
(zeros, as in ``bench.py``).  After one untimed warm-up batch, three
batches run back to back and are timed in steady state with
``torch.cuda.synchronize()`` after each.

Two other routes of generation, for their times: ``--md-stack`` runs the
denoiser's whole skip stack as one kernel per step (``LADiffSystem(...,
md_stack=True)``); ``--full-context`` conditions on CLIP's full-context
features (``last_hidden_state``): the same captions encoded at the 77-token
context with ``return_hidden``, and zeros [B, 77, 768] as the unconditional
embedding, so every MD layer takes its per-block route.  The two do not
combine: the stack route takes one text token.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", "device"},
and "route" for another route than the default.  ``breakdown`` (which
``chip_smoke.py`` calls) gives one more batch's device time by kernel group
and the device's idle share.
"""
from __future__ import annotations

import argparse
import json
import re
import time
from typing import Dict, List

import numpy as np
import torch

from ladiff_torch.models.clip_text import CLIPTextTower
from ladiff_torch.models.ladiff import LADiffSystem
from ladiff_torch.utils.device import resolve_device

__all__ = ["build", "make_caption_ids", "run_batch", "measure", "main"]

REF_SAMPLES_PER_SEC = 4.6  # MLD DDIM-50 on a V100 (see bench.py)
BATCH, STEPS, FRAMES, BUCKET, CONTEXT = 256, 50, 196, 32, 77
NFEATS, NJOINTS = 263, 22
BATCHES, WARMUP = 3, 1


def build(device=None, md_stack: bool = False, num_heads: int = 4):
    """The bench-scale system and text tower, bf16, with random weights
    from seed 0; ``md_stack``: the whole-stack denoiser route;
    ``num_heads`` 1 (head width 256, which neither K1 nor K2 takes): the
    denoiser's and decoder's per-block routes, with kernel 7."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        system = LADiffSystem(
            nfeats=NFEATS, njoints=NJOINTS, max_frames=FRAMES,
            latent_dim=(7, 256), ff_size=1024, num_layers=9,
            num_heads=num_heads,
            text_encoded_dim=768, guidance_scale=7.5,
            num_inference_timesteps=STEPS,
            mean=np.zeros(NFEATS, np.float32),
            std=np.ones(NFEATS, np.float32), md_stack=md_stack,
            device=device)
        tower = CLIPTextTower().to(device=device,
                                   dtype=torch.bfloat16).eval()
    return system, tower


def make_caption_ids(n_batches: int, width: int = BUCKET) -> np.ndarray:
    """[n_batches, BATCH, width] ids: SOT, 8..28 body ids, EOT, zero
    padding, from seed 4 (the same captions at any width >= 32)."""
    rs = np.random.RandomState(4)
    ids = np.zeros((n_batches, BATCH, BUCKET), np.int64)
    for b in range(n_batches):
        for s in range(BATCH):
            n = rs.randint(8, 29)
            ids[b, s, 0] = 49406
            ids[b, s, 1:1 + n] = rs.randint(1, 49405, size=n)
            ids[b, s, 1 + n] = 49407
    return np.pad(ids, ((0, 0), (0, 0), (0, width - BUCKET)))


def encode_text(tower, ids: torch.Tensor, full_context: bool = False):
    """Caption ids -> CLIP text: pooled [B, 1, 768], or the full context's
    hidden states [B, 77, 768]."""
    if full_context:
        return tower(ids, return_hidden=True).float()
    return tower(ids)[:, None, :].float()


@torch.no_grad()
def run_batch(system, tower, ids: torch.Tensor, text_uncond: torch.Tensor,
              lengths: torch.Tensor, generator: torch.Generator,
              full_context: bool = False):
    """Caption ids -> CLIP text -> CFG DDIM -> decode: features."""
    feats, _ = system.generate(encode_text(tower, ids, full_context),
                               text_uncond, lengths, generator=generator,
                               nframes=FRAMES)
    return feats


def measure(system, tower, batches: int = BATCHES,
            full_context: bool = False) -> Dict:
    """Steady-state timing of ``batches`` back-to-back generation batches
    after ``WARMUP`` untimed ones."""
    dev = system.device
    width = CONTEXT if full_context else BUCKET
    ids = torch.as_tensor(make_caption_ids(WARMUP + batches, width),
                          device=dev)
    text_uncond = torch.zeros(BATCH, CONTEXT if full_context else 1, 768,
                              device=dev)
    lengths = torch.full((BATCH,), FRAMES, dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(WARMUP):
        run_batch(system, tower, ids[i], text_uncond, lengths, gen,
                  full_context)
    torch.cuda.synchronize()
    times: List[float] = []
    finite = True
    for i in range(WARMUP, WARMUP + batches):
        t0 = time.perf_counter()
        feats = run_batch(system, tower, ids[i], text_uncond, lengths, gen,
                          full_context)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(feats).all())
    return {"samples_per_sec": BATCH * len(times) / sum(times),
            "seconds_per_batch": times, "finite": finite,
            "shape": list(feats.shape)}


# device-time groups of ``breakdown``: first matching pattern wins
_GROUPS = (
    ("fused_md_layer (K1)", r"md_layer_kernel"),
    ("fused_md_stack (kernel 11)", r"md_stack_kernel"),
    ("fused_stylized_ffn (kernel 6)", r"stylized_ffn_kernel"),
    ("fused_broadcast_stylize (kernel 7)", r"stylize_kernel"),
    ("fused_postnorm_ffn (kernel 5)", r"ffn_tail_fwd_kernel"),
    # K3 and K4: the LayerNorm pass on bf16 x (K3) or f32 h (K4), the GEMM
    # block with the q/k/v epilogue (K3) or K4's three
    ("fused_ln_qkv (K3)",
     r"gemm_sm90_kernel<\d+, 0, false, false>|ln_rows_kernel<__nv_bfloat16"),
    ("fused_proj_mlp (K4)",
     r"gemm_sm90_kernel<\d+, [123], false, false>|ln_rows_kernel<float"),
    ("fused_decoder_layer (K2)",
     r"linear64_kernel|attn_tile_kernel|dec_tail_fwd_kernel"),
    ("library GEMMs", r"gemm|cutlass|nvjet|cublas"),
    ("memcpy and memset", r"[Mm]emcpy|[Mm]emset"),
    ("other ATen kernels (plain attention, linear cross-attention, "
     "norms, sampler)", r""),
)


@torch.no_grad()
def breakdown(system, tower, seconds_per_batch: List[float],
              full_context: bool = False) -> Dict:
    """Where one generation batch's time goes on the GPU (call after
    ``measure``, warm): the device time of one more batch's kernels by
    group, from the profiler; the idle share against ``measure``'s
    unprofiled ``seconds_per_batch`` (the profiler slows the host).  The
    batch is ``run_batch`` in its three parts (text encode, sampling,
    decode), each in a profiler session of its own: one session over the
    full-context route's ~20 k kernels lost the events at its end."""
    from torch.profiler import ProfilerActivity, profile
    dev = system.device
    width = CONTEXT if full_context else BUCKET
    ids = torch.as_tensor(make_caption_ids(1, width)[0], device=dev)
    text_uncond = torch.zeros(BATCH, CONTEXT if full_context else 1, 768,
                              device=dev)
    lengths = torch.full((BATCH,), FRAMES, dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    parts = (
        lambda: out.update(text=encode_text(tower, ids, full_context)),
        lambda: out.update(z=(system.diffusion_reverse_ar if system.ardiff
                              else system.diffusion_reverse)(
            out["text"], text_uncond, lengths, gen)),
        lambda: system.vae.decode(out["z"].to(system.dtype), lengths,
                                  FRAMES))
    groups = {name: 0.0 for name, _ in _GROUPS}
    wall_ms = 0.0
    for part in parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # device activity only: with CPU activity on, an operator's row
        # would repeat the time of the kernels it launched
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            part()
            torch.cuda.synchronize()
        wall_ms += (time.perf_counter() - t0) * 1e3
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0)
            if us <= 0:
                continue
            for name, pat in _GROUPS:
                if re.search(pat, ev.key):
                    groups[name] += us / 1e3
                    break
    device_ms = sum(groups.values())
    if not device_ms > 0:
        raise RuntimeError("breakdown: the profiler recorded no device time")
    batch_ms = sum(seconds_per_batch) / len(seconds_per_batch) * 1e3
    return {"profiled_wall_ms_per_batch": wall_ms,
            "device_ms_per_batch": device_ms,
            "idle_share": 1.0 - device_ms / batch_ms,
            "device_ms_by_group": groups}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    route = ap.add_mutually_exclusive_group()
    route.add_argument("--md-stack", action="store_true",
                       help="the whole-stack denoiser kernel (kernel 11)")
    route.add_argument("--full-context", action="store_true",
                       help="full-context CLIP text (77 hidden states)")
    args = ap.parse_args()
    system, tower = build(md_stack=args.md_stack)
    res = measure(system, tower, full_context=args.full_context)
    if not res["finite"]:
        raise SystemExit("non-finite features")
    sps = res["samples_per_sec"]
    text = (f"CLIP text encode at the {CONTEXT}-token context (hidden "
            "states)" if args.full_context
            else f"CLIP text encode at the {BUCKET} bucket")
    line = {
        "metric": "ddim50_samples_per_sec_per_chip",
        "value": round(sps, 2),
        "unit": (f"samples/s (batch {BATCH}, {FRAMES} frames, {text} + "
                 f"CFG DDIM-{STEPS} + decode, steady state over {BATCHES} "
                 "batches)"),
        "vs_baseline": round(sps / REF_SAMPLES_PER_SEC, 2),
        "device": torch.cuda.get_device_name(system.device),
    }
    if args.md_stack or args.full_context:
        line["route"] = "md_stack" if args.md_stack else "full_context"
    print(json.dumps(line))


if __name__ == "__main__":
    main()
