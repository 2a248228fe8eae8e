"""Generation benchmark of the PyTorch port: DDIM-50 samples/s on one GPU.

    python -m ladiff_torch.bench

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

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List

import numpy as np
import torch

from ladiff_torch.models.clip_text import CLIPTextTower
from ladiff_torch.models.ladiff import LADiffSystem
from ladiff_torch.utils.device import resolve_device

__all__ = ["build", "make_caption_ids", "run_batch", "measure", "main"]

REF_SAMPLES_PER_SEC = 4.6  # MLD DDIM-50 on a V100 (see bench.py)
BATCH, STEPS, FRAMES, BUCKET = 256, 50, 196, 32
NFEATS, NJOINTS = 263, 22
BATCHES, WARMUP = 3, 1


def build(device=None):
    """The bench-scale system and text tower, bf16, with random weights
    from seed 0."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        system = LADiffSystem(
            nfeats=NFEATS, njoints=NJOINTS, max_frames=FRAMES,
            latent_dim=(7, 256), ff_size=1024, num_layers=9, num_heads=4,
            text_encoded_dim=768, guidance_scale=7.5,
            num_inference_timesteps=STEPS,
            mean=np.zeros(NFEATS, np.float32),
            std=np.ones(NFEATS, np.float32), device=device)
        tower = CLIPTextTower().to(device=device,
                                   dtype=torch.bfloat16).eval()
    return system, tower


def make_caption_ids(n_batches: int) -> np.ndarray:
    """[n_batches, BATCH, 32] ids: SOT, 8..28 body ids, EOT, zero padding,
    from seed 4."""
    rs = np.random.RandomState(4)
    ids = np.zeros((n_batches, BATCH, BUCKET), np.int64)
    for b in range(n_batches):
        for s in range(BATCH):
            n = rs.randint(8, 29)
            ids[b, s, 0] = 49406
            ids[b, s, 1:1 + n] = rs.randint(1, 49405, size=n)
            ids[b, s, 1 + n] = 49407
    return ids


@torch.no_grad()
def run_batch(system, tower, ids: torch.Tensor, text_uncond: torch.Tensor,
              lengths: torch.Tensor, generator: torch.Generator):
    """Caption ids -> CLIP pooled text -> CFG DDIM -> decode: features."""
    text = tower(ids)[:, None, :].float()
    feats, _ = system.generate(text, text_uncond, lengths,
                               generator=generator, nframes=FRAMES)
    return feats


def measure(system, tower, batches: int = BATCHES) -> Dict:
    """Steady-state timing of ``batches`` back-to-back generation batches
    after ``WARMUP`` untimed ones."""
    dev = system.device
    ids = torch.as_tensor(make_caption_ids(WARMUP + batches), device=dev)
    text_uncond = torch.zeros(BATCH, 1, 768, device=dev)
    lengths = torch.full((BATCH,), FRAMES, dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(WARMUP):
        run_batch(system, tower, ids[i], text_uncond, lengths, gen)
    torch.cuda.synchronize()
    times: List[float] = []
    finite = True
    for i in range(WARMUP, WARMUP + batches):
        t0 = time.perf_counter()
        feats = run_batch(system, tower, ids[i], text_uncond, lengths, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(feats).all())
    return {"samples_per_sec": BATCH * len(times) / sum(times),
            "seconds_per_batch": times, "finite": finite,
            "shape": list(feats.shape)}


def main():
    system, tower = build()
    res = measure(system, tower)
    if not res["finite"]:
        raise SystemExit("non-finite features")
    sps = res["samples_per_sec"]
    print(json.dumps({
        "metric": "ddim50_samples_per_sec_per_chip",
        "value": round(sps, 2),
        "unit": (f"samples/s (batch {BATCH}, {FRAMES} frames, CLIP text "
                 f"encode at the {BUCKET} bucket + CFG DDIM-{STEPS} + "
                 f"decode, steady state over {BATCHES} batches)"),
        "vs_baseline": round(sps / REF_SAMPLES_PER_SEC, 2),
        "device": torch.cuda.get_device_name(system.device),
    }))


if __name__ == "__main__":
    main()
