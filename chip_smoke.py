#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ladiff_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. build    every CUDA kernel of the generation path from ``ladiff_torch/csrc``
            (one ``nvcc`` per source, all at once); the card's name and power
            limit as ``nvidia-smi`` reports them.
2. kernels  K1..K4 at the generation path's shapes (mixed lengths), bf16,
            each against its plain PyTorch version on the same inputs
            (computed in float32), with its time, the plain version's time,
            the least time the card could take, and a library call's time
            where one PyTorch call computes the same function.
3. slice    ``LADiffSystem.generate`` at batch 4 with mixed lengths on the
            card (kernels, bf16) against the CPU (plain versions, float32),
            same weights, same initial noise.
4. bench    the ``ladiff_torch.bench`` protocol at full width (batch 256,
            196 frames, 32-token CLIP bucket, CFG DDIM-50 + decode): launch
            counts per batch, samples/s, finite output.

Then a ``kernels`` line, and last ``{"ok": true, "device": {...}}``.
Imports nothing of JAX; needs one CUDA device.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# norm-wise relative error of a bf16 kernel against its float32 plain
# version: bf16 operands carry 8 mantissa bits (2^-9 ~ 2e-3 rounding each),
# and a layer chains ~6 rounded products, LayerNorms and softmaxes
KERNEL_TOL = 2e-2
EXPECTED_PER_BATCH = {"fused_md_layer": 450, "fused_decoder_layer": 9,
                      "fused_ln_qkv": 12, "fused_proj_mlp": 12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def relerr(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def device_ms(fn, reps: int = 20) -> float:
    """Milliseconds of device time per call of ``fn``: the sum of its CUDA
    kernels' time from the profiler (host overhead excluded).  Fails when
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        total_us += t
    if not total_us > 0:
        fail("the profiler recorded no device time")
    return total_us / reps / 1e3


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def randomize_(module, seed: int):
    """Every parameter random (the zero-init projections too), so that each
    segment of a layer contributes: weights ~ N(0, 1/fan_in), LayerNorm
    weights ~ 1 + N(0, 0.1), biases and vectors ~ N(0, 0.05)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if name.endswith("pe"):
                r = torch.rand(p.shape, generator=g)
            elif p.dim() >= 2:
                r = r / math.sqrt(p.shape[-1])
            elif "norm" in name and name.endswith("weight"):
                r = 1.0 + 0.1 * r
            else:
                r = 0.05 * r
            p.copy_(r.to(p.dtype))
    return module


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_build():
    from ladiff_torch.ops import cuda_common as cc
    secs = cc.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    gpu = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not gpu:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    for name, log in cc.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# {name}: {line.strip()}", file=sys.stderr)
    emit({"phase": "build", "seconds": round(secs, 3), "gpu": gpu})
    print(gpu, flush=True)
    return gpu


def mixed_lengths(n: int, lo: int = 16, hi: int = 196, seed: int = 0):
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(lo, hi + 1, (n,), generator=g)


def check_kernel(name, source, replaces, run_kernel, run_plain_f32,
                 run_plain, flops, nb, library=None):
    """Kernel vs its plain version (float32, same bf16 inputs): error,
    times, bound.  Returns the kernel's record."""
    import torch
    got = run_kernel()
    torch.cuda.synchronize()
    want = run_plain_f32()
    got_t = torch.cat([g.float().flatten() for g in got]) \
        if isinstance(got, tuple) else got.float()
    want_t = torch.cat([w.float().flatten() for w in want]) \
        if isinstance(want, tuple) else want.float()
    err = relerr(got_t, want_t)
    max_abs = float((got_t.flatten() - want_t.flatten()).abs().max())
    finite = bool(torch.isfinite(got_t).all())
    ms = device_ms(run_kernel)
    plain_ms = device_ms(run_plain)
    lib_ms = device_ms(library) if library is not None else None
    b_ms, b_by = bound(flops, nb)
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": max_abs,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms}
    emit({"phase": "kernel", "name": name, "rel_err": err,
          "tol": KERNEL_TOL, "max_abs_err": max_abs, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
          "library_ms": lib_ms, "flops": flops, "bytes": nb})
    if not finite or not err <= KERNEL_TOL:
        fail(f"{name}: rel err {err} (tol {KERNEL_TOL}), finite={finite}")
    return rec


def phase_kernels(dev):
    import torch
    from ladiff_torch.models.clip_text import CLIPTextLayer
    from ladiff_torch.ops.clip_layer import (fused_ln_qkv, fused_proj_mlp,
                                             ln_qkv_plain, proj_mlp_plain)
    from ladiff_torch.ops.decoder_layer import (decoder_layer_plain,
                                                fused_decoder_layer)
    from ladiff_torch.ops.md_layer import fused_md_layer, md_layer_plain
    from ladiff_torch.ops.stylization import MDTransformerLayer
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    from ladiff_torch.utils.masks import latent_valid_mask, lengths_to_mask

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, bf)

    def f32(p):
        return {k: v.float() for k, v in p.items()}

    recs = []
    D, H, F, B = 256, 4, 1024, 256
    lengths = mixed_lengths(B)

    # K1: 2B samples (CFG doubling) x 5 latent rows, 2 extra rows each
    T, E, B2 = 5, 2, 2 * B
    layer = randomize_(MDTransformerLayer(D, D, F, H), 11).to(dev, bf)
    p1 = layer.kernel_params()
    lat = latent_valid_mask(lengths, 48, T)
    kvalid = torch.cat([lat, lat]).reshape(B2 * T).float().to(dev)
    x, extra = rnd(B2 * T, D), rnd(B2 * E, D)
    value = rnd(B2, D)
    ca_ss, ffn_ss = rnd(1, 2 * D, scale=0.3), rnd(1, 2 * D, scale=0.3)
    a1 = (x, extra, kvalid, value, ca_ss, ffn_ss)
    # attention: every latent query against its sample's valid latents
    # and the E extra rows (masked keys are not needed work)
    fl1 = 2 * B2 * T * D * (3 * D + 3 * D + 2 * F) \
        + 2 * B2 * E * D * 2 * D \
        + 4 * T * D * (int(kvalid.sum()) + B2 * E) \
        + 2 * B2 * T * 2 * F * D
    recs.append(check_kernel(
        "fused_md_layer", "ladiff_torch/csrc/md_layer.cu",
        "ladiff_tpu/ops/pallas_md_layer.py:198",
        lambda: fused_md_layer(*a1, p1, T=T, E=E, H=H),
        lambda: md_layer_plain(*[t.float() for t in a1], f32(p1), T=T, E=E,
                               H=H),
        lambda: md_layer_plain(*a1, p1, T=T, E=E, H=H),
        fl1, nbytes(*a1, *p1.values(), x)))

    # K2: B samples x 196 frames, <= 5 latent memory rows
    T2, L = 196, 5
    dl = randomize_(TransformerDecoderLayer(D, H, F, "gelu"), 12).to(dev, bf)
    p2 = dl.kernel_params()
    fv = lengths_to_mask(lengths, T2).to(dev)
    mv = latent_valid_mask(lengths, 48, L).to(dev)
    x2 = rnd(B * T2, D)
    mem = rnd(B, L, D)
    a2 = (x2, fv.reshape(-1).float(), mem, mv.float())
    lib = torch.nn.TransformerDecoderLayer(
        D, H, F, dropout=0.0, activation="gelu", batch_first=True,
        norm_first=False).to(dev, bf).eval()
    lib.load_state_dict(dl.state_dict())
    x2b = x2.reshape(B, T2, D)

    def library_k2():
        with torch.no_grad():
            return lib(x2b, mem, tgt_key_padding_mask=~fv,
                       memory_key_padding_mask=~mv)

    # attention: every frame query against its sample's valid frames and
    # valid latent rows (masked keys are not needed work)
    fl2 = 2 * B * T2 * D * (3 * D + 3 * D + 2 * F) + 2 * B * L * D * 2 * D \
        + 4 * T2 * D * (int(fv.sum()) + int(mv.sum()))
    recs.append(check_kernel(
        "fused_decoder_layer", "ladiff_torch/csrc/decoder_layer.cu",
        "ladiff_tpu/ops/pallas_decoder_layer.py:234",
        lambda: fused_decoder_layer(*a2, p2, T=T2, H=H),
        lambda: decoder_layer_plain(*[t.float() for t in a2], f32(p2), T=T2,
                                    H=H),
        lambda: decoder_layer_plain(*a2, p2, T=T2, H=H),
        fl2, nbytes(*a2, *p2.values(), x2), library=library_k2))

    # K3 / K4: 256 captions x 32 tokens, width 768, MLP 3072
    M, W = B * 32, 768
    cl = randomize_(CLIPTextLayer(W, 12), 13).to(dev, bf)
    p3, p4 = cl.qkv_params(), cl.mlp_params()
    x3 = rnd(M, W)
    sc = 1.0 / math.sqrt(W // 12)
    recs.append(check_kernel(
        "fused_ln_qkv", "ladiff_torch/csrc/clip_layer.cu",
        "ladiff_tpu/ops/pallas_clip_layer.py:65",
        lambda: fused_ln_qkv(x3, p3, scale=sc),
        lambda: ln_qkv_plain(x3.float(), f32(p3), scale=sc),
        lambda: ln_qkv_plain(x3, p3, scale=sc),
        6 * M * W * W, nbytes(x3, *p3.values(), x3, x3, x3)))
    att = rnd(M, W)
    Fc = 4 * W
    recs.append(check_kernel(
        "fused_proj_mlp", "ladiff_torch/csrc/clip_layer.cu",
        "ladiff_tpu/ops/pallas_clip_layer.py:113",
        lambda: fused_proj_mlp(att, x3, p4),
        lambda: proj_mlp_plain(att.float(), x3.float(), f32(p4)),
        lambda: proj_mlp_plain(att, x3, p4),
        2 * M * W * W + 4 * M * W * Fc, nbytes(att, x3, *p4.values(), x3)))
    return recs


def phase_slice(dev):
    """Small batch, mixed lengths: card (kernels, bf16) vs CPU (plain
    versions, float32) from the same weights and initial noise."""
    import torch
    from ladiff_torch.models.ladiff import LADiffSystem

    B, steps = 4, 10
    lengths = torch.tensor([16, 60, 123, 196])
    kw = dict(nfeats=263, njoints=22, max_frames=196, latent_dim=(7, 256),
              ff_size=1024, num_layers=9, num_heads=4, text_encoded_dim=768,
              guidance_scale=7.5, num_inference_timesteps=steps)
    cpu = randomize_(LADiffSystem(device="cpu", **kw), 21)
    gpu = LADiffSystem(device=dev, dtype=torch.bfloat16, **kw)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    g = torch.Generator().manual_seed(5)
    cond = torch.randn(B, 1, 768, generator=g)
    uncond = 0.1 * torch.randn(B, 1, 768, generator=g)
    init = torch.randn(B, 5, 256, generator=g)
    t0 = time.perf_counter()
    f_cpu, z_cpu = cpu.generate(cond, uncond, lengths, init_latents=init)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_gpu, z_gpu = gpu.generate(cond, uncond, lengths, init_latents=init)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    err_f = relerr(f_gpu.float().cpu(), f_cpu)
    err_z = relerr(z_gpu.float().cpu(), z_cpu)
    finite = bool(torch.isfinite(f_gpu).all())
    zero_pad = not bool(f_gpu[0, 16:].any())
    # bf16 (8 mantissa bits) against float32 through 10 guided steps of a
    # 9-layer denoiser and a 9-layer decoder: the guidance scale amplifies
    # the eps difference 7.5x at every step
    tol = 1e-1
    emit({"phase": "slice", "batch": B, "steps": steps,
          "lengths": lengths.tolist(), "feats_rel_err": err_f,
          "latents_rel_err": err_z, "tol": tol, "finite": finite,
          "padded_frames_zero": zero_pad, "cpu_s": t_cpu, "gpu_s": t_gpu})
    if not (finite and zero_pad and err_f <= tol and err_z <= tol):
        fail("small-batch slice disagrees with the CPU reference")


def phase_bench(dev):
    import torch
    from ladiff_torch import bench
    from ladiff_torch.ops import cuda_common as cc

    system, tower = bench.build(dev)
    batches = 2
    cc.reset_launch_counts()
    res = bench.measure(system, tower, batches=batches)
    counts = cc.launch_counts()
    per_batch = {k: v / (bench.WARMUP + batches) for k, v in counts.items()}
    emit({"phase": "bench", "batch": bench.BATCH, "frames": bench.FRAMES,
          "steps": bench.STEPS, "batches": batches, "warmup": bench.WARMUP,
          "samples_per_sec": res["samples_per_sec"],
          "seconds_per_batch": res["seconds_per_batch"],
          "launches": counts, "launches_per_batch": per_batch,
          "finite": res["finite"], "shape": res["shape"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not res["finite"]:
        fail("non-finite features at full width")
    if res["shape"] != [bench.BATCH, bench.FRAMES, bench.NFEATS]:
        fail(f"feature shape {res['shape']}")
    for name, want in EXPECTED_PER_BATCH.items():
        if per_batch.get(name) != want:
            fail(f"{name}: {per_batch.get(name)} launches per batch, "
                 f"expected {want}")
    return counts


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "ladiff_torch", "csrc")):
        fail("the ladiff_torch package is not next to chip_smoke.py")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_build()
    with torch.no_grad():
        recs = phase_kernels(dev)
        phase_slice(dev)
        counts = phase_bench(dev)
    for rec in recs:
        rec["launches"] = counts[rec["name"]]
        if rec["launches"] <= 0:
            fail(f"{rec['name']} was not launched on the main path")
    if any(k in sys.modules for k in ("jax", "flax", "ladiff_tpu")):
        fail("JAX was imported")
    emit({"kernels": recs})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
