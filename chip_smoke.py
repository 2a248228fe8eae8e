#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ladiff_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. build    every CUDA kernel of the port from ``ladiff_torch/csrc`` (one
            ``nvcc`` per source, all at once); the card's name and power
            limit as ``nvidia-smi`` reports them; the registers and spills
            of K1's, kernel 11's, kernel 6's and kernel 7's kernels and the
            shared memory of a CTA of their cluster body (K1's layout at
            the published shape); the registers and spills
            of K3's and K4's LayerNorm pass and GEMM block
            (``clip_kernels``) and of kernels 8's and 12's products on it
            (``train_gemm_kernels``).
2. kernels  K1..K4 at the generation path's shapes (mixed lengths), bf16,
            each against its plain PyTorch version on the same inputs
            (computed in float32), with its time, the plain version's time,
            the least time the card could take, and a library call's time
            where one PyTorch call computes the same function; K1's and
            kernel 11's lines carry the launch geometry (row groups,
            cluster size, CTAs).  ``md_layer_scaling``: K1's device ms at
            128 to 1584 samples beside the geometry, and at 512 samples
            against the row group's size; ``md_layer_plain_breakdown``: the
            bf16 plain K1's launches one by one.  K1 is compared again at
            the training stages' shapes: 128 x 5 rows with one AdaLN row
            per sample, and 256 x 5 rows.  ``kernel_breakdown``:
            K2's launches one by one (device ms per call); K2 compared again
            at 3 x 40 rows (a partial last row block), D 256, 64 and 192.
            ``kernel_clip_rows``: K3 and K4 at the 77-token context (256 x
            77 = 19,712 rows, timed) and at 48 rows (compared);
            ``clip_breakdown`` at 8192 and 19,712 rows: each launch of K3's
            and K4's chains (the LayerNorm pass, the GEMMs) with its device
            ms and TFLOP/s (GB/s for the LayerNorm) and launch geometry,
            ``torch.nn.functional.linear`` at each GEMM's shape (cuBLAS's
            time, a yardstick the port never calls), each GEMM's products
            alone (the probe epilogue, which stores nothing) and each GEMM
            at each tile width of the GEMM block.
3. slice    ``LADiffSystem.generate`` at batch 4 with mixed lengths on the
            card (kernels, bf16) against the CPU (plain versions, float32),
            same weights, same initial noise.
4. bench    the ``ladiff_torch.bench`` protocol at full width (batch 256,
            196 frames, 32-token CLIP bucket, CFG DDIM-50 + decode): launch
            counts per batch, samples/s, finite output.
   route_kernels  kernel 11 (the whole MD stack) at 512 x 5 rows with mixed
            lengths and again without a mask (its bits equal over two
            runs); kernel 11 and K1 at 13 samples in row groups of 4 (one
            sample without a valid latent) and at 1 sample; kernels 6
            (stylized FFN) and 7 (one-token stylize), each with its launch
            geometry (row groups, C, CTAs), at 2560 rows with one AdaLN row
            per sample and one shared; kernel 6 again where row groups
            split samples (37 x 7 and 3 x 5 rows) at D 256, 64, 128 and
            192 (``kernel6_shapes``, compared), kernel 7 at the same rows
            and at 40 x 1 with fractional masks (one sample wholly masked)
            and all-zero masks (``kernel7_shapes``, compared), kernel 7's
            device ms against its rows per group (``stylize_scaling``);
            kernel 5 with ReLU at the
            same rows (the MD sa_block's tail on the per-block routes):
            each against its plain version, timed like phase 2.
   route_slice  the other denoiser routes at batch 4, mixed lengths, DDIM-10,
            card against the float32 CPU with their launch counts: the
            whole-stack route (``md_stack=True``), full-context text (9-token
            captions through the CLIP tower's hidden states at 77 tokens),
            and a one-token system at head width 256 (H 1), which neither
            K1 nor K2 takes: the MD layers per block with kernel 7, the
            decoder layers per block with kernel 5's tail.
   route_bench  the bench protocol on the stack and full-context routes
            and on the one-token route at head width 256 (``one_token_h1``,
            ``bench.build(num_heads=1)``: every MD layer and decoder layer
            per block, kernels 7, 6 and 5): launch counts per batch,
            samples/s beside phase 4's.  Phase 4 and each of these routes
            end with one profiled batch of their route
            (``bench.breakdown``: device time by kernel group, idle share).

5. train_kernels  ``train_gemm_products``: each product of kernels 8
            and 12 on the GEMM block alone (q / k / v, the out-projection
            with and without its residual dropout, dctx with delta, dx,
            the split-K weight gradients) against its float32 product at
            every tile width it takes, 618 and 26,368 rows, D 64 to 256,
            and the epilogue's residual mask bit for bit against
            ``train_self_attention_masks``.  Then the inference FFN tail
            and masked attention and the
            training kernels (attention and FFN tail, forward and backward)
            at the training slice's shapes (128 x 206 rows, mixed lengths;
            the masked attention once more without a mask at 64 tokens,
            compared only): each against its plain
            version at dropout 0, and at dropout 0.1 with the plain version
            given the masks the kernel draws; every gradient on its own.
            Kernel 10's samples include one without a valid key and short
            ones with wholly masked key tiles, each group held on its own
            (``kernel10_masking``); kernel 8 is compared again at batch 3
            with such samples (``kernel8_masking``), and at dropout 0 at
            128 x 196 and 3 x 206 rows and at D 64 and 192 (head widths
            16 and 48) at 7 x 48 rows (``kernel8_shapes``).
            Then a ``dropout`` line: keep fraction, same seed same output,
            other seed other output.  Then ``kernels_decoder_stream``: the
            training kernels compared again at the decoder's 128 x 196 rows.
            Then ``kernels_md_sa_block_stream``: the training FFN tail with
            ReLU at the denoiser's 640 and 20 rows and at 1000 (not a
            multiple of the 64-row block), dropout 0 and 0.1, and at 640
            rows timed (its ``kernels`` rows with the stage-2 path);
            ``kernel9_bwd_bits``: its backward's bits equal over two runs.
            ``train_attention_breakdown``: kernel 8's launches one by one
            at 128 x 206 rows, dropout 0.1 (device ms, each product's
            TFLOP/s, cuBLAS's time for the same product shape, the
            products' geometry).
            ``ffn_breakdown``: kernel 9's backward launch by launch at
            128 x 206 and 640 rows, its forward at 640 rows, kernel 5 at
            2560 and 26368 rows (device ms), the launch geometry of each
            (64-row blocks, CTAs a block C, the card's slots), and kernel
            5 at 2560 rows and kernel 9's forward at 640 rows on C = 1, 2
            and 4 CTAs a block (compared and timed).
6. train_slice    ``vae_forward`` loss and every parameter's gradient, name
            by name, at batch 4 with mixed lengths and dropout 0 on the
            card (kernels, bf16 compute, float32 parameters) against the
            CPU (plain, float32), with the plain bf16 CPU run beside it as
            a control; a few ``vae_train_step``s lower the loss; the
            validation pass agrees with the CPU.
7. train_bench    the ``ladiff_torch.train_bench`` protocol at full width
            (batch 128, 196 frames, dropout 0.1): ms per step, samples/s,
            peak memory, launch counts per step, then one validation pass
            and its launch counts.
8. diffusion_slice  ``diffusion_forward`` loss and every denoiser gradient,
            name by name, at batch 4 with mixed lengths and dropout 0, the
            same noise, timesteps, caption-drop mask and encode noise on the
            card and on the CPU (float32), each tensor held to 1.3 times
            the plain bf16 CPU run's error for that tensor; no VAE
            parameter has a gradient; a few
            ``diffusion_train_step``s lower the loss; the validation pass
            agrees with the CPU; then ``vae_diffusion_forward`` the same
            way, loss terms by name and gradients of both trees by name,
            held without the joints losses; with them the denoiser's are
            held and the VAE's printed beside their control.
9. diffusion_bench  the ``train_bench`` stages ``diffusion_train`` and
            ``vae_diffusion_train`` at full width: ms per step, samples/s,
            peak memory, launch counts per step; the stage-2 validation pass
            and its launch counts.

10. whole_layer_kernels  kernels 12 and 13 (the whole-layer training
            kernels) at the stage-1 configuration's shapes, 64 x 206 encoder
            rows and 64 x 196 decoder rows with 5 memory rows (1 to 5
            valid), mixed lengths: each against its float32 plain version,
            at dropout 0 and 0.1 (the kernel's masks given to the plain
            version), every gradient on its own, the memory's too; timed at
            batch 64, compared again at 128 and 3, and kernel 13 at 3 x 40
            rows (a 64-row block holds three samples) with 8 memory rows (1,
            8 and 5 valid); the memory gradient's bits equal over two runs
            (3 x 196 and 3 x 40 rows).  ``whole_layer_breakdown``: kernels
            12's and 13's launches one by one (device ms per call, batch 64,
            dropout 0.1).
11. whole_layer_slice  ``train_slice`` on the whole-layer route, with its
            launch counts (9 + 9 of kernel 12, 9 + 9 of kernel 13, none of
            kernels 8 and 9).
12. gated_slice  VAEs the training kernels refuse (head width 128; d 512 /
            ff 2048): card against CPU, then one training step that
            launches none of the refused kernels.
13. whole_layer_bench  ``train_bench``'s stage 1 on the split and the
            whole-layer routes in turns: ms per step side by side.
14. train_entry  the training entry point at the published stage-1
            configuration: 2 epochs x 3 steps with a checkpoint per epoch,
            a resume, stage 2 booting the VAE from those checkpoints,
            ``ladiff_torch.demo``; launch counts per step, losses, the
            demo's joints.
15. float32_entry  the published configurations unmodified (float32
            compute: every module's plain route): stage 1 through
            ``run_training`` for 2 epochs x 3 steps with no kernel launch,
            its loss on one batch against the CPU's, float32 ms per step
            beside the bf16 route's; stage 2 booting from it for 3 steps.
16. eval_entry  the T2M evaluation protocol (``ladiff_torch.test``
            ``run_test``) at the published stage-2 configuration from a
            saved random checkpoint, with random CLIP and evaluators, on 512
            synthetic clips: (a) float32 as published, card against CPU,
            no kernel launch, metrics compared; (b) bf16, stage
            ``diffusion``, launches per eval batch and per CLIP call
            (``EXPECTED_EVAL_*``), embeddings against (a); (c) bf16, stage
            ``vae``, launches per eval batch.  Seconds per eval batch, per
            replication and per MultiModality pass.

Then a ``kernels`` line, and last ``{"ok": true, "device": {...}}``.
``--only PHASE[,PHASE]`` runs the build and the named phases alone (a short
check of a new kernel) and prints no ``ok`` line.
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
# gradients of a bf16 kernel against the float32 plain backward: a weight
# gradient sums ~26 k rows of products of two bf16-rounded factors (da and
# h, dy and gd, dqkv and x), each rounding random in sign, accumulated in
# float32, so the sum's norm-wise error stays at the single-product level
# (2^-9 ~ 2e-3) times the few chained roundings upstream of it; the same
# 2e-2 holds them
GRAD_TOL = 2e-2
# the same through a ReLU: the kernel decides a > 0 from a product of
# bf16-rounded h, the float32 plain backward from unrounded h, so the few
# pre-activations in a thousand within ~2^-9 of zero flip, and each flip
# changes da by the whole upstream value: a norm-wise error of
# sqrt(flipped share), 3.2e-2 on an H100 at 26368 rows
RELU_GRAD_TOL = 8e-2
# the training slice on the card (kernels, bf16 compute) against the float32
# CPU run, every parameter's gradient on its own.  The yardstick is the
# plain bf16 CPU run of the same weights, which has no kernel in it: on an
# H100 the card's worst gradient read 2.7e-2 beside that run's 3.5e-2
# through the feature and KL losses at unit feature std, and 7.5e-2 beside
# 8.0e-2 through all losses at a feature std of 0.1; each case is held to
# about twice its reading.  The loss read 6e-5 and, after 8 optimizer
# steps, the validation loss 3e-3 and its features 5e-3.
TRAIN_LOSS_TOL, TRAIN_FEATS_TOL = 1e-2, 2e-2
TRAIN_GRAD_TOL = {"unit_std_no_joints": 6e-2, "std_0.1_all_losses": 1.5e-1}
EXPECTED_PER_BATCH = {"fused_md_layer": 450, "fused_decoder_layer": 9,
                      "fused_ln_qkv": 12, "fused_proj_mlp": 12,
                      "fused_postnorm_ffn": 0, "fused_md_stack": 0,
                      "fused_stylized_ffn": 0, "fused_broadcast_stylize": 0}
# the other generation routes per batch: the whole stack once per DDIM step;
# with full-context text every MD layer per block (kernel 5 the sa_block
# tail, the plain linear cross-attention, kernel 6), CLIP at 77 tokens
EXPECTED_STACK_PER_BATCH = {
    "fused_md_stack": 50, "fused_md_layer": 0, "fused_postnorm_ffn": 0,
    "fused_stylized_ffn": 0, "fused_broadcast_stylize": 0,
    "fused_decoder_layer": 9, "fused_ln_qkv": 12, "fused_proj_mlp": 12}
EXPECTED_FULL_CONTEXT_PER_BATCH = {
    "fused_postnorm_ffn": 450, "fused_stylized_ffn": 450,
    "fused_md_layer": 0, "fused_broadcast_stylize": 0, "fused_md_stack": 0,
    "fused_decoder_layer": 9, "fused_ln_qkv": 12, "fused_proj_mlp": 12}
# the one-token system at head width 256 (H 1), which neither K1 nor K2
# takes: every MD layer per block (plain 7-key attention, kernel 5 as the
# ReLU tail, kernel 7, kernel 6), every decoder layer per block (plain
# attention and cross-attention, kernel 5 as the GELU tail)
EXPECTED_ONE_TOKEN_H1_PER_BATCH = {
    "fused_broadcast_stylize": 450, "fused_stylized_ffn": 450,
    "fused_postnorm_ffn": 459, "fused_ln_qkv": 12, "fused_proj_mlp": 12,
    "fused_md_layer": 0, "fused_md_stack": 0, "fused_decoder_layer": 0,
    "fused_masked_attention": 0}
# kernel 5 runs on two paths, and the ``kernels`` line has a row for each
KERNEL5_VAE_PATH = "VAE encoder layer tail, GELU, 128 x 206 rows"
KERNEL5_MD_PATH = "MD sa_block tail, ReLU, 512 x 5 rows"
# kernel 9 likewise: the VAE layers' tails, and the MD sa_block's tail in
# stage 2 (its launches counted on the stage-2 and joint steps)
KERNEL9_MD_PATH = "MD sa_block tail, ReLU, 128 x 5 rows"
EXPECTED_PER_STEP = {"train_self_attention": 18,
                     "train_self_attention_bwd": 18,
                     "train_postnorm_ffn": 18, "train_postnorm_ffn_bwd": 18}
EXPECTED_VALIDATION = {"fused_masked_attention": 9, "fused_postnorm_ffn": 9,
                       "fused_decoder_layer": 9}
# stage 2: the frozen eval-mode encode (kernels 10 and 5, 9 layers), then 9
# MD layers whose sa_block tail is kernel 9 (5 latent rows: plain attention);
# its validation pass runs the MD layers as K1.  Joint stage: stage 1's 18 +
# 18, stage 2's, 10 guided sampling steps of 9 K1 launches, and the eval-mode
# decode with gradients through kernels 8 and 9 at rate 0 (9 + 9)
EXPECTED_PER_DIFFUSION_STEP = {
    "fused_masked_attention": 9, "fused_postnorm_ffn": 9,
    "train_postnorm_ffn": 9, "train_postnorm_ffn_bwd": 9,
    "train_self_attention": 0, "train_self_attention_bwd": 0,
    "fused_md_layer": 0, "fused_decoder_layer": 0}
EXPECTED_DIFFUSION_VALIDATION = {
    "fused_masked_attention": 9, "fused_postnorm_ffn": 9,
    "fused_md_layer": 9, "train_postnorm_ffn": 0}
EXPECTED_PER_JOINT_STEP = {
    "fused_masked_attention": 9, "fused_postnorm_ffn": 9,
    "train_postnorm_ffn": 36, "train_postnorm_ffn_bwd": 36,
    "train_self_attention": 27, "train_self_attention_bwd": 27,
    "fused_md_layer": 90, "fused_decoder_layer": 0}
# stage 2 and the joint stage on the card against the float32 CPU run.  The
# yardstick is again the plain bf16 CPU run of the same weights and draws,
# which has no kernel in it: with randomized unit-gain weights the denoiser's
# gradients in bf16 differ from float32 by 1.5e-1 to 1.7e-1 at worst (median
# 1e-1), the VAE's through the joint stage without the joints losses by
# 1.4e-1 (median 2e-2), the losses by under 1e-3.  So each gradient tensor is
# held on its own to DIFF_GRAD_RATIO times the control's error for that same
# tensor (or DIFF_GRAD_FLOOR where the control's is smaller): a fault in one
# layer stands out against that layer's own yardstick.  With the joints
# losses on (feature std 0.1) the generated motion's joints make the plain
# bf16 run's VAE gradients differ by up to 0.9 and its gen_joints term by
# 2e-2: there the denoiser's gradients, which the joints do not reach, are
# held the same way and the VAE's are printed beside their control.
DIFF_LOSS_TOL = 1e-2
# float32 on the card (plain routes, TF32 off) against float32 on the CPU:
# the same function, sums in another order
FLOAT32_LOSS_TOL = 1e-3
DIFF_GRAD_RATIO, DIFF_GRAD_FLOOR = 1.3, 2e-2
# the evaluation protocol in bf16 (``eval_entry``): stage ``diffusion``
# generates each eval batch as CFG DDIM-50 (the 2B guided rows through the
# 9 MD layers as K1 each step) and decodes it through the 9 decoder layers
# (K2); every CLIP call (once per batch of captions not yet cached) runs
# the 12 CLIP layers as K3 and K4.  Stage ``vae`` encodes the ground truth
# through the 9 encoder layers (kernel 10 the attention, kernel 5 the FFN
# tail) and decodes it (K2).  Every other kernel launches no time there.
EXPECTED_EVAL_PER_BATCH = {"fused_md_layer": 450, "fused_decoder_layer": 9}
EXPECTED_EVAL_PER_CLIP_CALL = {"fused_ln_qkv": 12, "fused_proj_mlp": 12}
EXPECTED_EVAL_VAE_PER_BATCH = {"fused_masked_attention": 9,
                               "fused_postnorm_ffn": 9,
                               "fused_decoder_layer": 9}
# float32 on the card (plain routes, TF32 off) against the float32 CPU run
# of the same checkpoint and noise: each metric within 1e-3 relative, FID
# (a difference of traces of 512 x 512 covariances) within 1e-2; bf16
# (kernels) against that float32 run: the generated motion's embeddings
# within 1e-1 norm-wise (bf16 through 50 guided steps, as the generation
# slices hold ``generate``)
EVAL_METRIC_TOL, EVAL_FID_TOL, EVAL_BF16_TOL = 1e-3, 1e-2, 1e-1
# the whole-layer route's stage-1 step: kernel 12 in each of the 9 encoder
# layers and kernel 13 in each of the 9 decoder layers, forward and backward
EXPECTED_WHOLE_LAYER_PER_STEP = {
    "train_encoder_layer": 9, "train_encoder_layer_bwd": 9,
    "train_decoder_layer": 9, "train_decoder_layer_bwd": 9,
    "train_self_attention": 0, "train_self_attention_bwd": 0,
    "train_postnorm_ffn": 0, "train_postnorm_ffn_bwd": 0}
# the phases in the order they run, each with whether autograd records
PHASES = (("kernels", False), ("slice", False), ("bench", False),
          ("route_kernels", False), ("route_slice", False),
          ("route_bench", False), ("train_kernels", False),
          ("whole_layer_kernels", False), ("train_slice", True),
          ("whole_layer_slice", True), ("gated_slice", True),
          ("train_bench", True), ("whole_layer_bench", True),
          ("diffusion_slice", True), ("diffusion_bench", True),
          ("train_entry", True), ("float32_entry", True),
          ("eval_entry", False))


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
    kernels' time from the profiler (host overhead excluded).  A window can
    come back empty after a long profiled session (seen on an H100 after
    the full-context breakdown's, and at the first cuBLAS timing of
    ``clip_breakdown``), so an empty one is taken again; fails when five
    record no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
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
        if total_us > 0:
            return total_us / reps / 1e3
    fail("the profiler recorded no device time in five windows")


def launch_breakdown(fn, reps: int = 10):
    """Device milliseconds per call of ``fn`` by kernel (the profiler's
    per-name sums over ``reps`` calls, template arguments kept), largest
    first: [{"kernel", "ms", "launches"}]."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::|ladiff::", "",
                          ev.key).split("(")[0]
            rows.append({"kernel": name, "ms": t / reps / 1e3,
                         "launches": ev.count / reps})
    return sorted(rows, key=lambda r: -r["ms"])


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
    from ladiff_torch.ops.md_layer import md_smem_bytes
    secs = cc.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    gpu = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not gpu:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    for name, log in cc.build_logs().items():
        for fn, regs, spill in _ptxas_entries(log):
            print(f"# {name}: {fn}: {regs}; {spill}", file=sys.stderr)
    # the cluster MD body's kernels (K1, 11, 6, 7): registers and spills
    # from ptxas, dynamic shared memory per CTA at the published shape
    md = [{"kernel": fn, "registers": regs, "spills": spill}
          for name, log in cc.build_logs().items()
          if name.startswith("md_") or name in ("stylized_ffn", "stylize")
          for fn, regs, spill in _ptxas_entries(log)]
    # K3's and K4's LayerNorm pass and GEMM block (one entry per tile width
    # and epilogue; 168 registers is the GEMM's launch bound, 65536 / 384,
    # which setmaxnreg moves from the producer to the consumers)
    clip = [{"kernel": fn, "registers": regs, "spills": spill}
            for fn, regs, spill in _ptxas_entries(
                cc.build_logs().get("clip_layer", ""))]
    # kernels 8's and 12's products on the same GEMM block (the delta
    # epilogue's registers among them)
    train_gemm = [{"kernel": fn, "registers": regs, "spills": spill}
                  for name in ("train_attention", "train_layer")
                  for fn, regs, spill in _ptxas_entries(
                      cc.build_logs().get(name, ""))
                  if "gemm_sm90" in fn]
    emit({"phase": "build", "seconds": round(secs, 3), "gpu": gpu,
          "md_kernels": md,
          "md_smem_bytes": md_smem_bytes(256, 1024, 1024),
          "clip_kernels": clip, "train_gemm_kernels": train_gemm})
    print(gpu, flush=True)
    return gpu


def _ptxas_entries(log: str):
    """(kernel, registers, spills) of each entry function in an ``nvcc
    -Xptxas -v`` log, the names demangled where ``c++filt`` is present."""
    import re
    out, fn, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append([fn, line.split(":", 1)[-1].strip(), spill])
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in out), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(out):
            for e, n in zip(out, names):
                e[0] = n
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def mixed_lengths(n: int, lo: int = 16, hi: int = 196, seed: int = 0):
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(lo, hi + 1, (n,), generator=g)


def _named(out):
    """A kernel's result as {name: tensor}."""
    if isinstance(out, dict):
        return out
    if isinstance(out, (tuple, list)):
        return {str(i): t for i, t in enumerate(out)}
    return {"out": out}


def compare(name, got, want, tol):
    """Norm-wise relative error of every output on its own (the largest is
    reported) and the largest absolute error; fails beyond ``tol``."""
    import torch
    got, want = _named(got), _named(want)
    errs, max_abs, finite = {}, 0.0, True
    for key, w in want.items():
        g = got[key].float()
        errs[key] = relerr(g, w.float())
        max_abs = max(max_abs, float((g - w.float()).abs().max()))
        finite = finite and bool(torch.isfinite(g).all())
    worst = max(errs, key=errs.get)
    if not finite or not errs[worst] <= tol:
        fail(f"{name}: rel err {errs[worst]} at {worst} (tol {tol}), "
             f"finite={finite}")
    return errs[worst], max_abs, errs


def check_kernel(name, source, replaces, run_kernel, run_plain_f32,
                 run_plain, flops, nb, library=None, tol=None,
                 run_timed=None, extra=None):
    """Kernel vs its plain version (float32, same bf16 inputs): error,
    times, bound.  ``run_timed`` is what is timed where it differs from
    what is compared.  Returns the kernel's record."""
    import torch
    tol = KERNEL_TOL if tol is None else tol
    got = run_kernel()
    torch.cuda.synchronize()
    err, max_abs, errs = compare(name, got, run_plain_f32(), tol)
    del got
    ms = device_ms(run_timed or run_kernel)
    plain_ms = device_ms(run_plain)
    lib_ms = device_ms(library) if library is not None else None
    b_ms, b_by = bound(flops, nb)
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": max_abs,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms}
    line = {"phase": "kernel", "name": name, "rel_err": err,
            "tol": tol, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "flops": flops, "bytes": nb}
    if len(errs) > 1:
        line["rel_errs"] = errs
    line.update(extra or {})
    emit(line)
    return rec


def phase_kernels(dev):
    import torch
    from ladiff_torch.models.clip_text import CLIPTextLayer
    from ladiff_torch.ops.clip_layer import (fused_ln_qkv, fused_proj_mlp,
                                             ln_qkv_plain, proj_mlp_plain)
    from ladiff_torch.ops.decoder_layer import (decoder_layer_plain,
                                                fused_decoder_layer)
    from ladiff_torch.ops import md_layer
    from ladiff_torch.ops.md_layer import (fused_md_layer, md_launch_geometry,
                                           md_layer_plain)
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
        fl1, nbytes(*a1, *p1.values(), x),
        extra=md_launch_geometry("md_layer", dev, B2, T, E, D, F, F)))

    # K1's device time against the sample count (mixed lengths) beside the
    # launch geometry the wrapper picks, then at 512 samples against the row
    # group's size (the geometry sweep: 6 to 18 samples of 5 rows); then
    # the bf16 plain version's launches one by one, the library's time for
    # each of the layer's products at these shapes
    points = []
    for n in (128, 256, 512, 792, 1584):
        lat_n = latent_valid_mask(mixed_lengths(n, seed=6), 48, T)
        a_n = (rnd(n * T, D), rnd(n * E, D),
               lat_n.reshape(n * T).float().to(dev), rnd(n, D), ca_ss,
               ffn_ss)
        points.append({"samples": n, "rows": n * T,
                       **md_launch_geometry("md_layer", dev, n, T, E, D, F,
                                            F),
                       "ms": device_ms(lambda: fused_md_layer(
                           *a_n, p1, T=T, E=E, H=H))})
        del a_n
    sweep = []
    for spg in (6, 9, 12, 15, 18):
        sweep.append({**md_launch_geometry("md_layer", dev, B2, T, E, D, F,
                                           F, spg),
                      "ms": device_ms(lambda: md_layer._launch(
                          *a1, p1, T=T, E=E, H=H, spg=spg))})
    emit({"phase": "md_layer_scaling", "points": points,
          "group_sweep": sweep})
    emit({"phase": "md_layer_plain_breakdown", "rows": B2 * T,
          "launches": launch_breakdown(
              lambda: md_layer_plain(*a1, p1, T=T, E=E, H=H))})

    # K1 at the training stages' shapes (compared, not timed): the stage-2
    # validation pass, 128 samples with one AdaLN row per sample (every
    # sample has its own timestep), and the joint stage's guided sampling,
    # 2 x 128 samples with a shared row
    errs_k1 = {}
    for case, n, ss_rows in (("128x5 rows, AdaLN row per sample", 128, 128),
                             ("256x5 rows, shared AdaLN row", 256, 1)):
        lat_n = latent_valid_mask(mixed_lengths(n, seed=4), 48, T)
        a_n = (rnd(n * T, D), rnd(n * E, D),
               lat_n.reshape(n * T).float().to(dev), rnd(n, D),
               rnd(ss_rows, 2 * D, scale=0.3), rnd(ss_rows, 2 * D, scale=0.3))
        errs_k1[case] = compare(
            f"fused_md_layer, {case}",
            fused_md_layer(*a_n, p1, T=T, E=E, H=H),
            md_layer_plain(*[t.float() for t in a_n], f32(p1), T=T, E=E,
                           H=H), KERNEL_TOL)[0]
    emit({"phase": "kernel_md_layer_training_shapes", "rel_err": errs_k1,
          "tol": KERNEL_TOL})

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
    # K2's launches one by one
    emit({"phase": "kernel_breakdown", "kernel": "fused_decoder_layer",
          "rows": B * T2, "launches": launch_breakdown(
              lambda: fused_decoder_layer(*a2, p2, T=T2, H=H))})
    # K2 again (compared, not timed): 3 x 40 rows (a partial last row
    # block; a block holds rows of two and three samples), at the widths
    # its tail takes below 256
    errs_k2 = {}
    for Dk, Hk in ((256, 4), (64, 2), (192, 4)):
        dk = randomize_(TransformerDecoderLayer(Dk, Hk, 4 * Dk, "gelu"),
                        14).to(dev, bf)
        lens = torch.tensor([40, 23, 7])
        ak = (rnd(3 * 40, Dk), lengths_to_mask(lens, 40).to(dev).reshape(-1)
              .float(), rnd(3, L, Dk),
              latent_valid_mask(lens, 8, L).to(dev).float())
        pk = dk.kernel_params()
        errs_k2[f"D {Dk} H {Hk}"] = compare(
            f"fused_decoder_layer, 3 x 40 rows, D {Dk} H {Hk}",
            fused_decoder_layer(*ak, pk, T=40, H=Hk),
            decoder_layer_plain(*[t.float() for t in ak], f32(pk), T=40,
                                H=Hk), KERNEL_TOL)[0]
    emit({"phase": "kernel_decoder_layer_small_shapes", "rel_err": errs_k2,
          "tol": KERNEL_TOL})

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
    del att
    _clip_rows(dev, cl, rnd, f32, B, sc)
    return recs


def _clip_rows(dev, cl, rnd, f32, B, sc):
    """K3 and K4 at the 77-token context (B x 77 rows, the full-context
    route), compared and timed, and at 48 rows (a ragged last tile),
    compared; then ``clip_breakdown``: each launch of their chains at the
    bench's 32-token and the 77-token shapes (device ms, TFLOP/s or GB/s,
    launch geometry), ``torch.nn.functional.linear`` at each GEMM's shape
    as cuBLAS's yardstick (timed only: the port never calls it), each
    GEMM's products alone (its probe epilogue) and each GEMM at each tile
    width."""
    import torch
    import torch.nn.functional as F
    from ladiff_torch.ops import clip_layer as ops
    W, Fc = 768, 4 * 768
    p3, p4 = cl.qkv_params(), cl.mlp_params()
    rows = {}
    for M in (B * 77, 48):
        x, att = rnd(M, W), rnd(M, W)
        rec = {"rows": M}
        for name, run, plain, fl in (
                ("fused_ln_qkv", lambda: ops.fused_ln_qkv(x, p3, scale=sc),
                 lambda: ops.ln_qkv_plain(x.float(), f32(p3), scale=sc),
                 6 * M * W * W),
                ("fused_proj_mlp", lambda: ops.fused_proj_mlp(att, x, p4),
                 lambda: ops.proj_mlp_plain(att.float(), x.float(), f32(p4)),
                 2 * M * W * W + 4 * M * W * Fc)):
            err, max_abs, _ = compare(f"{name}, {M} rows", run(), plain(),
                                      KERNEL_TOL)
            rec[name] = {"rel_err": err, "max_abs_err": max_abs}
            if M > 48:
                rec[name]["ms"] = device_ms(run)
                rec[name]["tflops"] = fl / rec[name]["ms"] / 1e9
        rows[M] = rec
        del x, att
    emit({"phase": "kernel_clip_rows", "tol": KERNEL_TOL,
          "cases": list(rows.values())})

    def gemms(M, x, att):
        """Each GEMM launch of K3 and K4 at M rows: name -> (run at tile
        width bn, the products alone (probe epilogue), the cuBLAS call,
        FLOP)."""
        y, h, hid = rnd(M, W), rnd(M, W).float(), rnd(M, Fc)
        qkv = [torch.empty_like(x) for _ in range(3)]
        out = torch.empty_like(x)
        total = torch.zeros(1, dtype=torch.float32, device=dev)
        wqkv = torch.cat([p3["wq"], p3["wk"], p3["wv"]])
        bqkv = torch.cat([p3["bq"], p3["bk"], p3["bv"]])
        launches = {  # name: (A, weights, biases, outputs, epilogue, kw)
            "qkv": (y, [p3["wq"], p3["wk"], p3["wv"]],
                    [p3["bq"], p3["bk"], p3["bv"]], qkv, "bias",
                    {"scale": sc}),
            "wo": (att, [p4["wo"]], [p4["bo"]], [h], "resid_f32",
                   {"resid": x}),
            "fc1": (y, [p4["w1"]], [p4["b1"]], [hid], "gelu", {}),
            "fc2": (hid, [p4["w2"]], [p4["b2"]], [out], "resid_bf16",
                    {"resid": h})}
        cublas = {"qkv": (y, wqkv, bqkv), "wo": (att, p4["wo"], p4["bo"]),
                  "fc1": (y, p4["w1"], p4["b1"]),
                  "fc2": (hid, p4["w2"], p4["b2"])}
        work = {}
        for name, (a, ws, bs, outs, epi, kw) in launches.items():
            work[name] = (
                lambda bn=0, a=a, ws=ws, bs=bs, outs=outs, epi=epi, kw=kw:
                ops._gemm(a, ws, bs, outs, epilogue=epi, bn=bn, **kw),
                lambda a=a, ws=ws, bs=bs: ops._gemm(
                    a, ws, bs, [total] * len(ws), epilogue="probe"),
                lambda c=cublas[name]: F.linear(*c),
                2 * M * a.shape[1] * ws[0].shape[0] * len(ws))
        return work

    epi_name = {str(v): k for k, v in ops.EPILOGUES.items()}
    gemm_of = {"bias": "qkv", "resid_f32": "wo", "gelu": "fc1",
               "resid_bf16": "fc2"}
    for M in (B * 32, B * 77):
        x, att = rnd(M, W), rnd(M, W)
        work = gemms(M, x, att)
        launches = []
        for kname, run in (
                ("fused_ln_qkv", lambda: ops.fused_ln_qkv(x, p3, scale=sc)),
                ("fused_proj_mlp", lambda: ops.fused_proj_mlp(att, x, p4))):
            for r in launch_breakdown(run):
                r["of"] = kname
                if "gemm_sm90_kernel" in r["kernel"]:
                    # gemm_sm90_kernel<BN, epilogue, A MN-major, B ...>
                    epi = r["kernel"].split("<")[1].split(",")[1].strip()
                    name = gemm_of[epi_name[epi]]
                    r["gemm"] = name
                    r["tflops"] = work[name][3] / r["ms"] / 1e9
                elif "ln_rows_kernel" in r["kernel"]:
                    # read x (bf16, or h in f32), write y in bf16
                    nb = M * W * (2 + (4 if "float" in r["kernel"] else 2))
                    r["gb_per_s"] = nb / r["ms"] / 1e6
                launches.append(r)
        lib, alone, sweep = {}, {}, {}
        for name, (run, probe, cublas_call, fl) in work.items():
            geo = run()
            torch.cuda.synchronize()
            ms = device_ms(cublas_call)
            lib[name] = {"ms": ms, "tflops": fl / ms / 1e9,
                         "geometry": {k: geo[k] for k in (
                             "bn", "tiles", "pairs", "ctas", "waves",
                             "persistent")}}
            ms = device_ms(probe)
            alone[name] = {"ms": ms, "tflops": fl / ms / 1e9}
            sweep[name] = {}
            for bn in ops.GEMM_BNS:
                ms = device_ms(lambda: run(bn))
                sweep[name][bn] = {"ms": ms, "tflops": fl / ms / 1e9}
        emit({"phase": "clip_breakdown", "rows": M, "launches": launches,
              "cublas_linear": lib, "products_alone": alone,
              "tile_width_sweep": sweep})
        del x, att, work


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
    emit({"phase": "route_breakdown", "route": "default",
          **bench.breakdown(system, tower, res["seconds_per_batch"])})
    return counts, res["samples_per_sec"]


def phase_route_kernels(dev):
    """Kernels 11, 6, 7 and 5 at the shapes of the routes that run them."""
    import torch
    from ladiff_torch.ops import md_layer, stylize
    from ladiff_torch.ops.md_layer import (_PARAM_ORDER as _MD_PARAM_NAMES,
                                           md_launch_geometry, md_layer_plain)
    from ladiff_torch.ops.md_stack import fused_md_stack, md_stack_plain
    from ladiff_torch.ops.postnorm_ffn import (FFN_PARAM_ORDER,
                                               ffn_launch_geometry,
                                               fused_postnorm_ffn,
                                               postnorm_ffn_plain)
    from ladiff_torch.ops.stylization import (MDSkipTransformerEncoder,
                                              MDTransformerLayer)
    from ladiff_torch.ops.stylize import (broadcast_stylize_launch_geometry,
                                          broadcast_stylize_plain,
                                          fused_broadcast_stylize)
    from ladiff_torch.ops.stylized_ffn import (fused_stylized_ffn,
                                               stylized_ffn_launch_geometry,
                                               stylized_ffn_plain)
    from ladiff_torch.utils.masks import latent_valid_mask

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, bf)

    def f32(p):
        return {k: v.float() for k, v in p.items()}

    recs = []
    D, H, F, B, T, E, L = 256, 4, 1024, 256, 5, 2, 9
    B2, M = 2 * B, 2 * B * T
    lat = latent_valid_mask(mixed_lengths(B), 48, T)
    kvalid = torch.cat([lat, lat]).reshape(M).float().to(dev)

    # kernel 11: the sampling step's whole stack, 2B samples (CFG doubling)
    enc = randomize_(MDSkipTransformerEncoder(D, D, H, L, F), 41).to(dev, bf)
    st = enc.stacked_params(bf)
    x, extra = rnd(M, D), rnd(B2 * E, D)
    values = rnd(L, B2, D)
    ca_ss, ffn_ss = rnd(L, 2 * D, scale=0.3), rnd(L, 2 * D, scale=0.3)
    a11 = (x, extra, kvalid, values, ca_ss, ffn_ss)
    kw = dict(T=T, E=E, H=H)
    # per layer K1's count; the skip Linears [rows, 2D] x [2D, D]
    fl_layer = 2 * B2 * T * D * (3 * D + 3 * D + 2 * F) \
        + 2 * B2 * E * D * 2 * D + 4 * T * D * (int(kvalid.sum()) + B2 * E) \
        + 2 * B2 * T * 2 * F * D
    fl11 = L * fl_layer + (L - 1) // 2 * 2 * M * 2 * D * D
    recs.append(check_kernel(
        "fused_md_stack", "ladiff_torch/csrc/md_stack.cu",
        "ladiff_tpu/ops/pallas_md_stack.py:217",
        lambda: fused_md_stack(*a11, st, **kw),
        lambda: md_stack_plain(*[t.float() for t in a11], f32(st), **kw),
        lambda: md_stack_plain(*a11, st, **kw),
        fl11, nbytes(*a11, *st.values(), x),
        extra={**md_launch_geometry("md_stack", dev, B2, T, E, D, F, F),
               "layers": L}))
    ones = torch.ones(M, device=dev)
    err_nomask = compare(
        "fused_md_stack without a mask",
        fused_md_stack(x, extra, ones, values, ca_ss, ffn_ss, st, **kw),
        md_stack_plain(x.float(), extra.float(), ones, values.float(),
                       ca_ss.float(), ffn_ss.float(), f32(st), **kw),
        KERNEL_TOL)[0]
    # the cluster body sums the FFN partials in a fixed order: the same
    # inputs give the same bits
    bits_equal = torch.equal(fused_md_stack(*a11, st, **kw),
                             fused_md_stack(*a11, st, **kw))
    emit({"phase": "kernel_md_stack_no_mask", "rel_err": err_nomask,
          "tol": KERNEL_TOL, "bits_equal_over_two_runs": bits_equal})
    if not bits_equal:
        fail("fused_md_stack: two runs on the same inputs differ")
    # kernel 11 and K1 where row groups are partial: 13 samples (one
    # without a valid latent) in groups of 4 (the last holds one sample),
    # and one sample
    errs_p = {}
    for n, spg in ((13, 4), (1, 0)):
        lat_n = latent_valid_mask(mixed_lengths(n, seed=8), 48, T)
        lat_n[0] = False
        an = (rnd(n * T, D), rnd(n * E, D),
              lat_n.reshape(n * T).float().to(dev), rnd(L, n, D),
              ca_ss, ffn_ss)
        errs_p[f"fused_md_stack, {n} samples"] = compare(
            f"fused_md_stack, {n} samples", fused_md_stack(*an, st, **kw),
            md_stack_plain(*[t.float() for t in an], f32(st), **kw),
            KERNEL_TOL)[0]
        p1 = {k: v[0] for k, v in st.items() if k in _MD_PARAM_NAMES}
        a1 = (*an[:3], an[3][0], ca_ss[:1], ffn_ss[:1])
        errs_p[f"fused_md_layer, {n} samples"] = compare(
            f"fused_md_layer, {n} samples",
            md_layer._launch(*a1, p1, T=T, E=E, H=H, spg=spg),
            md_layer_plain(*[t.float() for t in a1], f32(p1), T=T, E=E,
                           H=H), KERNEL_TOL)[0]
    emit({"phase": "kernel_md_partial_row_groups", "rel_err": errs_p,
          "tol": KERNEL_TOL})
    del enc, st

    # kernels 6 and 7 at the per-block route's rows: 2B samples x 5 rows,
    # the AdaLN rows the modules pass (one per sample) timed, a shared row
    # compared too
    layer = randomize_(MDTransformerLayer(D, D, F, H), 42).to(dev, bf)
    f, cp = layer.ffn, layer.ca_block.proj_out
    w6 = [t.detach() for t in (f.linear1.weight, f.linear1.bias,
                               f.linear2.weight, f.linear2.bias,
                               f.proj_out.norm.weight, f.proj_out.norm.bias,
                               f.proj_out.out_layers[2].weight,
                               f.proj_out.out_layers[2].bias)]
    w7 = [t.detach() for t in (cp.norm.weight, cp.norm.bias,
                               cp.out_layers[2].weight,
                               cp.out_layers[2].bias)]
    x6 = rnd(M, D)
    value = rnd(B2, D)
    errs = {}
    for rows in (B2, 1):
        ss = rnd(rows, 2 * D, scale=0.3)
        name6 = "fused_stylized_ffn"
        name7 = "fused_broadcast_stylize"
        if rows == 1:
            errs[name6] = compare(
                f"{name6}, shared AdaLN row",
                fused_stylized_ffn(x6, ss, *w6, T=T),
                stylized_ffn_plain(x6.float(), ss.float(),
                                   *[t.float() for t in w6], T=T),
                KERNEL_TOL)[0]
            errs[name7] = compare(
                f"{name7}, shared AdaLN row",
                fused_broadcast_stylize(x6, value, kvalid, ss, *w7, T=T),
                broadcast_stylize_plain(x6.float(), value.float(), kvalid,
                                        ss.float(),
                                        *[t.float() for t in w7], T=T),
                KERNEL_TOL)[0]
            continue
        recs.append(check_kernel(
            name6, "ladiff_torch/csrc/stylized_ffn.cu",
            "ladiff_tpu/ops/pallas_fused_ffn.py:68",
            lambda: fused_stylized_ffn(x6, ss, *w6, T=T),
            lambda: stylized_ffn_plain(x6.float(), ss.float(),
                                       *[t.float() for t in w6], T=T),
            lambda: stylized_ffn_plain(x6, ss, *w6, T=T),
            2 * M * D * F * 2 + 2 * M * D * D, nbytes(x6, ss, *w6, x6),
            extra={"geometry": stylized_ffn_launch_geometry(dev, M, D, F)}))
        recs.append(check_kernel(
            name7, "ladiff_torch/csrc/stylize.cu",
            "ladiff_tpu/ops/pallas_stylize.py:43",
            lambda: fused_broadcast_stylize(x6, value, kvalid, ss, *w7, T=T),
            lambda: broadcast_stylize_plain(
                x6.float(), value.float(), kvalid, ss.float(),
                *[t.float() for t in w7], T=T),
            lambda: broadcast_stylize_plain(x6, value, kvalid, ss, *w7, T=T),
            2 * M * D * D, nbytes(x6, value, kvalid, ss, *w7, x6),
            extra={"geometry": broadcast_stylize_launch_geometry(dev, M,
                                                                 D)}))
    emit({"phase": "kernels_shared_adaln_row", "rel_err": errs,
          "tol": KERNEL_TOL})
    # kernel 7's device ms at 2560 rows against the rows of a group (the
    # geometry's choice beside it): fixed costs a launch against costs a row
    ss7 = rnd(B2, 2 * D, scale=0.3)
    scaling7 = {rows: device_ms(lambda: stylize._launch(
        x6, value, kvalid, ss7, *w7, T=T, rows=rows))
        for rows in (16, 32, 48, 64, 96)}
    emit({"phase": "stylize_scaling", "rows": M,
          "geometry": broadcast_stylize_launch_geometry(dev, M, D),
          "ms_by_rows_per_group": scaling7})
    # kernel 6 where its row groups split samples and the last group is
    # partial (37 x 7 and 3 x 5 rows), at D 256 and at D 64, 128 and 192
    # (clusters of 1 to 3 CTAs, F = 4 D), an AdaLN row per sample and a
    # shared one; compared, not timed
    cases6 = {}
    for D6 in (256, 64, 128, 192):
        F6 = F if D6 == 256 else 4 * D6
        wk = w6 if D6 == 256 else [
            rnd(F6, D6, scale=D6 ** -0.5), rnd(F6, scale=0.05),
            rnd(D6, F6, scale=F6 ** -0.5), rnd(D6, scale=0.05),
            1 + rnd(D6, scale=0.1), rnd(D6, scale=0.05),
            rnd(D6, D6, scale=D6 ** -0.5), rnd(D6, scale=0.05)]
        for n, T6 in ((37, 7), (3, 5)):
            xk = rnd(n * T6, D6)
            for rows in (n, 1):
                ssk = rnd(rows, 2 * D6, scale=0.3)
                key = (f"D {D6}, {n} x {T6} rows, "
                       + ("shared AdaLN row" if rows == 1 else
                          "AdaLN row per sample"))
                cases6[key] = {
                    "rel_err": compare(
                        f"fused_stylized_ffn, {key}",
                        fused_stylized_ffn(xk, ssk, *wk, T=T6),
                        stylized_ffn_plain(xk.float(), ssk.float(),
                                           *[t.float() for t in wk], T=T6),
                        KERNEL_TOL)[0],
                    "geometry": stylized_ffn_launch_geometry(
                        dev, n * T6, D6, F6)}
    emit({"phase": "kernel6_shapes", "tol": KERNEL_TOL, "cases": cases6})
    # kernel 7 the same way, and at 40 samples of one row; masks with
    # fractional values and the first sample wholly masked, and all-zero
    # masks (each row's LayerNorm is then its bias)
    cases7 = {}
    for D7 in (256, 64, 128, 192):
        wk = w7 if D7 == 256 else [
            1 + rnd(D7, scale=0.1), rnd(D7, scale=0.05),
            rnd(D7, D7, scale=D7 ** -0.5), rnd(D7, scale=0.05)]
        for n, T7 in ((37, 7), (3, 5), (40, 1)):
            xk, vk = rnd(n * T7, D7), rnd(n, D7)
            frac = torch.rand(n * T7, generator=g)
            frac[:T7] = 0.0
            for mname, mk in (("fractional mask", frac),
                              ("zero mask", torch.zeros(n * T7))):
                mk = mk.to(dev)
                for rows in (n, 1):
                    ssk = rnd(rows, 2 * D7, scale=0.3)
                    key = (f"D {D7}, {n} x {T7} rows, {mname}, "
                           + ("shared AdaLN row" if rows == 1 else
                              "AdaLN row per sample"))
                    cases7[key] = {
                        "rel_err": compare(
                            f"fused_broadcast_stylize, {key}",
                            fused_broadcast_stylize(xk, vk, mk, ssk, *wk,
                                                    T=T7),
                            broadcast_stylize_plain(
                                xk.float(), vk.float(), mk, ssk.float(),
                                *[t.float() for t in wk], T=T7),
                            KERNEL_TOL)[0],
                        "geometry": broadcast_stylize_launch_geometry(
                            dev, n * T7, D7)}
    emit({"phase": "kernel7_shapes", "tol": KERNEL_TOL, "cases": cases7})

    # kernel 5 as the per-block route runs it: the sa_block's tail, ReLU,
    # ff 1024, at the same 2560 rows
    sa = layer.sa_block
    pf = {"ln1_w": sa.norm1.weight, "ln1_b": sa.norm1.bias,
          "w1": sa.linear1.weight, "b1": sa.linear1.bias,
          "w2": sa.linear2.weight, "b2": sa.linear2.bias,
          "ln2_w": sa.norm2.weight, "ln2_b": sa.norm2.bias}
    pf = {k: pf[k].detach() for k in FFN_PARAM_ORDER}
    F5 = sa.linear1.out_features
    x5 = rnd(M, D)
    rec = check_kernel(
        "fused_postnorm_ffn", "ladiff_torch/csrc/postnorm_ffn.cu",
        "ladiff_tpu/ops/pallas_postnorm_ffn.py:64",
        lambda: fused_postnorm_ffn(x5, pf, activation="relu"),
        lambda: postnorm_ffn_plain(x5.float(), f32(pf), activation="relu"),
        lambda: postnorm_ffn_plain(x5, pf, activation="relu"),
        4 * M * D * F5, nbytes(x5, *pf.values(), x5),
        extra={"path": KERNEL5_MD_PATH, "geometry": ffn_launch_geometry(
            "postnorm_ffn", dev, M, D, F5)})
    rec["path"] = KERNEL5_MD_PATH
    recs.append(rec)
    return recs


def phase_route_slice(dev):
    """The other denoiser routes at batch 4: card (kernels, bf16) against
    the CPU (plain versions, float32) from the same weights, text and
    initial noise, with each route's launch counts."""
    import torch
    from ladiff_torch.models.clip_text import CLIPTextTower
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.ops import cuda_common as cc

    B, steps = 4, 10
    lengths = torch.tensor([16, 60, 123, 196])
    g = torch.Generator().manual_seed(7)
    pooled = torch.randn(B, 1, 768, generator=g)
    uncond = 0.1 * torch.randn(B, 1, 768, generator=g)
    init = torch.randn(B, 5, 256, generator=g)
    # 9-token captions (SOT, 7 ids, EOT) at the 77-token context
    ids = torch.zeros(B, 77, dtype=torch.long)
    ids[:, 0], ids[:, 8] = 49406, 49407
    ids[:, 1:8] = torch.randint(1, 49405, (B, 7), generator=g)
    tower = randomize_(CLIPTextTower(), 23).eval()
    hidden = tower(ids, return_hidden=True)
    hidden_card = tower.to(dev, torch.bfloat16)(ids.to(dev),
                                                return_hidden=True)
    tower_err = relerr(hidden_card.float().cpu(), hidden)
    del tower
    tol = 1e-1  # phase_slice's: bf16 through 10 guided steps
    per_step = 9 * steps
    cases = {
        "md_stack": (dict(md_stack=True), pooled, uncond,
                     {"fused_md_stack": steps, "fused_md_layer": 0,
                      "fused_stylized_ffn": 0, "fused_broadcast_stylize": 0,
                      "fused_postnorm_ffn": 0}),
        "full_context": (dict(), hidden, torch.zeros(B, 77, 768),
                         {"fused_postnorm_ffn": per_step,
                          "fused_stylized_ffn": per_step,
                          "fused_md_layer": 0, "fused_broadcast_stylize": 0,
                          "fused_md_stack": 0}),
        # neither K1 nor K2 takes head width 256: the MD layers and the
        # 9 decoder layers run per block, each decoder layer's tail kernel 5
        "one_token_head_width_256": (
            dict(num_heads=1), pooled, uncond,
            {"fused_broadcast_stylize": per_step,
             "fused_stylized_ffn": per_step,
             "fused_postnorm_ffn": per_step + 9, "fused_md_layer": 0,
             "fused_md_stack": 0, "fused_decoder_layer": 0,
             "fused_masked_attention": 0})}
    out, counts_all = {}, {}
    for case, (extra_kw, cond, unc, expected) in cases.items():
        kw = dict(nfeats=263, njoints=22, max_frames=196,
                  latent_dim=(7, 256), ff_size=1024, num_layers=9,
                  num_heads=4, text_encoded_dim=768, guidance_scale=7.5,
                  num_inference_timesteps=steps)
        kw.update(extra_kw)
        cpu = randomize_(LADiffSystem(device="cpu", **kw), 21)
        gpu = LADiffSystem(device=dev, dtype=torch.bfloat16, **kw)
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        f_cpu, z_cpu = cpu.generate(cond, unc, lengths, init_latents=init)
        cc.reset_launch_counts()
        f_gpu, z_gpu = gpu.generate(cond, unc, lengths, init_latents=init)
        torch.cuda.synchronize()
        counts = cc.launch_counts()
        rec = {"latents_rel_err": relerr(z_gpu.float().cpu(), z_cpu),
               "feats_rel_err": relerr(f_gpu.float().cpu(), f_cpu),
               "padded_frames_zero": not bool(f_gpu[0, 16:].any()),
               "launches": {k: v for k, v in counts.items() if v}}
        ok = (rec["latents_rel_err"] <= tol and rec["feats_rel_err"] <= tol
              and rec["padded_frames_zero"]
              and bool(torch.isfinite(z_gpu).all())
              and bool(torch.isfinite(f_gpu).all()))
        out[case] = rec
        if not ok:
            fail(f"route slice {case} disagrees with the CPU: {rec}")
        for name, want in expected.items():
            if counts.get(name) != want:
                fail(f"route slice {case}: {name}: {counts.get(name)} "
                     f"launches, expected {want}")
        counts_all[case] = counts
        del cpu, gpu
    emit({"phase": "route_slice", "batch": B, "steps": steps,
          "lengths": lengths.tolist(), "tol": tol,
          "clip_hidden_rel_err": tower_err, "cases": out})
    if not tower_err <= tol:
        fail(f"CLIP hidden states on the card: rel err {tower_err}")
    return counts_all


def phase_route_bench(dev, default_sps=None):
    """The bench protocol on the stack, the full-context and the one-token
    head-width-256 routes (beside the default route's samples/s where
    ``phase_bench`` ran).  Returns each route's launch counts, in all and
    per batch."""
    import torch
    from ladiff_torch import bench
    from ladiff_torch.ops import cuda_common as cc

    batches = 2
    sps = {"default": default_sps}
    counts_all, per_batch_all = {}, {}
    for route, build_kw, full, expected in (
            ("md_stack", dict(md_stack=True), False,
             EXPECTED_STACK_PER_BATCH),
            ("full_context", {}, True, EXPECTED_FULL_CONTEXT_PER_BATCH),
            ("one_token_h1", dict(num_heads=1), False,
             EXPECTED_ONE_TOKEN_H1_PER_BATCH)):
        # each route's own peak memory, not the process's so far
        torch.cuda.reset_peak_memory_stats()
        system, tower = bench.build(dev, **build_kw)
        cc.reset_launch_counts()
        res = bench.measure(system, tower, batches=batches,
                            full_context=full)
        counts = cc.launch_counts()
        per_batch = {k: v / (bench.WARMUP + batches)
                     for k, v in counts.items()}
        sps[route] = res["samples_per_sec"]
        emit({"phase": "route_bench", "route": route, "batch": bench.BATCH,
              "steps": bench.STEPS, "batches": batches,
              "samples_per_sec": res["samples_per_sec"],
              "seconds_per_batch": res["seconds_per_batch"],
              "launches_per_batch": per_batch, "finite": res["finite"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if not res["finite"] or res["shape"] != [bench.BATCH, bench.FRAMES,
                                                 bench.NFEATS]:
            fail(f"{route}: non-finite features or shape {res['shape']}")
        for name, want in expected.items():
            if per_batch.get(name) != want:
                fail(f"{route}: {name}: {per_batch.get(name)} launches per "
                     f"batch, expected {want}")
        counts_all[route], per_batch_all[route] = counts, per_batch
        emit({"phase": "route_breakdown", "route": route,
              **bench.breakdown(system, tower, res["seconds_per_batch"],
                                full)})
        del system, tower
    emit({"phase": "routes_samples_per_sec", "batch": bench.BATCH,
          "steps": bench.STEPS, "samples_per_sec": sps})
    return {"counts": counts_all, "per_batch": per_batch_all}


def phase_train_kernels(dev):
    """Kernels 5 and 10 and the training kernels at the VAE encoder's
    shapes."""
    import torch
    from ladiff_torch.ops.attention_kernel import (fused_masked_attention,
                                                   masked_attention_plain)
    from ladiff_torch.ops.postnorm_ffn import (FFN_PARAM_ORDER,
                                               ffn_launch_geometry,
                                               fused_postnorm_ffn,
                                               postnorm_ffn_plain)
    from ladiff_torch.ops.train_attention import (
        train_self_attention_bwd, train_self_attention_bwd_plain,
        train_self_attention_fwd, train_self_attention_masks,
        train_self_attention_plain)
    from ladiff_torch.ops.train_ffn import (
        train_postnorm_ffn_bwd, train_postnorm_ffn_bwd_plain,
        train_postnorm_ffn_fwd, train_postnorm_ffn_masks,
        train_postnorm_ffn_plain)
    from ladiff_torch.ops.transformer import TransformerEncoderLayer
    from ladiff_torch.utils.masks import latent_valid_mask, lengths_to_mask

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(2)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, bf)

    def f32(p):
        return {k: v.float() for k, v in p.items()}

    def up(*ts):
        return [t.float() for t in ts]

    def flat(dx, grads):
        return {"dx": dx, **grads}

    B, S, D, H, F, RATE, SEED = 128, 206, 256, 4, 1024, 0.1, 0x5EED5EED5EED
    M = B * S
    layer = randomize_(TransformerEncoderLayer(D, H, F, "gelu"), 31).to(
        dev, bf)
    pf = {"ln1_w": layer.norm1.weight, "ln1_b": layer.norm1.bias,
          "w1": layer.linear1.weight, "b1": layer.linear1.bias,
          "w2": layer.linear2.weight, "b2": layer.linear2.bias,
          "ln2_w": layer.norm2.weight, "ln2_b": layer.norm2.bias}
    pf = {k: pf[k].detach() for k in FFN_PARAM_ORDER}
    pa = {k: v.detach() for k, v in layer.self_attn.kernel_params().items()}
    x, dout = rnd(M, D), rnd(M, D, scale=0.1)
    # encoder stream: 10 distribution tokens (two halves of 5, the first
    # ceil(len / 48) of each valid) and 196 frames
    lengths = mixed_lengths(B, seed=3)
    lat = latent_valid_mask(lengths, 48, 5)
    valid = torch.cat([lat, lat, lengths_to_mask(lengths, S - 10)], dim=1)
    kvalid = valid.reshape(M).float().to(dev).contiguous()
    nvalid = int(valid.sum())  # sum over samples of their valid keys
    recs = []
    _train_gemm_products(dev)

    # kernel 5
    gb = 4 * M * D * F
    p_bytes = nbytes(*pf.values())
    rec = check_kernel(
        "fused_postnorm_ffn", "ladiff_torch/csrc/postnorm_ffn.cu",
        "ladiff_tpu/ops/pallas_postnorm_ffn.py:64",
        lambda: fused_postnorm_ffn(x, pf, activation="gelu"),
        lambda: postnorm_ffn_plain(x.float(), f32(pf), activation="gelu"),
        lambda: postnorm_ffn_plain(x, pf, activation="gelu"),
        gb, nbytes(x, x) + p_bytes,
        extra={"path": KERNEL5_VAE_PATH, "geometry": ffn_launch_geometry(
            "postnorm_ffn", dev, M, D, F)})
    rec["path"] = KERNEL5_VAE_PATH
    recs.append(rec)

    # kernel 10: projected q, k, v of the encoder stream, whose short
    # samples have wholly masked 64-key tiles, and sample 0 with no valid
    # key (it attends uniformly to all S keys); every query against its
    # sample's valid keys, or all S of sample 0 (masked keys are not
    # needed work)
    q10, k10, v10 = (rnd(B, S, D) for _ in range(3))
    valid10 = valid.clone()
    valid10[0] = False
    valid10 = valid10.to(dev)
    nvalid10 = nvalid - int(valid[0].sum()) + S
    heads = lambda a: a.reshape(B, S, H, D // H).transpose(1, 2)
    sdpa_mask = valid10[:, None, None, :]
    tiles = valid10.reshape(B, -1).float()
    tiles = torch.nn.functional.pad(tiles, (0, -S % 64)).reshape(B, -1, 64)
    masked_tiles = int((tiles.sum(-1) == 0)[1:].sum())
    recs.append(check_kernel(
        "fused_masked_attention", "ladiff_torch/csrc/masked_attention.cu",
        "ladiff_tpu/ops/pallas_attention.py:52",
        lambda: fused_masked_attention(q10, k10, v10, valid10, num_heads=H),
        lambda: masked_attention_plain(q10.float(), k10.float(), v10.float(),
                                       valid10, num_heads=H),
        lambda: masked_attention_plain(q10, k10, v10, valid10, num_heads=H),
        4 * D * S * nvalid10, nbytes(q10, k10, v10, valid10, q10),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            heads(q10), heads(k10), heads(v10), attn_mask=sdpa_mask),
        extra={"wholly_masked_key_tiles": masked_tiles,
               "samples_without_a_valid_key": 1}))
    # the sample without a valid key, and the samples with masked tiles,
    # each held on its own
    got10 = fused_masked_attention(q10, k10, v10, valid10, num_heads=H)
    want10 = masked_attention_plain(q10.float(), k10.float(), v10.float(),
                                    valid10, num_heads=H)
    short = (tiles.sum(-1) == 0).any(-1)
    short[0] = False
    emit({"phase": "kernel10_masking", "tol": KERNEL_TOL,
          "no_valid_key_rel_err": compare(
              "fused_masked_attention, no valid key", got10[:1],
              want10[:1], KERNEL_TOL)[0],
          "masked_tile_samples": int(short.sum()),
          "masked_tile_samples_rel_err": compare(
              "fused_masked_attention, wholly masked key tiles",
              got10[short], want10[short], KERNEL_TOL)[0]})
    del got10, want10
    compare("fused_masked_attention without a mask, 64 tokens",
            fused_masked_attention(q10[:, :64].contiguous(),
                                   k10[:, :64].contiguous(),
                                   v10[:, :64].contiguous(), None,
                                   num_heads=H),
            masked_attention_plain(q10[:, :64].float(), k10[:, :64].float(),
                                   v10[:, :64].float(), None, num_heads=H),
            KERNEL_TOL)
    del q10, k10, v10

    # kernel 9: dropout 0 first (compared only), then dropout 0.1 against
    # the plain version with the kernel's masks (compared and timed)
    compare("train_postnorm_ffn rate 0",
            train_postnorm_ffn_fwd(x, pf), train_postnorm_ffn_plain(
                x.float(), f32(pf)), KERNEL_TOL)
    compare("train_postnorm_ffn_bwd rate 0",
            flat(*train_postnorm_ffn_bwd(x, dout, pf)),
            flat(*train_postnorm_ffn_bwd_plain(*up(x, dout), f32(pf))),
            GRAD_TOL)
    masks = train_postnorm_ffn_masks(M, D, F, RATE, SEED, dev)
    mb = tuple(m.to(bf) for m in masks)
    kw = dict(rate=RATE, seed=SEED)
    recs.append(check_kernel(
        "train_postnorm_ffn", "ladiff_torch/csrc/train_ffn.cu",
        "ladiff_tpu/ops/pallas_train_ffn.py:209",
        lambda: train_postnorm_ffn_fwd(x, pf, **kw),
        lambda: train_postnorm_ffn_plain(x.float(), f32(pf), masks),
        lambda: train_postnorm_ffn_plain(x, pf, mb),
        gb, nbytes(x, x) + p_bytes,
        extra={"rate": RATE, "geometry": ffn_launch_geometry(
            "train_ffn", dev, M, D, F)}))
    # the gradient needs dy W2, da W1 and the two weight gradients; the
    # forward's recompute is not needed work
    recs.append(check_kernel(
        "train_postnorm_ffn_bwd", "ladiff_torch/csrc/train_ffn.cu",
        "ladiff_tpu/ops/pallas_train_ffn.py:209",
        lambda: flat(*train_postnorm_ffn_bwd(x, dout, pf, **kw)),
        lambda: flat(*train_postnorm_ffn_bwd_plain(*up(x, dout), f32(pf),
                                                   masks)),
        lambda: train_postnorm_ffn_bwd_plain(x, dout, pf, mb),
        8 * M * D * F, nbytes(x, dout, x) + p_bytes + 2 * p_bytes,
        tol=GRAD_TOL, extra={"rate": RATE}))
    del masks, mb

    # kernel 8
    def attn_fwd(**kw):
        return train_self_attention_fwd(x, kvalid, pa, H=H, S=S, **kw)

    out0, saved0 = attn_fwd(return_saved=True)
    compare("train_self_attention rate 0", out0, train_self_attention_plain(
        x.float(), kvalid, f32(pa), H=H, S=S), KERNEL_TOL)
    compare("train_self_attention_bwd rate 0",
            flat(*train_self_attention_bwd(x, kvalid, dout, pa, saved0, H=H,
                                           S=S)),
            flat(*train_self_attention_bwd_plain(
                x.float(), kvalid, dout.float(), f32(pa), H=H, S=S)),
            GRAD_TOL)
    del out0, saved0
    masks = train_self_attention_masks(B, S, D, H, RATE, SEED, dev)
    mb = tuple(m.to(bf) for m in masks)
    pa_bytes = nbytes(*pa.values())
    # projections, and every query against its sample's valid keys
    fl_f = 2 * M * D * 3 * D + 2 * M * D * D + 4 * D * S * nvalid
    recs.append(check_kernel(
        "train_self_attention", "ladiff_torch/csrc/train_attention.cu",
        "ladiff_tpu/ops/pallas_train_attention.py:388",
        lambda: attn_fwd(**kw),
        lambda: train_self_attention_plain(x.float(), kvalid, f32(pa), masks,
                                           H=H, S=S),
        lambda: train_self_attention_plain(x, kvalid, pa, mb, H=H, S=S),
        fl_f, nbytes(x, kvalid, x) + pa_bytes, extra={"rate": RATE}))
    _, saved = attn_fwd(return_saved=True, **kw)
    # dctx, dx and the two weight gradients, and da, dv, dq, dk over the
    # valid keys; recomputing the scores is not needed work
    fl_b = 2 * (2 * M * D * D + 2 * M * D * 3 * D) + 8 * D * S * nvalid
    recs.append(check_kernel(
        "train_self_attention_bwd", "ladiff_torch/csrc/train_attention.cu",
        "ladiff_tpu/ops/pallas_train_attention.py:388",
        lambda: flat(*train_self_attention_bwd(x, kvalid, dout, pa, saved,
                                               H=H, S=S, **kw)),
        lambda: flat(*train_self_attention_bwd_plain(
            x.float(), kvalid, dout.float(), f32(pa), masks, H=H, S=S)),
        lambda: train_self_attention_bwd_plain(x, kvalid, dout, pa, mb, H=H,
                                               S=S),
        fl_b, nbytes(x, kvalid, dout, x) + pa_bytes + 2 * pa_bytes,
        tol=GRAD_TOL, extra={"rate": RATE}))

    # a sample without a valid key through kernel 8 (compared only): it
    # attends uniformly, forward and backward, beside two short samples
    # with wholly masked key tiles; dropout 0.1
    kv3 = torch.ones(3, S)
    kv3[0] = 0
    kv3[1, 20:] = 0
    kv3[2, [0, 1, 5, 6]] = 1
    kv3[2, 2:5], kv3[2, 7:10], kv3[2, 40:] = 0, 0, 0
    kv3 = kv3.reshape(3 * S).to(dev).contiguous()
    x3, dout3 = x[:3 * S].contiguous(), dout[:3 * S].contiguous()
    m3 = train_self_attention_masks(3, S, D, H, RATE, SEED, dev)
    o3, s3 = train_self_attention_fwd(x3, kv3, pa, H=H, S=S,
                                      return_saved=True, **kw)
    emit({"phase": "kernel8_masking", "tol": KERNEL_TOL,
          "grad_tol": GRAD_TOL, "fwd_rel_err": compare(
              "train_self_attention, no valid key", o3,
              train_self_attention_plain(x3.float(), kv3, f32(pa), m3, H=H,
                                         S=S), KERNEL_TOL)[0],
          "bwd_rel_err": compare(
              "train_self_attention_bwd, no valid key",
              flat(*train_self_attention_bwd(x3, kv3, dout3, pa, s3, H=H,
                                             S=S, **kw)),
              flat(*train_self_attention_bwd_plain(
                  x3.float(), kv3, dout3.float(), f32(pa), m3, H=H, S=S)),
              GRAD_TOL)[0]})
    del o3, s3, m3
    _kernel8_shapes(dev, rnd, x, dout, kvalid, pa, kv3, lengths, RATE, SEED)

    # dropout: keep fraction of a large mask, seeds
    keep = {"probabilities": float((masks[0] > 0).float().mean()),
            "residual": float((masks[1] > 0).float().mean())}
    a = attn_fwd(rate=RATE, seed=SEED)
    same = bool(torch.equal(a, attn_fwd(rate=RATE, seed=SEED)))
    other = not bool(torch.equal(a, attn_fwd(rate=RATE, seed=SEED + 1)))
    f_a = train_postnorm_ffn_fwd(x, pf, rate=RATE, seed=SEED)
    same = same and bool(torch.equal(f_a, train_postnorm_ffn_fwd(
        x, pf, rate=RATE, seed=SEED)))
    other = other and not bool(torch.equal(f_a, train_postnorm_ffn_fwd(
        x, pf, rate=RATE, seed=SEED + 1)))
    emit({"phase": "dropout", "rate": RATE, "keep_fraction": keep,
          "mask_elements": [masks[0].numel(), masks[1].numel()],
          "same_seed_same_output": same, "other_seed_other_output": other})
    if not (same and other
            and all(abs(k - (1 - RATE)) <= 0.005 for k in keep.values())):
        fail("dropout: keep fraction or seed behaviour is off")
    del masks, mb, saved, a, f_a
    # kernel 9's backward sums over rows in a fixed order: equal bits
    runs = [flat(*train_postnorm_ffn_bwd(x, dout, pf, **kw))
            for _ in range(2)]
    bits = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    emit({"phase": "kernel9_bwd_bits", "rows": M, "rate": RATE,
          "bits_equal_over_two_runs": bits})
    if not bits:
        fail("train_postnorm_ffn_bwd: two runs on the same inputs differ")
    del runs

    # the decoder stream, which each training step also runs through both
    # kernels: 196 frames and no distribution tokens, so another last key
    # and query tile; compared only, dropout 0.1, every gradient
    S2 = S - 10
    M2 = B * S2
    x2, dout2 = rnd(M2, D), rnd(M2, D, scale=0.1)
    kvalid2 = lengths_to_mask(lengths, S2).reshape(M2).float().to(
        dev).contiguous()
    errs = {}
    masks = train_postnorm_ffn_masks(M2, D, F, RATE, SEED, dev)
    errs["train_postnorm_ffn"] = compare(
        "train_postnorm_ffn, decoder stream",
        train_postnorm_ffn_fwd(x2, pf, **kw),
        train_postnorm_ffn_plain(x2.float(), f32(pf), masks), KERNEL_TOL)[0]
    errs["train_postnorm_ffn_bwd"] = compare(
        "train_postnorm_ffn_bwd, decoder stream",
        flat(*train_postnorm_ffn_bwd(x2, dout2, pf, **kw)),
        flat(*train_postnorm_ffn_bwd_plain(*up(x2, dout2), f32(pf), masks)),
        GRAD_TOL)[0]
    masks = train_self_attention_masks(B, S2, D, H, RATE, SEED, dev)
    out2, saved2 = train_self_attention_fwd(x2, kvalid2, pa, H=H, S=S2,
                                            return_saved=True, **kw)
    errs["train_self_attention"] = compare(
        "train_self_attention, decoder stream", out2,
        train_self_attention_plain(x2.float(), kvalid2, f32(pa), masks, H=H,
                                   S=S2), KERNEL_TOL)[0]
    errs["train_self_attention_bwd"] = compare(
        "train_self_attention_bwd, decoder stream",
        flat(*train_self_attention_bwd(x2, kvalid2, dout2, pa, saved2, H=H,
                                       S=S2, **kw)),
        flat(*train_self_attention_bwd_plain(
            x2.float(), kvalid2, dout2.float(), f32(pa), masks, H=H, S=S2)),
        GRAD_TOL)[0]
    emit({"phase": "kernels_decoder_stream", "rows": M2, "seq": S2,
          "rate": RATE, "worst_rel_err": errs, "tol": KERNEL_TOL,
          "grad_tol": GRAD_TOL})

    # the MD layer's sa_block tail, which stage 2 runs through kernel 9 with
    # ReLU: 128 x 5 = 640 rows at full width (one row range in the split
    # weight-gradient reduction; the forward on clusters), the small
    # slice's 4 x 5 = 20 rows (one partial 64-row block), and 1000 rows (a
    # partial last block); compared only, dropout 0 and 0.1.  The
    # gradients downstream of the ReLU's derivative (da: dx, ln1, w1, b1)
    # have its tolerance, the others (dy, gd: w2, b2, ln2) the common one
    relu = randomize_(TransformerEncoderLayer(D, H, F, "relu"), 32).to(
        dev, bf)
    pr = {"ln1_w": relu.norm1.weight, "ln1_b": relu.norm1.bias,
          "w1": relu.linear1.weight, "b1": relu.linear1.bias,
          "w2": relu.linear2.weight, "b2": relu.linear2.bias,
          "ln2_w": relu.norm2.weight, "ln2_b": relu.norm2.bias}
    pr = {k: pr[k].detach() for k in FFN_PARAM_ORDER}
    after_relu = ("w2", "b2", "ln2_w", "ln2_b")
    errs = {}
    for rows in (640, 20, 1000):
        x3, dout3 = rnd(rows, D), rnd(rows, D, scale=0.1)
        for rate in (0.0, RATE):
            kw3 = dict(activation="relu", rate=rate, seed=SEED)
            masks = (train_postnorm_ffn_masks(rows, D, F, rate, SEED, dev)
                     if rate else None)
            case = f"relu, {rows} rows, rate {rate}"
            e_f = compare(
                f"train_postnorm_ffn, {case}",
                train_postnorm_ffn_fwd(x3, pr, **kw3),
                train_postnorm_ffn_plain(x3.float(), f32(pr), masks,
                                         activation="relu"), KERNEL_TOL)[0]
            got = flat(*train_postnorm_ffn_bwd(x3, dout3, pr, **kw3))
            want = flat(*train_postnorm_ffn_bwd_plain(
                *up(x3, dout3), f32(pr), masks, activation="relu"))
            e_b = compare(f"train_postnorm_ffn_bwd after the ReLU, {case}",
                          {k: got[k] for k in after_relu},
                          {k: want[k] for k in after_relu}, GRAD_TOL)[0]
            e_r = compare(f"train_postnorm_ffn_bwd through the ReLU, {case}",
                          {k: v for k, v in got.items()
                           if k not in after_relu},
                          {k: v for k, v in want.items()
                           if k not in after_relu}, RELU_GRAD_TOL)[0]
            errs[case] = {"fwd": e_f, "bwd_after_relu": e_b,
                          "bwd_through_relu": e_r,
                          "geometry": ffn_launch_geometry(
                              "train_ffn", dev, rows, D, F)}
    emit({"phase": "kernels_md_sa_block_stream", "worst_rel_err": errs,
          "tol": KERNEL_TOL, "grad_tol": GRAD_TOL,
          "relu_grad_tol": RELU_GRAD_TOL})
    # kernel 9 as stage 2 runs it, timed: 640 rows, ReLU, dropout 0.1 (the
    # forward on clusters); the gradients through the ReLU's tolerance
    x3, dout3 = rnd(640, D), rnd(640, D, scale=0.1)
    masks = train_postnorm_ffn_masks(640, D, F, RATE, SEED, dev)
    mb = tuple(m.to(bf) for m in masks)
    kw3 = dict(activation="relu", rate=RATE, seed=SEED)
    pr_bytes = nbytes(*pr.values())
    md = {"path": KERNEL9_MD_PATH, "rate": RATE}
    recs.append(check_kernel(
        "train_postnorm_ffn", "ladiff_torch/csrc/train_ffn.cu",
        "ladiff_tpu/ops/pallas_train_ffn.py:209",
        lambda: train_postnorm_ffn_fwd(x3, pr, **kw3),
        lambda: train_postnorm_ffn_plain(x3.float(), f32(pr), masks,
                                         activation="relu"),
        lambda: train_postnorm_ffn_plain(x3, pr, mb, activation="relu"),
        4 * 640 * D * F, nbytes(x3, x3) + pr_bytes,
        extra={**md, "geometry": ffn_launch_geometry(
            "train_ffn", dev, 640, D, F)}))
    recs[-1]["path"] = KERNEL9_MD_PATH
    recs.append(check_kernel(
        "train_postnorm_ffn_bwd", "ladiff_torch/csrc/train_ffn.cu",
        "ladiff_tpu/ops/pallas_train_ffn.py:209",
        lambda: flat(*train_postnorm_ffn_bwd(x3, dout3, pr, **kw3)),
        lambda: flat(*train_postnorm_ffn_bwd_plain(
            *up(x3, dout3), f32(pr), masks, activation="relu")),
        lambda: train_postnorm_ffn_bwd_plain(x3, dout3, pr, mb,
                                             activation="relu"),
        8 * 640 * D * F, nbytes(x3, dout3, x3) + 3 * pr_bytes,
        tol=RELU_GRAD_TOL, extra=md))
    recs[-1]["path"] = KERNEL9_MD_PATH
    del masks, mb
    _attention_breakdown(dev, x, kvalid, dout, pa, H, S, RATE, SEED)
    _ffn_breakdown(dev, x, dout, pf, pr, rnd, RATE, SEED)
    return recs


def _gemm_inputs(dev, rnd, name, M, D, H, rate, seed):
    """One product of kernel 8 at M rows of width D (head width D / H): the
    operands a, w and the epilogue's tensors as ``train_gemm_launch`` takes
    them, and the plain version's extra arguments (out_drop: the residual
    mask ``train_self_attention_masks`` draws)."""
    from ladiff_torch.ops.train_attention import train_self_attention_masks
    w_out, w_in = rnd(D, D, scale=D ** -0.5), rnd(3 * D, D, scale=D ** -0.5)
    a = rnd(M, 3 * D if name in ("dx", "wgrad") else D)
    resid = rnd(M, D)
    bias = rnd(3 * D if name == "qkv" else D, scale=0.05)
    if name == "qkv":
        return a, w_in, {"bias": bias}, {}
    if name == "out":
        return a, w_out, {"bias": bias, "resid": resid}, {}
    if name == "out_drop":
        rm = train_self_attention_masks(M, 1, D, H, rate, seed, dev)[1]
        return a, w_out, {"bias": bias, "resid": resid, "rate": rate,
                          "seed": seed}, {"rm": rm}
    if name == "dctx":
        return a, w_out, {"resid": resid, "H": H}, {}
    if name == "dx":
        return a, w_in, {"resid": resid}, {}
    return a, rnd(M, D), {}, {}  # wgrad: dqkv^T x over K ranges


def _train_gemm_products(dev, rate=0.1, seed=0x5EED):
    """``train_gemm_products``: each product of kernels 8 and 12 alone on
    the GEMM block against its float32 product (the MN-major operands and
    the new epilogues), at every tile width it may take, at 618 and 26,368
    rows and D 64, 128, 192, 256 (head widths 16, 32, 48, 64); then the
    out-projection's residual mask drawn in the epilogue, bit for bit
    against ``train_self_attention_masks`` (a zero product, a bias of 1, a
    zero residual: the output is the mask)."""
    import torch
    from ladiff_torch.ops.train_attention import (TRAIN_GEMMS, dctx_widths,
                                                  train_gemm_launch,
                                                  train_gemm_plain,
                                                  train_self_attention_masks)
    g = torch.Generator().manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(
            dev, torch.bfloat16)

    bns = {"qkv": (256, 192, 128), "out": (256, 128), "out_drop": (256, 128),
           "dx": (256, 128)}
    res = {}
    for name in TRAIN_GEMMS:
        worst, n = (0.0, ""), 0
        for D, H in ((64, 4), (128, 4), (192, 4), (256, 4)):
            for M in (618, 26368):
                a, w, kw, pkw = _gemm_inputs(dev, rnd, name, M, D, H, rate,
                                             seed)
                widths = (dctx_widths(D, H) if name == "dctx"
                          else bns.get(name, (0,)))
                for bn in widths:
                    got, geo = train_gemm_launch(name, a, w, bn=bn, **kw)
                    want = train_gemm_plain(
                        name, a, w, ranges=geo.get("ranges"), **pkw,
                        **{k: v for k, v in kw.items()
                           if k in ("bias", "resid", "H")})
                    key = f"D {D}, {M} rows, BN {geo['bn']}"
                    err = compare(f"train_gemm {name}, {key}",
                                  _named(got) if name == "dctx" else got,
                                  _named(want) if name == "dctx" else want,
                                  KERNEL_TOL)[0]
                    worst = max(worst, (err, key))
                    n += 1
                del a, w, kw, pkw
        res[name] = {"cases": n, "worst_rel_err": worst[0], "at": worst[1]}
    M, D, H = 26368, 256, 4
    zero = torch.zeros(M, D, dtype=torch.bfloat16, device=dev)
    ones = torch.ones(D, dtype=torch.bfloat16, device=dev)
    got, _ = train_gemm_launch("out_drop", zero, rnd(D, D), bias=ones,
                               resid=zero, rate=rate, seed=seed)
    rm = train_self_attention_masks(M, 1, D, H, rate, seed, dev)[1]
    bits = bool(torch.equal(got, rm.to(torch.bfloat16)))
    emit({"phase": "train_gemm_products", "tol": KERNEL_TOL,
          "products": res, "residual_mask_bit_equal": bits})
    if not bits:
        fail("train_gemm out_drop: the epilogue's residual mask differs "
             "from train_self_attention_masks")


def _kernel8_shapes(dev, rnd, x, dout, kvalid, pa, kv3, lengths, rate,
                    seed):
    """``kernel8_shapes``: kernel 8 forward and every gradient against its
    float32 plain version where the other cells do not reach: dropout 0 at
    the decoder stream's 128 x 196 rows and at 3 x 206 (a sample without
    a valid key, wholly masked key tiles), and D 64 / H 4 and D 192 / H 4
    (head widths 16 and 48) at 7 x 48 rows, dropout 0 and 0.1."""
    import torch
    from ladiff_torch.ops.train_attention import (
        train_self_attention_bwd, train_self_attention_bwd_plain,
        train_self_attention_fwd, train_self_attention_masks,
        train_self_attention_plain)
    from ladiff_torch.utils.masks import lengths_to_mask
    S = 206
    B = x.shape[0] // S
    D = x.shape[1]
    H = 4
    cases = {}

    def run(key, xs, ds, kv, p, S_, H_, r):
        Bs = xs.shape[0] // S_
        masks = (train_self_attention_masks(Bs, S_, xs.shape[1], H_, r, seed,
                                            dev) if r else None)
        kw = dict(H=H_, S=S_, rate=r, seed=seed)
        f32 = {k: v.float() for k, v in p.items()}
        out, saved = train_self_attention_fwd(xs, kv, p, return_saved=True,
                                              **kw)
        e_f = compare(f"train_self_attention, {key}", out,
                      train_self_attention_plain(xs.float(), kv, f32, masks,
                                                 H=H_, S=S_), KERNEL_TOL)[0]
        dx, grads = train_self_attention_bwd(xs, kv, ds, p, saved, **kw)
        wdx, wgrads = train_self_attention_bwd_plain(
            xs.float(), kv, ds.float(), f32, masks, H=H_, S=S_)
        e_b = compare(f"train_self_attention_bwd, {key}",
                      {"dx": dx, **grads}, {"dx": wdx, **wgrads},
                      GRAD_TOL)[0]
        cases[key] = {"fwd": e_f, "bwd": e_b}

    S2 = S - 10
    x2, d2 = rnd(B * S2, D), rnd(B * S2, D, scale=0.1)
    kv2 = lengths_to_mask(lengths, S2).reshape(-1).float().to(
        dev).contiguous()
    run(f"{B} x {S2} rows, rate 0", x2, d2, kv2, pa, S2, H, 0.0)
    run(f"3 x {S} rows, rate 0", x[:3 * S].contiguous(),
        dout[:3 * S].contiguous(), kv3, pa, S, H, 0.0)
    for Dk in (64, 192):
        pk = {"in_w": rnd(3 * Dk, Dk, scale=Dk ** -0.5),
              "in_b": rnd(3 * Dk, scale=0.05),
              "out_w": rnd(Dk, Dk, scale=Dk ** -0.5),
              "out_b": rnd(Dk, scale=0.05)}
        Bk, Sk = 7, 48
        kvk = lengths_to_mask(torch.tensor([48, 1, 30, 17, 48, 5, 40]),
                              Sk).reshape(-1).float().to(dev).contiguous()
        xk, dk = rnd(Bk * Sk, Dk), rnd(Bk * Sk, Dk, scale=0.1)
        for r in (0.0, rate):
            run(f"D {Dk}, H 4, {Bk} x {Sk} rows, rate {r}", xk, dk, kvk, pk,
                Sk, 4, r)
    emit({"phase": "kernel8_shapes", "tol": KERNEL_TOL,
          "grad_tol": GRAD_TOL, "worst_rel_err": cases})


# the GEMM block's epilogue numbers (csrc/gemm_sm90.cuh) and operand
# layouts -> kernel 8's products
_K8_PRODUCTS = {("0", "false"): "qkv", ("5", "false"): "out",
                ("6", "false"): "out", ("7", "true"): "dctx",
                ("5", "true"): "dx", ("8", "true"): "wgrad"}


def _attention_breakdown(dev, x, kvalid, dout, pa, H, S, rate, seed):
    """``train_attention_breakdown``: kernel 8's launches one by one at the
    stage-1 encoder's rows, dropout ``rate`` (device ms per call), each
    product's TFLOP/s and cuBLAS's time for the same product shape (bf16
    ``F.linear`` / ``matmul``: a yardstick the port never calls), and each
    product's launch geometry."""
    import re

    import torch
    import torch.nn.functional as F
    from ladiff_torch.ops.clip_layer import gemm_cluster_slots
    from ladiff_torch.ops.train_attention import (attention_gemm_geometry,
                                                  dctx_widths,
                                                  train_gemm_launch,
                                                  train_self_attention_bwd,
                                                  train_self_attention_fwd)
    M, D = x.shape
    kw = dict(H=H, S=S, rate=rate, seed=seed)
    _, saved = train_self_attention_fwd(x, kvalid, pa, return_saved=True,
                                        **kw)
    qkv, ctx = saved[0], saved[1]
    flops = {"qkv": 2 * M * D * 3 * D, "out": 2 * M * D * D,
             "dctx": 2 * M * D * D, "dx": 2 * M * 3 * D * D,
             "wgrad": 2 * M * 3 * D * D + 2 * M * D * D}
    rows = {}
    for side, fn in (
            ("forward", lambda: train_self_attention_fwd(x, kvalid, pa,
                                                         **kw)),
            ("backward", lambda: train_self_attention_bwd(
                x, kvalid, dout, pa, saved, **kw))):
        rows[side] = launch_breakdown(fn)
        for r in rows[side]:
            m = re.search(r"gemm_sm90_kernel<(\d+), (\d+), (\w+), (\w+)>",
                          r["kernel"])
            if m:
                name = _K8_PRODUCTS.get((m.group(2), m.group(4)), "?")
                r["product"] = name
                if name in flops:
                    r["tflops"] = flops[name] / r["ms"] / 1e9
    cublas = {
        "qkv": lambda: F.linear(x, pa["in_w"], pa["in_b"]),
        "out": lambda: F.linear(ctx, pa["out_w"], pa["out_b"]),
        "dctx": lambda: dout @ pa["out_w"],
        "dx": lambda: qkv @ pa["in_w"],
        "wgrad": lambda: (qkv.t() @ x, dout.t() @ ctx)}
    lib = {}
    for name, fn in cublas.items():
        ms = device_ms(fn)
        lib[name] = {"ms": ms, "tflops": flops[name] / ms / 1e9}
    # each product at each tile width it may take (the geometry's choice
    # among them rests on a cost model that does not see the epilogue)
    g = torch.Generator().manual_seed(6)
    sweep = {}
    for name in ("qkv", "out", "out_drop", "dctx", "dx"):
        a, w, kwg, _ = _gemm_inputs(
            dev, lambda *sh, scale=1.0: (torch.randn(*sh, generator=g)
                                         * scale).to(dev, torch.bfloat16),
            name, M, D, H, rate, seed)
        widths = {"qkv": (256, 192, 128),
                  "dctx": dctx_widths(D, H)}.get(name, (256, 128))
        sweep[name] = {}
        for bn in widths:
            ms = device_ms(lambda: train_gemm_launch(name, a, w, bn=bn,
                                                     **kwg))
            fl = flops["out" if name == "out_drop" else name]
            sweep[name][bn] = {"ms": ms, "tflops": fl / ms / 1e9}
        del a, w, kwg
    geo = attention_gemm_geometry(M, D, H, gemm_cluster_slots(dev))
    emit({"phase": "train_attention_breakdown", "rows": M, "rate": rate,
          "launches": rows, "cublas": lib, "tile_width_sweep": sweep,
          "geometry": {k: {f: v[f] for f in ("bn", "tiles", "pairs", "ctas",
                                             "waves", "splits")
                           if f in v} for k, v in geo.items()}})


def _ffn_breakdown(dev, x, dout, pf, pr, rnd, rate, seed):
    """``ffn_breakdown``: kernel 9's backward launch by launch at the
    encoder's rows (GELU) and at the denoiser's 640 (ReLU), its forward at
    640 rows, and kernel 5 at the MD tail's 2560 rows (ReLU) and at the
    encoder's rows (GELU): device ms per call, dropout ``rate``; the launch
    geometry of each; kernel 5 at 2560 rows and kernel 9's forward at 640
    on C = 1, 2 and 4 CTAs a block, each compared with its plain version
    and timed."""
    from ladiff_torch.ops.postnorm_ffn import (ffn_launch_geometry,
                                               fused_postnorm_ffn,
                                               postnorm_ffn_plain)
    from ladiff_torch.ops.train_ffn import (train_postnorm_ffn_bwd,
                                            train_postnorm_ffn_fwd,
                                            train_postnorm_ffn_masks,
                                            train_postnorm_ffn_plain)
    M, D = x.shape
    F = pf["w1"].shape[0]
    kw = dict(rate=rate, seed=seed)
    relu = dict(activation="relu", **kw)
    x640, d640, x2560 = rnd(640, D), rnd(640, D, scale=0.1), rnd(2560, D)
    f32 = {k: v.float() for k, v in pr.items()}
    m640 = train_postnorm_ffn_masks(640, D, F, rate, seed, dev)
    want5 = postnorm_ffn_plain(x2560.float(), f32, activation="relu")
    want9 = train_postnorm_ffn_plain(x640.float(), f32, m640,
                                     activation="relu")
    sweep = {"kernel5 2560 rows, relu": {}, "kernel9_fwd 640 rows, relu": {}}
    for C in (1, 2, 4):
        k5 = lambda: fused_postnorm_ffn(x2560, pr, activation="relu",
                                        cluster=C)
        k9 = lambda: train_postnorm_ffn_fwd(x640, pr, cluster=C, **relu)
        sweep["kernel5 2560 rows, relu"][C] = {
            "rel_err": compare(f"fused_postnorm_ffn, 2560 rows, C {C}", k5(),
                               want5, KERNEL_TOL)[0], "ms": device_ms(k5)}
        sweep["kernel9_fwd 640 rows, relu"][C] = {
            "rel_err": compare(f"train_postnorm_ffn, 640 rows, C {C}", k9(),
                               want9, KERNEL_TOL)[0], "ms": device_ms(k9)}
    emit({"phase": "ffn_breakdown", "rate": rate,
          "kernel9_bwd": {
              f"{M} rows, gelu": launch_breakdown(
                  lambda: train_postnorm_ffn_bwd(x, dout, pf, **kw)),
              "640 rows, relu": launch_breakdown(
                  lambda: train_postnorm_ffn_bwd(x640, d640, pr, **relu))},
          "kernel9_fwd_ms": {
              "640 rows, relu": device_ms(
                  lambda: train_postnorm_ffn_fwd(x640, pr, **relu))},
          "kernel5_ms": {
              "2560 rows, relu": device_ms(
                  lambda: fused_postnorm_ffn(x2560, pr, activation="relu")),
              f"{M} rows, gelu": device_ms(
                  lambda: fused_postnorm_ffn(x, pf, activation="gelu"))},
          "geometry": {
              "kernel5 2560 rows": ffn_launch_geometry(
                  "postnorm_ffn", dev, 2560, D, F),
              f"kernel5 {M} rows": ffn_launch_geometry(
                  "postnorm_ffn", dev, M, D, F),
              "kernel9_fwd 640 rows": ffn_launch_geometry(
                  "train_ffn", dev, 640, D, F),
              f"kernel9_fwd {M} rows": ffn_launch_geometry(
                  "train_ffn", dev, M, D, F)},
          "cluster_sweep": sweep})


def _vae_loss_and_grads(system, batch, eps, std, lambda_joint):
    """``vae_forward``'s loss and every VAE gradient (float32, on the CPU)
    in training mode at the given feature std and joints-loss weight."""
    import torch
    from ladiff_torch.losses.mld import LossWeights
    system.std.fill_(std)
    system.weights = LossWeights(lambda_joint=lambda_joint)
    system.zero_grad(set_to_none=True)
    total, _ = system.vae_forward(batch, train=True, eps=eps)
    total.backward()
    return float(total.detach()), {
        n: p.grad.detach().float().cpu()
        for n, p in system.vae.named_parameters()}


# case: (feature std, joints-loss weight); see phase_train_slice
SLICE_CASES = {"unit_std_no_joints": (1.0, 0.0),
               "std_0.1_all_losses": (0.1, 1.0),
               "unit_std_all_losses": (1.0, 1.0)}


def _against_cpu(name, system, batch, eps, case, want_loss, want, tol=None):
    """One system's loss and gradients against the float32 CPU run's, each
    gradient tensor on its own; fails beyond ``tol`` (a number, or a
    tolerance per tensor name; None: reported only).  Returns the record
    and the error of each tensor."""
    import numpy as np
    import torch
    loss, grads = _vae_loss_and_grads(system, batch, eps, *SLICE_CASES[case])
    errs = {n: relerr(grads[n], w) for n, w in want.items()}
    worst = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(t).all()) for t in grads.values())
    rec = {"loss_rel_err": abs(loss - want_loss) / abs(want_loss),
           "worst_grad_rel_err": errs[worst], "worst_grad": worst,
           "median_grad_rel_err": float(np.median(list(errs.values()))),
           "n_grad_tensors": len(errs)}
    if tol is None:
        return rec, errs
    tols = tol if isinstance(tol, dict) else {n: tol for n in errs}
    over = max(errs, key=lambda n: errs[n] / tols[n])
    if not (finite and rec["loss_rel_err"] <= TRAIN_LOSS_TOL
            and errs[over] <= tols[over]):
        fail(f"{name} ({case}): loss rel err {rec['loss_rel_err']} (tol "
             f"{TRAIN_LOSS_TOL}), gradient of {over} rel err {errs[over]} "
             f"(tol {tols[over]}), finite={finite}")
    return rec, errs


def _slice_cases(name, gpu, cpu, ctl, batch, eps, cases=tuple(SLICE_CASES),
                 against_control=False):
    """Per case, the card system and the plain bf16 CPU control against the
    float32 CPU run of the same weights.  The card is held to
    ``TRAIN_GRAD_TOL`` where it names the case, or with
    ``against_control`` each gradient tensor to ``DIFF_GRAD_RATIO`` times
    the control's error for it (at least ``DIFF_GRAD_FLOOR``)."""
    out = {}
    for case in cases:
        loss_c, grads_c = _vae_loss_and_grads(cpu, batch, eps,
                                              *SLICE_CASES[case])
        rec_ctl, err_ctl = _against_cpu(name, ctl, batch, eps, case, loss_c,
                                        grads_c)
        tol = ({n: max(DIFF_GRAD_RATIO * e, DIFF_GRAD_FLOOR)
                for n, e in err_ctl.items()} if against_control
               else TRAIN_GRAD_TOL.get(case))
        out[case] = {
            "grad_tol": ("per tensor: the control's error times "
                         f"{DIFF_GRAD_RATIO}, at least {DIFF_GRAD_FLOOR}"
                         if against_control else tol), "loss_cpu": loss_c,
            "card": _against_cpu(name, gpu, batch, eps, case, loss_c,
                                 grads_c, tol)[0],
            "cpu_bf16_plain": rec_ctl}
    return out


def phase_train_slice(dev):
    """Small batch, mixed lengths, dropout 0: loss and every parameter's
    gradient on the card (kernels, bf16 compute, float32 parameters) against
    the CPU (plain versions, float32), same weights and same latent noise;
    then a few optimizer steps, then the validation pass."""
    import torch
    from ladiff_torch import train_bench
    from ladiff_torch.training.trainer import vae_train_step

    lengths = torch.tensor([16, 60, 123, 196])
    B = len(lengths)
    g = torch.Generator().manual_seed(6)
    batch = {"motion": torch.randn(B, 196, 263, generator=g),
             "length": lengths}
    eps = torch.randn(B, 5, 256, generator=g)

    # the same published-width system three times, from the same weights:
    # CPU float32 (the reference), CPU bf16 compute through the plain
    # versions (the control: what bf16 alone costs), the card (kernels)
    cpu = randomize_(train_bench.build("cpu", dropout=0.0)[0], 22)
    ctl = train_bench.build("cpu", dropout=0.0, dtype=torch.bfloat16)[0]
    gpu = train_bench.build(dev, dropout=0.0)[0]
    for other in (ctl, gpu):
        other.load_state_dict(cpu.state_dict(), strict=True)

    # case: (feature std, joints-loss weight).  The joints loss integrates
    # the root's rotation and velocity over the frames; at unit feature std
    # with random weights that walk amplifies any rounding, which the
    # control shows without a kernel in the path: in the third case the
    # plain bf16 CPU run is as far from float32 as the card is.  So the
    # gradients are held to the CPU at unit std through the feature and KL
    # losses, and through all losses at a feature std of 0.1, where the
    # recovered joints are a smooth function of the features; the third
    # case is reported beside them and held to nothing.
    t0 = time.perf_counter()
    out = _slice_cases("training slice", gpu, cpu, ctl, batch, eps)
    t_cpu = time.perf_counter() - t0
    del gpu, ctl

    # optimizer steps from the trainer's own seeded initialisation at the
    # well-conditioned feature std.  Beside them, held to nothing, the same
    # steps at unit std (the joints term jumps from step to step while the
    # feature term falls) and from the randomized weights above (unit-gain
    # weights in every projection, too coarse for AdamW's 1e-4)
    def steps(std, randomized=False, n=8):
        system, opt = train_bench.build(dev, dropout=0.0)
        if randomized:
            system.load_state_dict(cpu.state_dict(), strict=True)
        system.std.fill_(std)
        logs = [vae_train_step(system, opt, batch, eps=eps)
                for _ in range(n)]
        return system, {k: [float(l[k]) for l in logs]
                        for k in ("total", "recons_feature")}

    gpu, held_steps = steps(0.1)
    losses = held_steps["total"]
    controls = {"unit_std": steps(1.0)[1],
                "std_0.1_randomized_weights": steps(0.1, True)[1]}

    cpu.load_state_dict(gpu.state_dict(), strict=True)
    cpu.std.fill_(0.1)
    with torch.no_grad():
        val_c, (_, aux_c) = cpu.vae_forward(batch, train=False, eps=eps)
        val_g, (_, aux_g) = gpu.vae_forward(batch, train=False, eps=eps)
    err_val = abs(float(val_g) - float(val_c)) / abs(float(val_c))
    err_feats = relerr(aux_g["feats_rst"].float().cpu(), aux_c["feats_rst"])
    emit({"phase": "train_slice", "batch": B, "lengths": lengths.tolist(),
          "loss_tol": TRAIN_LOSS_TOL, "feats_tol": TRAIN_FEATS_TOL,
          "cases": out, "step_losses": losses,
          "step_recons_feature": held_steps["recons_feature"],
          "control_steps": controls,
          "validation_loss_rel_err": err_val,
          "validation_feats_rel_err": err_feats, "cpu_s": t_cpu})
    if not losses[-1] < losses[0]:
        fail(f"training slice: the loss did not fall: {losses}")
    if not (err_val <= TRAIN_LOSS_TOL and err_feats <= TRAIN_FEATS_TOL):
        fail("training slice: the validation pass disagrees with the CPU")


def phase_train_bench(dev):
    import torch
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc

    system, opt = train_bench.build(dev)
    batch = train_bench.make_batch(device=system.device)
    iters = 5
    cc.reset_launch_counts()
    res = train_bench.measure(system, opt, batch, iters=iters)
    counts = cc.launch_counts()
    steps = train_bench.WARMUP + iters
    per_step = {k: v / steps for k, v in counts.items()}
    cc.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        val, _ = system.vae_forward(batch, train=False, generator=gen)
    torch.cuda.synchronize()
    val_counts = cc.launch_counts()
    emit({"phase": "train_bench", "batch": train_bench.BATCH,
          "frames": train_bench.FRAMES, "dropout": train_bench.DROPOUT,
          "steps": iters, "warmup": train_bench.WARMUP,
          "ms_per_step": res["ms_per_step"],
          "samples_per_sec": res["samples_per_sec"], "loss": res["loss"],
          "grad_norm": res["grad_norm"], "peak_mem_gb": res["peak_mem_gb"],
          "launches": counts, "launches_per_step": per_step,
          "validation_loss": float(val),
          "validation_launches": val_counts})
    if not (math.isfinite(res["loss"]) and math.isfinite(res["grad_norm"])
            and math.isfinite(float(val))):
        fail("training bench: non-finite loss or gradient norm")
    for name, want in EXPECTED_PER_STEP.items():
        if per_step.get(name) != want:
            fail(f"{name}: {per_step.get(name)} launches per step, "
                 f"expected {want}")
    for name, want in EXPECTED_VALIDATION.items():
        if val_counts.get(name) != want:
            fail(f"{name}: {val_counts.get(name)} launches in the "
                 f"validation pass, expected {want}")
    return {k: counts[k] + val_counts[k] for k in counts}


def phase_diffusion_slice(dev):
    """Small batch, mixed lengths, dropout 0: stage 2 and the joint stage on
    the card (kernels, bf16 compute, float32 parameters) against the CPU
    (plain versions, float32), same weights and the same random draws."""
    import numpy as np
    import torch
    from ladiff_torch import train_bench
    from ladiff_torch.losses.mld import LossWeights
    from ladiff_torch.training.trainer import diffusion_train_step

    lengths = torch.tensor([16, 60, 123, 196])
    B = len(lengths)
    g = torch.Generator().manual_seed(6)  # the training slice's motions
    batch = {"motion": torch.randn(B, 196, 263, generator=g),
             "length": lengths}
    vae_eps = torch.randn(B, 5, 256, generator=g)
    batch["text_emb"] = torch.randn(B, 1, 768, generator=g)
    uncond = 0.1 * torch.randn(1, 1, 768, generator=g)
    draws = {"eps": torch.randn(B, 5, 256, generator=g),
             "noise": torch.randn(B, 5, 256, generator=g),
             "timesteps": torch.randint(0, 1000, (B,), generator=g),
             "cond_drop": torch.tensor([False, True, False, False]).reshape(
                 B, 1, 1)}
    init = torch.randn(B, 5, 256, generator=g)

    cpu = randomize_(train_bench.build("cpu", dropout=0.0)[0], 22)
    ctl = train_bench.build("cpu", dropout=0.0, dtype=torch.bfloat16)[0]
    gpu = train_bench.build(dev, dropout=0.0)[0]
    for other in (ctl, gpu):
        other.load_state_dict(cpu.state_dict(), strict=True)
    for system in (cpu, ctl, gpu):
        system.std.fill_(0.1)

    def run(system, joint, lambda_joint):
        system.weights = LossWeights(lambda_joint=lambda_joint)
        system.zero_grad(set_to_none=True)
        if joint:
            total, (logs, _) = system.vae_diffusion_forward(
                batch, uncond, train=True, eps=vae_eps,
                diffusion_draws=draws, init_latents=init)
        else:
            total, (logs, _) = system.diffusion_forward(
                batch, uncond, train=True, **draws)
        total.backward()
        return ({k: float(v.detach()) for k, v in logs.items()},
                {n: p.grad.detach().float().cpu()
                 for n, p in system.named_parameters()
                 if p.grad is not None})

    problems = []

    def against_cpu(system, case, want_logs, want, control=None):
        """Errors against the float32 CPU run: every loss term, and every
        gradient by name.  With ``control`` (the plain bf16 CPU run's errors
        by name) the run is held: each tensor to DIFF_GRAD_RATIO times the
        control's error for that tensor (DIFF_GRAD_FLOOR where the control's
        is smaller), the losses to DIFF_LOSS_TOL."""
        logs, grads = run(system, *cases[case])
        if set(grads) != set(want):
            fail("diffusion slice: other parameters have gradients than on "
                 f"the CPU: {sorted(set(grads) ^ set(want))[:5]}")
        loss_errs = {k: abs(logs[k] - w) / abs(w)
                     for k, w in want_logs.items()}
        rec = {"loss_rel_errs": loss_errs}
        if not all(bool(torch.isfinite(t).all()) for t in grads.values()):
            fail(f"diffusion slice ({case}): a gradient is not finite")
        errs = {n: relerr(grads[n], w) for n, w in want.items()}
        for tree in ("vae", "denoiser"):
            sub = {n: e for n, e in errs.items() if n.startswith(tree + ".")}
            if not sub:
                continue
            worst = max(sub, key=sub.get)
            rec[tree] = {
                "worst_grad_rel_err": sub[worst], "worst_grad": worst,
                "median_grad_rel_err": float(np.median(list(sub.values()))),
                "n_grad_tensors": len(sub)}
            if control is None:
                continue
            held = case in held_cases or tree == "denoiser"
            limit = {n: max(DIFF_GRAD_RATIO * control[n], DIFF_GRAD_FLOOR)
                     for n in sub}
            over = max(sub, key=lambda n: sub[n] / limit[n])
            rec[tree].update(
                held=held, worst_over_limit=sub[over] / limit[over],
                worst_over_limit_grad=over,
                worst_over_limit_control=control[over],
                n_above_control=sum(sub[n] > control[n] for n in sub))
            if held and sub[over] > limit[over]:
                problems.append(
                    f"{case}: gradient of {over} rel err {sub[over]}, the "
                    f"plain bf16 CPU run's {control[over]}, limit "
                    f"{limit[over]}")
        # the joints terms are printed; with weight 0 they reach no gradient
        if control is not None and case in held_cases:
            for k, e in loss_errs.items():
                if "joints" not in k and not e <= DIFF_LOSS_TOL:
                    problems.append(f"{case}: loss term {k} rel err {e} "
                                    f"(tol {DIFF_LOSS_TOL})")
        return rec, errs

    # case: (joint stage, joints-loss weight).  The first two are held in
    # full; in the third the generated motion's joints make the VAE's bf16
    # gradients ill-conditioned, so only its denoiser tree is held (the
    # denoiser's gradient comes from the diffusion loss alone)
    cases = {"diffusion_forward": (False, 1.0),
             "vae_diffusion_forward_no_joints": (True, 0.0),
             "vae_diffusion_forward_all_losses": (True, 1.0)}
    held_cases = ("diffusion_forward", "vae_diffusion_forward_no_joints")
    out = {}
    t0 = time.perf_counter()
    for case, (joint, lambda_joint) in cases.items():
        logs_c, grads_c = run(cpu, joint, lambda_joint)
        if not joint and any(n.startswith("vae.") for n in grads_c):
            fail("diffusion slice: the frozen VAE has a gradient")
        ctl_rec, ctl_errs = against_cpu(ctl, case, logs_c, grads_c)
        out[case] = {"grad_ratio": DIFF_GRAD_RATIO,
                     "grad_floor": DIFF_GRAD_FLOOR, "logs_cpu": logs_c,
                     "card": against_cpu(gpu, case, logs_c, grads_c,
                                         ctl_errs)[0],
                     "cpu_bf16_plain": ctl_rec}
    t_cpu = time.perf_counter() - t0
    del gpu, ctl

    # optimizer steps from the trainer's own initialisation, the same draws
    # every step, then the validation pass on both sides
    gpu, opt = train_bench.build(dev, dropout=0.0, stage="diffusion_train")
    losses = [float(diffusion_train_step(gpu, opt, batch, uncond,
                                         **draws)["total"])
              for _ in range(8)]
    if any(p.grad is not None for p in gpu.vae.parameters()):
        fail("diffusion slice: a train step gave the frozen VAE a gradient")
    cpu.load_state_dict(gpu.state_dict(), strict=True)
    val_draws = {k: v for k, v in draws.items() if k != "cond_drop"}
    with torch.no_grad():
        val_c, _ = cpu.diffusion_forward(batch, uncond, train=False,
                                         **val_draws)
        val_g, _ = gpu.diffusion_forward(batch, uncond, train=False,
                                         **val_draws)
    err_val = abs(float(val_g) - float(val_c)) / abs(float(val_c))
    emit({"phase": "diffusion_slice", "batch": B,
          "lengths": lengths.tolist(), "loss_tol": DIFF_LOSS_TOL,
          "cases": out, "step_losses": losses,
          "validation_loss_rel_err": err_val, "cpu_s": t_cpu})
    if problems:
        fail("diffusion slice: " + "; ".join(problems[:5]))
    if not losses[-1] < losses[0]:
        fail(f"diffusion slice: the loss did not fall: {losses}")
    if not err_val <= DIFF_LOSS_TOL:
        fail("diffusion slice: the validation pass disagrees with the CPU")


def phase_diffusion_bench(dev):
    import torch
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc

    iters = 5
    steps = train_bench.WARMUP + iters
    total_counts = {}
    for stage, expected in (("diffusion_train", EXPECTED_PER_DIFFUSION_STEP),
                            ("vae_diffusion_train", EXPECTED_PER_JOINT_STEP)):
        system, opt = train_bench.build(dev, stage=stage)
        batch = train_bench.make_batch(device=system.device)
        cc.reset_launch_counts()
        res = train_bench.measure(system, opt, batch, iters=iters,
                                  stage=stage)
        counts = cc.launch_counts()
        per_step = {k: v / steps for k, v in counts.items()}
        line = {"phase": "diffusion_bench", "stage": stage,
                "batch": train_bench.BATCH, "frames": train_bench.FRAMES,
                "dropout": train_bench.DROPOUT, "steps": iters,
                "warmup": train_bench.WARMUP,
                "ms_per_step": res["ms_per_step"],
                "samples_per_sec": res["samples_per_sec"],
                "loss": res["loss"], "grad_norm": res["grad_norm"],
                "peak_mem_gb": res["peak_mem_gb"], "launches": counts,
                "launches_per_step": per_step}
        if not (math.isfinite(res["loss"])
                and math.isfinite(res["grad_norm"])):
            fail(f"{stage}: non-finite loss or gradient norm")
        for name, want in expected.items():
            if per_step.get(name) != want:
                fail(f"{stage}: {name}: {per_step.get(name)} launches per "
                     f"step, expected {want}")
        for k, v in counts.items():
            total_counts[k] = total_counts.get(k, 0) + v
        if stage == "diffusion_train":
            cc.reset_launch_counts()
            gen = torch.Generator(device=dev).manual_seed(2)
            uncond = torch.zeros(1, 1, train_bench.TEXT_DIM, device=dev)
            with torch.no_grad():
                val, _ = system.diffusion_forward(batch, uncond, train=False,
                                                  generator=gen)
            torch.cuda.synchronize()
            val_counts = cc.launch_counts()
            line.update(validation_loss=float(val),
                        validation_launches=val_counts)
            if not math.isfinite(float(val)):
                fail("diffusion_train: non-finite validation loss")
            for name, want in EXPECTED_DIFFUSION_VALIDATION.items():
                if val_counts.get(name) != want:
                    fail(f"{name}: {val_counts.get(name)} launches in the "
                         f"stage-2 validation pass, expected {want}")
            for k, v in val_counts.items():
                total_counts[k] += v
        emit(line)
        del system, opt, batch
    return total_counts


def _slice_batch():
    """The training slices' batch: 4 samples of mixed lengths, and the
    latent noise."""
    import torch
    lengths = torch.tensor([16, 60, 123, 196])
    g = torch.Generator().manual_seed(6)
    batch = {"motion": torch.randn(len(lengths), 196, 263, generator=g),
             "length": lengths}
    return batch, torch.randn(len(lengths), 5, 256, generator=g)


def phase_whole_layer_slice(dev):
    """``train_slice`` on the whole-layer route (``train_whole_layer="1"``):
    loss and every VAE gradient by name on the card against the float32
    CPU run, the plain bf16 CPU run beside it, the same cases and
    tolerances; one forward and backward launches kernel 12 in each of the
    9 encoder layers and kernel 13 in each of the 9 decoder layers, and
    kernels 8 and 9 not at all."""
    import torch
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc

    batch, eps = _slice_batch()
    cpu = randomize_(train_bench.build("cpu", dropout=0.0)[0], 22)
    ctl = train_bench.build("cpu", dropout=0.0, dtype=torch.bfloat16)[0]
    gpu = train_bench.build(dev, dropout=0.0, train_whole_layer="1")[0]
    for other in (ctl, gpu):
        other.load_state_dict(cpu.state_dict(), strict=True)
    cc.reset_launch_counts()
    _vae_loss_and_grads(gpu, batch, eps, 1.0, 0.0)
    torch.cuda.synchronize()
    counts = cc.launch_counts()
    out = _slice_cases("whole-layer slice", gpu, cpu, ctl, batch, eps)
    emit({"phase": "whole_layer_slice", "batch": len(batch["length"]),
          "lengths": batch["length"].tolist(), "loss_tol": TRAIN_LOSS_TOL,
          "cases": out, "launches_per_step": counts})
    for name, want in EXPECTED_WHOLE_LAYER_PER_STEP.items():
        if counts.get(name) != want:
            fail(f"whole-layer slice: {name}: {counts.get(name)} launches "
                 f"per step, expected {want}")


def phase_gated_slice(dev):
    """VAEs whose shapes the training kernels' gates refuse: head width 128
    (d 256, 2 heads: kernel 8 refuses, kernel 9 takes the tail) and d 512 /
    ff 2048 (8 heads: both refuse), on the whole-layer route too (kernels
    12 and 13 refuse as well).  Loss and every gradient on the card against
    the float32 CPU run, each tensor held to 1.3 times the plain bf16 CPU
    control's error for it (with random weights at head width 128 the
    control alone read 7.1e-2 at worst in a run on an H100 machine, above
    ``train_slice``'s 6e-2), then one ``vae_train_step`` at batch 4 with
    the launch counts the gates give."""
    import torch
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.trainer import vae_train_step

    batch, _ = _slice_batch()
    out = {}
    for case, kw, kernel9 in (
            ("head_width_128", dict(num_heads=2), 18),
            ("d512_ff2048", dict(latent_dim=(7, 512), ff_size=2048,
                                 num_heads=8), 0)):
        eps = torch.randn(4, 5, kw.get("latent_dim", (7, 256))[1],
                          generator=torch.Generator().manual_seed(7))
        cpu = randomize_(train_bench.build("cpu", dropout=0.0, **kw)[0], 23)
        ctl = train_bench.build("cpu", dropout=0.0, dtype=torch.bfloat16,
                                **kw)[0]
        gpu, opt = train_bench.build(dev, dropout=0.0, train_whole_layer="1",
                                     **kw)
        for other in (ctl, gpu):
            other.load_state_dict(cpu.state_dict(), strict=True)
        res = _slice_cases(f"gated slice {case}", gpu, cpu, ctl, batch, eps,
                           cases=("unit_std_no_joints",),
                           against_control=True)
        del cpu, ctl
        cc.reset_launch_counts()
        logs = vae_train_step(gpu, opt, batch,
                              torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        counts = cc.launch_counts()
        want = {"train_self_attention": 0, "train_self_attention_bwd": 0,
                "train_postnorm_ffn": kernel9,
                "train_postnorm_ffn_bwd": kernel9,
                "train_encoder_layer": 0, "train_encoder_layer_bwd": 0,
                "train_decoder_layer": 0, "train_decoder_layer_bwd": 0}
        out[case] = {**res, "step_loss": float(logs["total"]),
                     "launches_per_step": counts}
        if not math.isfinite(float(logs["total"])):
            fail(f"gated slice {case}: non-finite loss")
        for name, n in want.items():
            if counts.get(name) != n:
                fail(f"gated slice {case}: {name}: {counts.get(name)} "
                     f"launches in a step, expected {n}")
        del gpu, opt
    emit({"phase": "gated_slice", "batch": 4, "cases": out})


def phase_train_entry(dev):
    """The training entry point at the published stage-1 configuration
    (``configs/config_vae_humanml3d.yaml``: d 256, 9 + 9 layers, batch 64)
    through ``run_training``, the function ``ladiff_torch.train`` calls, on
    512 synthetic clips in a temporary directory, bf16 compute
    (``TRAIN.MIXED_PRECISION``), the whole-layer route
    (``LADIFF_TRAIN_WHOLE_LAYER=1``): 2 epochs of 3 steps with a checkpoint
    per epoch, a resume that runs epoch 2 (``END_EPOCH`` 3); then stage 2
    (``configs/config_ladiff_humanml3d.yaml``, batch 128) booting the VAE
    from that checkpoint directory, 3 steps; then ``ladiff_torch.demo``'s
    main on the stage-2 checkpoint for the 3 default examples.  Returns the
    launch counts of the stage-1 runs."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from ladiff_torch import demo
    from ladiff_torch.config import assemble_config
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.data.synthetic import generate_synthetic_dataset
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.loop import run_training
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint)
    from ladiff_torch.utils.logger import create_logger

    tmp = tempfile.mkdtemp(prefix="ladiff_train_entry_")
    configs = os.path.join(HERE, "configs")
    assets = os.path.join(configs, "assets.yaml")
    t_start = time.perf_counter()
    try:
        data = generate_synthetic_dataset(os.path.join(tmp, "humanml3d"),
                                          n_clips=512, seed=0)
        base = {"DEBUG": False, "FOLDER": os.path.join(tmp, "experiments"),
                "DATASET": {"HUMANML3D": {"ROOT": data}},
                "LOGGER": {"SACE_CHECKPOINT_EPOCH": 1,
                           "TENSORBOARD": False}}

        def stage(name, train, steps, epochs=None):
            over = {**base, "TRAIN": {"MIXED_PRECISION": True, **train}}
            cfg = assemble_config(os.path.join(configs, name), assets, over)
            logger = create_logger(cfg, phase="train")
            dm = get_datasets(cfg, phase="train")[0]
            cc.reset_launch_counts()
            ckpt = run_training(cfg, dm, logger, max_epochs=epochs,
                                max_steps_per_epoch=steps, device=dev)
            torch.cuda.synchronize()
            with open(os.path.join(cfg.FOLDER_EXP, "metrics.jsonl")) as f:
                lines = [json.loads(line) for line in f]
            return cfg, ckpt, cc.launch_counts(), lines

        os.environ["LADIFF_TRAIN_WHOLE_LAYER"] = "1"
        cfg1, ckpt1, c1, _ = stage("config_vae_humanml3d.yaml", {}, 3, 2)
        files = sorted(os.listdir(ckpt1))
        cfg_r, _, c_r, lines = stage("config_vae_humanml3d.yaml",
                                     {"RESUME": "1", "END_EPOCH": 3}, 3)
        os.environ.pop("LADIFF_TRAIN_WHOLE_LAYER")
        epochs = [rec["step"] for rec in lines]
        stage1 = {k: c1[k] + c_r[k] for k in c1}
        per_step = {k: stage1[k] / 9 for k in EXPECTED_WHOLE_LAYER_PER_STEP}
        cfg2, ckpt2, c2, lines2 = stage(
            "config_ladiff_humanml3d.yaml",
            {"PRETRAINED_VAE": ckpt1, "END_EPOCH": 1}, 3)
        e1, sd1 = load_checkpoint(latest_checkpoint(ckpt1)[1])
        e2, sd2 = load_checkpoint(latest_checkpoint(ckpt2)[1])
        vae_booted = all(torch.equal(sd2[k], v) for k, v in sd1.items())
        out_dir = demo.main(
            ["--cfg", os.path.join(configs, "config_ladiff_humanml3d.yaml"),
             "--cfg_assets", assets, "--out_dir",
             os.path.join(tmp, "samples")], device=dev,
            overrides={**base, "TEST": {"CHECKPOINTS": ckpt2}})
        joints = [np.load(os.path.join(out_dir, f"sample_{i:03d}.npy"))
                  for i in range(len(demo.DEFAULT_EXAMPLES))]
        rec = {"phase": "train_entry", "batch_stage1": cfg1.TRAIN.BATCH_SIZE,
               "batch_stage2": cfg2.TRAIN.BATCH_SIZE,
               "checkpoints_stage1": files,
               "resume_epochs_logged": epochs,
               "stage1_losses": [l["train/vae/total"] for l in lines],
               "stage2_losses": [l["train/diffusion/total"]
                                 for l in lines2],
               "launches_per_stage1_step": per_step,
               "launches_stage2": {k: c2[k] / 3 for k in
                                   EXPECTED_PER_DIFFUSION_STEP},
               "stage2_checkpoint_epoch": e2, "vae_booted_from": e1,
               "vae_booted": vae_booted,
               "joints_shapes": [list(j.shape) for j in joints],
               "joints_finite": all(bool(np.isfinite(j).all())
                                    for j in joints),
               "seconds": time.perf_counter() - t_start}
        emit(rec)
    finally:
        os.environ.pop("LADIFF_TRAIN_WHOLE_LAYER", None)
        shutil.rmtree(tmp, ignore_errors=True)
    if files != ["epoch_1.ckpt", "epoch_2.ckpt"]:
        fail(f"train_entry: stage-1 checkpoints {files}")
    if epochs != [0, 1, 2]:
        fail(f"train_entry: the resume did not start at epoch 2: {epochs}")
    for name, want in EXPECTED_WHOLE_LAYER_PER_STEP.items():
        if per_step[name] != want:
            fail(f"train_entry: {name}: {per_step[name]} launches per "
                 f"stage-1 step, expected {want}")
    for name, want in EXPECTED_PER_DIFFUSION_STEP.items():
        if rec["launches_stage2"][name] != want:
            fail(f"train_entry: {name}: {rec['launches_stage2'][name]} "
                 f"launches per stage-2 step, expected {want}")
    losses = rec["stage1_losses"] + rec["stage2_losses"]
    if not (vae_booted and e1 == 3 and all(map(math.isfinite, losses))):
        fail("train_entry: stage 2 did not boot the stage-1 VAE, or a loss "
             "is not finite")
    want_shapes = [[n, 22, 3] for n, _ in demo.DEFAULT_EXAMPLES]
    if rec["joints_shapes"] != want_shapes or not rec["joints_finite"]:
        fail(f"train_entry: demo joints {rec['joints_shapes']}, finite="
             f"{rec['joints_finite']}")
    return stage1


def phase_float32_entry(dev):
    """The published configurations as shipped (``TRAIN.MIXED_PRECISION``
    false): float32 compute on the card through every module's plain
    route.  ``configs/config_vae_humanml3d.yaml`` through ``run_training``
    on 512 synthetic clips, 2 epochs x 3 steps at its batch of 64, with no
    kernel launch; its loss on one batch (the eval-mode forward under
    autograd, dropout off, the same weights and latent noise) against the
    CPU float32 forward within ``FLOAT32_LOSS_TOL``; float32 ms per step
    at the configuration's batch beside the bf16 route's (the same
    configuration with ``MIXED_PRECISION`` true), 5 timed steps after 2;
    then ``configs/config_ladiff_humanml3d.yaml`` (stage 2, batch 128)
    booting the VAE from those checkpoints for 3 steps, with no kernel
    launch either."""
    import shutil
    import tempfile

    import torch
    from ladiff_torch import train_bench
    from ladiff_torch.config import assemble_config
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.data.synthetic import generate_synthetic_dataset
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.loop import build_system, run_training
    from ladiff_torch.training.trainer import make_optimizer, vae_train_step
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint)
    from ladiff_torch.utils.logger import create_logger

    tmp = tempfile.mkdtemp(prefix="ladiff_float32_entry_")
    configs = os.path.join(HERE, "configs")
    assets = os.path.join(configs, "assets.yaml")
    t_start = time.perf_counter()
    try:
        data = generate_synthetic_dataset(os.path.join(tmp, "humanml3d"),
                                          n_clips=512, seed=0)
        base = {"DEBUG": False, "FOLDER": os.path.join(tmp, "experiments"),
                "DATASET": {"HUMANML3D": {"ROOT": data}},
                "LOGGER": {"SACE_CHECKPOINT_EPOCH": 1,
                           "TENSORBOARD": False}}

        def config(name, **train):
            over = {**base, "TRAIN": train} if train else base
            return assemble_config(os.path.join(configs, name), assets, over)

        def stage(cfg, steps, epochs=None):
            logger = create_logger(cfg, phase="train")
            dm = get_datasets(cfg, phase="train")[0]
            cc.reset_launch_counts()
            ckpt = run_training(cfg, dm, logger, max_epochs=epochs,
                                max_steps_per_epoch=steps, device=dev)
            torch.cuda.synchronize()
            launches = sum(cc.launch_counts().values())
            with open(os.path.join(cfg.FOLDER_EXP, "metrics.jsonl")) as f:
                lines = [json.loads(line) for line in f]
            return dm, ckpt, launches, lines

        cfg1 = config("config_vae_humanml3d.yaml")
        mixed = bool(cfg1.TRAIN.get("MIXED_PRECISION", False))
        dm, ckpt1, launches1, lines1 = stage(cfg1, 3, 2)
        files = sorted(os.listdir(ckpt1))

        # one batch on the card and on the CPU, the same weights and noise
        B = int(cfg1.TRAIN.BATCH_SIZE)
        gpu = build_system(cfg1, dm, device=dev)
        cpu = build_system(cfg1, dm, device="cpu")
        same_weights = all(torch.equal(v.cpu(), cpu.state_dict()[k])
                           for k, v in gpu.state_dict().items())
        g = torch.Generator().manual_seed(7)
        batch = train_bench.make_batch(batch=B)
        eps = torch.randn(B, gpu.max_it, gpu.latent_dim[-1], generator=g)
        cc.reset_launch_counts()
        with torch.enable_grad():
            loss_g, _ = gpu.vae_forward(
                {k: v.to(dev) for k, v in batch.items()}, train=False,
                eps=eps.to(dev))
            loss_g.backward()
        grad_norm = float(torch.sqrt(sum(
            (p.grad.float() ** 2).sum() for p in gpu.vae.parameters()
            if p.grad is not None)))
        torch.cuda.synchronize()
        launches_batch = sum(cc.launch_counts().values())
        with torch.no_grad():
            loss_c, _ = cpu.vae_forward(batch, train=False, eps=eps)
        loss_g = loss_g.detach()
        loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
        del cpu

        def ms_per_step(system, n=5, warmup=2):
            opt = make_optimizer(system.vae.parameters(), 1e-4)
            b = {k: v.to(dev) for k, v in batch.items()}
            for i in range(warmup + n):
                if i == warmup:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                vae_train_step(system, opt, b)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        cc.reset_launch_counts()
        ms_f32 = ms_per_step(gpu)
        launches_steps = sum(cc.launch_counts().values())
        del gpu
        torch.cuda.empty_cache()
        bf = build_system(config("config_vae_humanml3d.yaml",
                                 MIXED_PRECISION=True), dm, device=dev)
        ms_bf16 = ms_per_step(bf)
        del bf
        torch.cuda.empty_cache()
        print(f"# float32_entry: {B} samples per step, float32 "
              f"{ms_f32:.2f} ms/step, bf16 {ms_bf16:.2f} ms/step",
              flush=True)

        cfg2 = config("config_ladiff_humanml3d.yaml",
                      PRETRAINED_VAE=ckpt1, END_EPOCH=1)
        _, ckpt2, launches2, lines2 = stage(cfg2, 3)
        e1, sd1 = load_checkpoint(latest_checkpoint(ckpt1)[1])
        _, sd2 = load_checkpoint(latest_checkpoint(ckpt2)[1])
        vae_booted = all(torch.equal(sd2[k], v) for k, v in sd1.items())
        rec = {"phase": "float32_entry",
               "mixed_precision_in_config": mixed,
               "batch_stage1": B, "batch_stage2": cfg2.TRAIN.BATCH_SIZE,
               "checkpoints_stage1": files,
               "stage1_losses": [l["train/vae/total"] for l in lines1],
               "stage2_losses": [l["train/diffusion/total"]
                                 for l in lines2],
               "kernel_launches": {"stage1_run": launches1,
                                   "parity_batch": launches_batch,
                                   "timed_steps": launches_steps,
                                   "stage2_run": launches2},
               "same_weights": same_weights,
               "loss_card": float(loss_g), "loss_cpu": float(loss_c),
               "loss_rel_err": loss_err, "loss_tol": FLOAT32_LOSS_TOL,
               "grad_norm": grad_norm,
               "ms_per_step": {"float32": ms_f32, "bf16": ms_bf16},
               "vae_booted": vae_booted,
               "seconds": time.perf_counter() - t_start}
        emit(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if mixed:
        fail("float32_entry: the published stage-1 configuration asks for "
             "mixed precision")
    if files != ["epoch_1.ckpt", "epoch_2.ckpt"]:
        fail(f"float32_entry: stage-1 checkpoints {files}")
    if any(rec["kernel_launches"].values()):
        fail(f"float32_entry: kernels launched in float32: "
             f"{rec['kernel_launches']}")
    if not (same_weights and loss_err <= FLOAT32_LOSS_TOL
            and math.isfinite(grad_norm)):
        fail(f"float32_entry: loss {float(loss_g)} on the card against "
             f"{float(loss_c)} on the CPU (rel err {loss_err}), same "
             f"weights {same_weights}, grad norm {grad_norm}")
    losses = rec["stage1_losses"] + rec["stage2_losses"]
    if not (vae_booted and e1 == 2 and all(map(math.isfinite, losses))):
        fail("float32_entry: stage 2 did not boot the stage-1 VAE, or a "
             "loss is not finite")


class _ClipCalls:
    """A text encoder that counts its calls (each runs K3 and K4 once per
    CLIP layer in bf16 on the card)."""

    def __init__(self, encoder):
        self.encoder, self.calls = encoder, 0

    def __call__(self, texts):
        self.calls += 1
        return self.encoder(texts)


def phase_eval_entry(dev, gpu=""):
    """The T2M evaluation protocol through ``ladiff_torch.test.run_test``,
    the function ``python -m ladiff_torch.test`` calls, at the published
    stage-2 configuration (``configs/config_ladiff_humanml3d.yaml``: d 256,
    9 + 9 layers, CFG 7.5 DDIM-50, ``TEST.BATCH_SIZE`` 32) on 512 synthetic
    clips (66 in the test split: batches of 32, 32 and 2), from a seeded
    random system saved as a checkpoint and restored, random CLIP (seed 0)
    and random evaluators (no ``finest.tar``).  Reduced:
    ``REPLICATION_TIMES`` 2 (published 20), ``MM_NUM_SAMPLES`` 11
    (published 100; the protocol computes MultiModality only above
    ``MM_NUM_TIMES`` = 10 captions), ``MM_NUM_REPEATS`` 30 as published;
    ``COUNT_TIME`` on.

    (a) float32, as published: on the card and on the CPU, the same
    checkpoint and seed, no kernel launch; each metric within
    ``EVAL_METRIC_TOL`` relative, FID within ``EVAL_FID_TOL``.  (b) bf16
    (``TRAIN.MIXED_PRECISION``), stage ``diffusion``: launches exactly
    ``EXPECTED_EVAL_PER_BATCH`` per eval batch (the MultiModality pass's
    included) and ``EXPECTED_EVAL_PER_CLIP_CALL`` per CLIP call, no other
    kernel; the generated motion's embeddings within ``EVAL_BF16_TOL`` of
    (a)'s; every metric finite.  (c) bf16, stage ``vae``
    (``configs/config_vae_humanml3d.yaml`` from the same checkpoint):
    ``EXPECTED_EVAL_VAE_PER_BATCH`` per eval batch.  Prints the seconds per
    eval batch, per replication and per MultiModality pass of each run with
    the card's name and power limit, and for each run on the card its
    first eval batch again after the run: device ms by kernel (profiler)
    and the idle share against its host ms."""
    import logging
    import shutil
    import tempfile

    import torch
    from ladiff_torch import test as entry
    from ladiff_torch.config import assemble_config
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.data.synthetic import generate_synthetic_dataset
    from ladiff_torch.evaluation import t2m_eval
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.loop import build_system, build_text_encoder
    from ladiff_torch.utils.checkpoint import save_checkpoint
    from ladiff_torch.utils.logger import create_logger

    tmp = tempfile.mkdtemp(prefix="ladiff_eval_entry_")
    configs = os.path.join(HERE, "configs")
    assets = os.path.join(configs, "assets.yaml")
    ckpt_dir = os.path.join(tmp, "checkpoints")
    t_start = time.perf_counter()
    real_step = t2m_eval.eval_step
    seen = {"batches": 0, "lat_rm": []}

    def counted_step(*args, **kw):
        out = real_step(*args, **kw)
        seen["batches"] += 1
        seen["lat_rm"].append(out["lat_rm"].float().cpu())
        if seen["batches"] == 1:
            seen["first"] = (args, kw)
        return out

    def step_breakdown():
        """The run's first eval batch (32 samples) again, after the run and
        its counts: host ms per call (3 calls, a sync each), device ms by
        kernel from the profiler, the idle share between them."""
        args, kw = seen.pop("first")

        def call():
            real_step(*args, **kw)
            torch.cuda.synchronize()

        call()
        t0 = time.perf_counter()
        for _ in range(3):
            call()
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        rows = launch_breakdown(call, reps=2)
        device = sum(r["ms"] for r in rows)
        return {"host_ms": host_ms, "device_ms": device,
                "idle_share": 1.0 - device / host_ms, "kernels": rows[:8]}

    class Spans(logging.Handler):
        def __init__(self):
            super().__init__()
            self.spans = {"replication": [], "mm_pass": []}

        def emit(self, record):
            if hasattr(record, "span"):
                self.spans[record.span].append(record.seconds)

    t2m_eval.eval_step = counted_step
    try:
        data = generate_synthetic_dataset(os.path.join(tmp, "humanml3d"),
                                          n_clips=512, seed=0)
        base = {"DEBUG": False, "FOLDER": os.path.join(tmp, "experiments"),
                "DATASET": {"HUMANML3D": {"ROOT": data}},
                "TEST": {"REPLICATION_TIMES": 2, "MM_NUM_SAMPLES": 11,
                         "COUNT_TIME": True, "CHECKPOINTS": ckpt_dir},
                "model": {"t2m_path": os.path.join(tmp, "t2m")},
                "LOGGER": {"TENSORBOARD": False}}

        def config(name, exp, mixed):
            over = {**base, "NAME": exp,
                    "TRAIN": {"MIXED_PRECISION": mixed}}
            return assemble_config(os.path.join(configs, name), assets, over)

        cfg32 = config("config_ladiff_humanml3d.yaml", "eval_f32_card", False)
        dm = get_datasets(cfg32, phase="test")[0]
        n_test = len(dm.dataset("test"))
        system = randomize_(build_system(cfg32, dm, device="cpu"), 13)
        save_checkpoint(ckpt_dir, 1, system.state_dict())
        del system

        def run(cfg, device):
            spans = Spans()
            logger = create_logger(cfg, phase="test")
            logger.addHandler(spans)
            enc = _ClipCalls(build_text_encoder(cfg, device))
            seen.update(batches=0, lat_rm=[])
            cc.reset_launch_counts()
            t0 = time.perf_counter()
            summary = entry.run_test(cfg, logger, text_encoder=enc,
                                     device=device)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = cc.launch_counts()
            with open(os.path.join(cfg.FOLDER_EXP, "times.txt")) as f:
                batch_s = [float(line) for line in f]
            on_card = torch.device(device).type == "cuda"
            return {"summary": summary, "counts": counts,
                    "breakdown": step_breakdown() if on_card else None,
                    "eval_batches": seen["batches"],
                    "clip_calls": enc.calls,
                    "lat_rm": torch.cat(seen["lat_rm"]),
                    "batch_s": batch_s,
                    "replication_s": spans.spans["replication"],
                    "mm_pass_s": spans.spans["mm_pass"], "seconds": secs}

        f32_card = run(cfg32, dev)
        f32_cpu = run(config("config_ladiff_humanml3d.yaml", "eval_f32_cpu",
                             False), "cpu")
        bf16 = run(config("config_ladiff_humanml3d.yaml", "eval_bf16", True),
                   dev)
        vae = run(config("config_vae_humanml3d.yaml", "eval_vae_bf16", True),
                  dev)
    finally:
        t2m_eval.eval_step = real_step
        shutil.rmtree(tmp, ignore_errors=True)

    card, cpu = f32_card["summary"], f32_cpu["summary"]
    f32_errs = {k: abs(card[k][0] - cpu[k][0]) / max(abs(cpu[k][0]), 1e-12)
                for k in cpu if k in card}

    def public(r):
        return {"launches": {k: v for k, v in r["counts"].items() if v},
                "eval_batches": r["eval_batches"],
                "clip_calls": r["clip_calls"],
                "seconds_per_eval_batch": r["batch_s"],
                "seconds_per_replication": r["replication_s"],
                "seconds_per_mm_pass": r["mm_pass_s"],
                "seconds": r["seconds"], "batch_breakdown": r["breakdown"],
                "metrics": {k: v[0] for k, v in r["summary"].items()}}

    rec = {"phase": "eval_entry", "gpu": gpu, "test_clips": n_test,
           "replications": 2, "mm_num_samples": 11, "mm_num_repeats": 30,
           "float32_card": public(f32_card), "float32_cpu": public(f32_cpu),
           "bf16_diffusion": public(bf16), "bf16_vae": public(vae),
           "float32_metric_rel_err": f32_errs,
           "float32_lat_rm_rel_err": relerr(f32_card["lat_rm"],
                                            f32_cpu["lat_rm"]),
           "bf16_lat_rm_rel_err": relerr(bf16["lat_rm"], f32_card["lat_rm"]),
           "seconds": time.perf_counter() - t_start}
    emit(rec)
    for name, r in (("float32 card", f32_card), ("float32 CPU", f32_cpu),
                    ("bf16 diffusion", bf16), ("bf16 vae", vae)):
        main_s = r["batch_s"]
        print(f"# eval_entry {name}: {sum(main_s) / len(main_s):.4f} s per "
              f"eval batch ({len(main_s)} batches of up to 32), "
              + ", ".join(f"{t:.3f}" for t in r["replication_s"])
              + " s per replication, "
              + (("MultiModality pass " + ", ".join(
                  f"{t:.3f}" for t in r["mm_pass_s"]) + " s")
                 if r["mm_pass_s"] else "no MultiModality pass")
              + f"; {gpu}", flush=True)
        b = r["breakdown"]
        if b:
            print(f"# eval_entry {name}: one batch of 32 again: "
                  f"{b['device_ms']:.2f} device ms in {b['host_ms']:.2f} ms "
                  f"(idle {b['idle_share']:.0%}); "
                  + ", ".join(f"{k['kernel'][:40]} {k['ms']:.2f}"
                              for k in b["kernels"][:4]), flush=True)

    if sorted(card) != sorted(cpu) or not {"FID", "MultiModality",
                                           "R_precision_top_1"} <= set(card):
        fail(f"eval_entry: metrics {sorted(card)} on the card, {sorted(cpu)} "
             "on the CPU")
    for k, err in f32_errs.items():
        if err > (EVAL_FID_TOL if k == "FID" else EVAL_METRIC_TOL):
            fail(f"eval_entry: float32 {k}: {card[k][0]} on the card, "
                 f"{cpu[k][0]} on the CPU (rel err {err})")
    for name, r in (("float32 card", f32_card), ("float32 CPU", f32_cpu)):
        if any(r["counts"].values()):
            fail(f"eval_entry: {name} launched kernels: "
                 f"{public(r)['launches']}")
    for name, r, per_batch in (("bf16 diffusion", bf16,
                                EXPECTED_EVAL_PER_BATCH),
                               ("bf16 vae", vae, EXPECTED_EVAL_VAE_PER_BATCH)):
        want = {k: n * r["eval_batches"] for k, n in per_batch.items()}
        want.update({k: n * r["clip_calls"]
                     for k, n in EXPECTED_EVAL_PER_CLIP_CALL.items()})
        got = {k: v for k, v in r["counts"].items() if v}
        if got != want:
            fail(f"eval_entry: {name}: launches {got}, expected {want} "
                 f"({r['eval_batches']} eval batches, {r['clip_calls']} CLIP "
                 "calls)")
        if not all(math.isfinite(m) and math.isfinite(c)
                   for m, c in r["summary"].values()):
            fail(f"eval_entry: {name}: a metric is not finite")
    if rec["bf16_lat_rm_rel_err"] > EVAL_BF16_TOL:
        fail(f"eval_entry: bf16 generated motion's embeddings "
             f"{rec['bf16_lat_rm_rel_err']} away from float32's")
    return rec


def phase_whole_layer_bench(dev):
    """``train_bench``'s ``vae_train`` protocol (batch 128, dropout 0.1) on
    the split route (kernels 8 and 9) and the whole-layer route (kernels
    12 and 13) in turns, split, whole, whole, split: ms per step and
    samples/s of each, launch counts per step of the whole-layer route."""
    import torch
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc

    iters = 10
    runs = {"0": [], "1": []}
    counts = None
    for route in ("0", "1", "1", "0"):
        system, opt = train_bench.build(dev, train_whole_layer=route)
        batch = train_bench.make_batch(device=system.device)
        cc.reset_launch_counts()
        res = train_bench.measure(system, opt, batch, iters=iters)
        if route == "1":
            counts = {k: v / (train_bench.WARMUP + iters)
                      for k, v in cc.launch_counts().items()}
        if not (math.isfinite(res["loss"])
                and math.isfinite(res["grad_norm"])):
            fail(f"whole-layer bench, route {route}: non-finite loss")
        runs[route].append(res["ms_per_step"])
        del system, opt, batch
        torch.cuda.empty_cache()
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    emit({"phase": "whole_layer_bench", "batch": train_bench.BATCH,
          "dropout": train_bench.DROPOUT, "steps_per_run": iters,
          "ms_per_step_runs": {"split": runs["0"], "whole_layer": runs["1"]},
          "ms_per_step": {"split": ms["0"], "whole_layer": ms["1"]},
          "samples_per_sec": {"split": train_bench.BATCH / ms["0"] * 1e3,
                              "whole_layer": train_bench.BATCH / ms["1"]
                              * 1e3},
          "launches_per_step_whole_layer": counts})
    for name, want in EXPECTED_WHOLE_LAYER_PER_STEP.items():
        if counts.get(name) != want:
            fail(f"whole-layer bench: {name}: {counts.get(name)} launches "
                 f"per step, expected {want}")


def phase_whole_layer_kernels(dev):
    """Kernels 12 and 13 at the stage-1 configuration's shapes: 64 x 206
    encoder rows (10 distribution tokens and 196 frames), 64 x 196 decoder
    rows with 5 memory rows of which 1 to 5 are valid, mixed lengths.  Each
    against its float32 plain version on the same bf16 inputs, at dropout 0
    and at 0.1 with the masks the kernel draws, every gradient on its own
    (the memory's too), timed at batch 64; compared again at batch 128
    (``train_bench``'s) and at batch 3 (a partial last row block).  The
    library times are ``torch.nn.TransformerEncoderLayer`` /
    ``TransformerDecoderLayer`` in training mode with the same weights,
    masks and dropout rate: the forward under autograd, and
    ``torch.autograd.grad`` of a retained forward for the input, the
    memory and every parameter (timed here only; the port never calls
    them)."""
    import torch
    from ladiff_torch.ops.train_decoder_layer import (
        train_decoder_layer_bwd, train_decoder_layer_bwd_plain,
        train_decoder_layer_fwd, train_decoder_layer_masks,
        train_decoder_layer_plain)
    from ladiff_torch.ops.train_layer import (
        train_encoder_layer_bwd, train_encoder_layer_bwd_plain,
        train_encoder_layer_fwd, train_encoder_layer_masks,
        train_encoder_layer_plain)
    from ladiff_torch.ops.transformer import (TransformerDecoderLayer,
                                              TransformerEncoderLayer)
    from ladiff_torch.utils.masks import latent_valid_mask, lengths_to_mask

    bf = torch.bfloat16
    D, H, F, L, T, RATE = 256, 4, 1024, 5, 196, 0.1
    SEED = 0x5EED5EED5EED
    S = T + 2 * L
    g = torch.Generator().manual_seed(12)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, bf)

    def f32(p):
        return {k: v.float() for k, v in p.items()}

    def flat(dx, *rest):
        """(dx, grads) or (dx, dmem, grads) as one {name: tensor}."""
        return {"dx": dx, **({"dmem": rest[0]} if len(rest) == 2 else {}),
                **rest[-1]}

    def torch_layer(cls, layer):
        """``cls`` (a torch.nn layer) in training mode with ``layer``'s
        weights."""
        lib = cls(D, H, F, dropout=RATE, activation="gelu",
                  batch_first=True, norm_first=False).to(dev, bf).train()
        lib.load_state_dict(layer.state_dict())
        return lib

    def library_fwd_bwd(forward, wrt, dout):
        """(forward under autograd, the gradient of one retained forward
        in ``wrt``'s tensors and modules' parameters)."""
        leaves = [p for w in wrt for p in (
            w.parameters() if isinstance(w, torch.nn.Module) else [w])]
        with torch.enable_grad():
            out = forward()

        def fwd():
            with torch.enable_grad():
                return forward()
        return fwd, lambda: torch.autograd.grad(out, leaves, dout,
                                                retain_graph=True)

    enc = randomize_(TransformerEncoderLayer(D, H, F, "gelu"), 33).to(dev, bf)
    dec = randomize_(TransformerDecoderLayer(D, H, F, "gelu"), 34).to(dev, bf)
    pe = {k: v.detach() for k, v in enc.kernel_params().items()}
    pd = {k: v.detach() for k, v in dec.kernel_params().items()}
    pe_bytes, pd_bytes = nbytes(*pe.values()), nbytes(*pd.values())
    recs, errs = [], {}

    for B in (64, 128, 3):
        lengths = mixed_lengths(B, seed=B)
        lat = latent_valid_mask(lengths, 48, L)
        ev = torch.cat([lat, lat, lengths_to_mask(lengths, T)], dim=1)
        dv = lengths_to_mask(lengths, T)
        Me, Md = B * S, B * T
        kve = ev.reshape(Me).float().to(dev).contiguous()
        kvd = dv.reshape(Md).float().to(dev).contiguous()
        mvalid = lat.float().to(dev).contiguous()
        xe, doute = rnd(Me, D), rnd(Me, D, scale=0.1)
        xd, doutd = rnd(Md, D), rnd(Md, D, scale=0.1)
        mem = rnd(B, L, D)
        case = {}
        for rate in (0.0, RATE):
            kw = dict(H=H, S=S, rate=rate, seed=SEED)
            me = (train_encoder_layer_masks(B, S, D, H, F, rate, SEED, dev)
                  if rate else None)
            out, saved = train_encoder_layer_fwd(xe, kve, pe,
                                                 return_saved=True, **kw)
            e_f = compare(f"train_encoder_layer B {B} rate {rate}", out,
                          train_encoder_layer_plain(xe.float(), kve, f32(pe),
                                                    me, H=H, S=S),
                          KERNEL_TOL)[0]
            e_b = compare(f"train_encoder_layer_bwd B {B} rate {rate}",
                          flat(*train_encoder_layer_bwd(xe, kve, doute, pe,
                                                        saved, **kw)),
                          flat(*train_encoder_layer_bwd_plain(
                              xe.float(), kve, doute.float(), f32(pe), me,
                              H=H, S=S)), GRAD_TOL)[0]
            del out, saved, me
            kw["S"] = T
            md = (train_decoder_layer_masks(B, T, L, D, H, F, rate, SEED, dev)
                  if rate else None)
            out, saved = train_decoder_layer_fwd(xd, kvd, mem, mvalid, pd,
                                                 return_saved=True, **kw)
            d_f = compare(f"train_decoder_layer B {B} rate {rate}", out,
                          train_decoder_layer_plain(
                              xd.float(), kvd, mem.float(), mvalid, f32(pd),
                              md, H=H, S=T), KERNEL_TOL)[0]
            d_b = compare(f"train_decoder_layer_bwd B {B} rate {rate}",
                          flat(*train_decoder_layer_bwd(
                              xd, kvd, mem, mvalid, doutd, pd, saved, **kw)),
                          flat(*train_decoder_layer_bwd_plain(
                              xd.float(), kvd, mem.float(), mvalid,
                              doutd.float(), f32(pd), md, H=H, S=T)),
                          GRAD_TOL)[0]
            del out, saved, md
            case[f"rate {rate}"] = {"enc_fwd": e_f, "enc_bwd": e_b,
                                    "dec_fwd": d_f, "dec_bwd": d_b}
        errs[f"batch {B}"] = case
        if B != 64:
            continue
        # timed at the stage-1 batch, dropout 0.1, against the plain
        # version given the kernel's masks.  Needed work: every query
        # against its sample's valid keys (and valid memory rows)
        kw = dict(H=H, rate=RATE, seed=SEED)
        lib_e = torch_layer(torch.nn.TransformerEncoderLayer, enc)
        xle = xe.reshape(B, S, D).detach().requires_grad_(True)
        pad_e = ~ev.to(dev)
        lib_e_fwd, lib_e_bwd = library_fwd_bwd(
            lambda: lib_e(xle, src_key_padding_mask=pad_e), [xle, lib_e],
            doute.reshape(B, S, D))
        me = train_encoder_layer_masks(B, S, D, H, F, RATE, SEED, dev)
        meb = tuple(m.to(bf) for m in me)
        nv_e = int(ev.sum())
        fl_ef = (2 * Me * D * 3 * D + 2 * Me * D * D + 4 * D * S * nv_e
                 + 4 * Me * D * F)
        fl_eb = (2 * (2 * Me * D * D + 2 * Me * D * 3 * D)
                 + 8 * D * S * nv_e + 8 * Me * D * F)
        recs.append(check_kernel(
            "train_encoder_layer", "ladiff_torch/csrc/train_layer.cu",
            "ladiff_tpu/ops/pallas_train_layer.py:207",
            lambda: train_encoder_layer_fwd(xe, kve, pe, S=S, **kw),
            lambda: train_encoder_layer_plain(xe.float(), kve, f32(pe), me,
                                              H=H, S=S),
            lambda: train_encoder_layer_plain(xe, kve, pe, meb, H=H, S=S),
            fl_ef, nbytes(xe, kve, xe) + pe_bytes, library=lib_e_fwd,
            extra={"rate": RATE, "rows": Me}))
        _, saved = train_encoder_layer_fwd(xe, kve, pe, S=S,
                                           return_saved=True, **kw)
        # kernel 12's launches one by one, forward then backward
        emit({"phase": "whole_layer_breakdown",
              "kernel": "train_encoder_layer", "rows": Me, "rate": RATE,
              "fwd": launch_breakdown(
                  lambda: train_encoder_layer_fwd(xe, kve, pe, S=S, **kw)),
              "bwd": launch_breakdown(
                  lambda: train_encoder_layer_bwd(xe, kve, doute, pe, saved,
                                                  S=S, **kw))})
        recs.append(check_kernel(
            "train_encoder_layer_bwd", "ladiff_torch/csrc/train_layer.cu",
            "ladiff_tpu/ops/pallas_train_layer.py:207",
            lambda: flat(*train_encoder_layer_bwd(xe, kve, doute, pe, saved,
                                                  S=S, **kw)),
            lambda: flat(*train_encoder_layer_bwd_plain(
                xe.float(), kve, doute.float(), f32(pe), me, H=H, S=S)),
            lambda: train_encoder_layer_bwd_plain(xe, kve, doute, pe, meb,
                                                  H=H, S=S),
            fl_eb, nbytes(xe, kve, doute, xe) + 3 * pe_bytes,
            library=lib_e_bwd, tol=GRAD_TOL,
            extra={"rate": RATE, "rows": Me}))
        del me, meb, saved, lib_e, lib_e_fwd, lib_e_bwd
        lib_d = torch_layer(torch.nn.TransformerDecoderLayer, dec)
        xld = xd.reshape(B, T, D).detach().requires_grad_(True)
        meml = mem.detach().requires_grad_(True)
        pad_d, pad_m = ~dv.to(dev), ~lat.to(dev)
        lib_d_fwd, lib_d_bwd = library_fwd_bwd(
            lambda: lib_d(xld, meml, tgt_key_padding_mask=pad_d,
                          memory_key_padding_mask=pad_m),
            [xld, meml, lib_d], doutd.reshape(B, T, D))
        md = train_decoder_layer_masks(B, T, L, D, H, F, RATE, SEED, dev)
        mdb = tuple(m.to(bf) for m in md)
        nv_d, nv_m = int(dv.sum()), int(lat.sum())
        fl_df = (2 * Md * D * 3 * D + 2 * Md * D * D + 4 * D * T * nv_d
                 + 2 * Md * D * D + 2 * B * L * D * 2 * D + 4 * D * T * nv_m
                 + 2 * Md * D * D + 4 * Md * D * F)
        fl_db = (2 * (2 * Md * D * D + 2 * Md * D * 3 * D)
                 + 8 * D * T * nv_d + 2 * (2 * Md * D * D) * 2
                 + 2 * (2 * B * L * D * 2 * D) + 8 * D * T * nv_m
                 + 8 * Md * D * F)
        recs.append(check_kernel(
            "train_decoder_layer", "ladiff_torch/csrc/train_decoder_layer.cu",
            "ladiff_tpu/ops/pallas_train_decoder_layer.py:410",
            lambda: train_decoder_layer_fwd(xd, kvd, mem, mvalid, pd, S=T,
                                            **kw),
            lambda: train_decoder_layer_plain(xd.float(), kvd, mem.float(),
                                              mvalid, f32(pd), md, H=H, S=T),
            lambda: train_decoder_layer_plain(xd, kvd, mem, mvalid, pd, mdb,
                                              H=H, S=T),
            fl_df, nbytes(xd, kvd, mem, mvalid, xd) + pd_bytes,
            library=lib_d_fwd, extra={"rate": RATE, "rows": Md, "memory_rows": L}))
        _, saved = train_decoder_layer_fwd(xd, kvd, mem, mvalid, pd, S=T,
                                           return_saved=True, **kw)
        recs.append(check_kernel(
            "train_decoder_layer_bwd",
            "ladiff_torch/csrc/train_decoder_layer.cu",
            "ladiff_tpu/ops/pallas_train_decoder_layer.py:410",
            lambda: flat(*train_decoder_layer_bwd(
                xd, kvd, mem, mvalid, doutd, pd, saved, S=T, **kw)),
            lambda: flat(*train_decoder_layer_bwd_plain(
                xd.float(), kvd, mem.float(), mvalid, doutd.float(), f32(pd),
                md, H=H, S=T)),
            lambda: train_decoder_layer_bwd_plain(xd, kvd, mem, mvalid, doutd,
                                                  pd, mdb, H=H, S=T),
            fl_db, nbytes(xd, kvd, mem, mvalid, doutd, xd, mem)
            + 3 * pd_bytes, library=lib_d_bwd, tol=GRAD_TOL,
            extra={"rate": RATE, "rows": Md, "memory_rows": L}))
        _, saved = train_decoder_layer_fwd(xd, kvd, mem, mvalid, pd, S=T,
                                           return_saved=True, **kw)
        # kernel 13's launches one by one, forward then backward
        emit({"phase": "whole_layer_breakdown",
              "kernel": "train_decoder_layer", "rows": Md, "rate": RATE,
              "fwd": launch_breakdown(
                  lambda: train_decoder_layer_fwd(xd, kvd, mem, mvalid, pd,
                                                  S=T, **kw)),
              "bwd": launch_breakdown(
                  lambda: train_decoder_layer_bwd(xd, kvd, mem, mvalid,
                                                  doutd, pd, saved, S=T,
                                                  **kw))})
        del md, mdb, saved, lib_d, lib_d_fwd, lib_d_bwd
    # kernel 13 at 3 x 40 rows: a 64-row block holds rows of three
    # samples; 8 memory rows, of which 1, 8 and 5 are valid
    B3, T3, L3 = 3, 40, 8
    lens3 = torch.tensor([40, 23, 7])
    kv3 = lengths_to_mask(lens3, T3).reshape(-1).float().to(dev)
    mv3 = (torch.arange(L3)[None] < torch.tensor([[1], [8], [5]])).float() \
        .to(dev)
    x3, dout3, mem3 = rnd(B3 * T3, D), rnd(B3 * T3, D, scale=0.1), \
        rnd(B3, L3, D)
    case = {}
    for rate in (0.0, RATE):
        kw = dict(H=H, S=T3, rate=rate, seed=SEED)
        m3 = (train_decoder_layer_masks(B3, T3, L3, D, H, F, rate, SEED, dev)
              if rate else None)
        out, saved = train_decoder_layer_fwd(x3, kv3, mem3, mv3, pd,
                                             return_saved=True, **kw)
        d_f = compare(f"train_decoder_layer 3 x 40 rate {rate}", out,
                      train_decoder_layer_plain(
                          x3.float(), kv3, mem3.float(), mv3, f32(pd), m3,
                          H=H, S=T3), KERNEL_TOL)[0]
        d_b = compare(f"train_decoder_layer_bwd 3 x 40 rate {rate}",
                      flat(*train_decoder_layer_bwd(
                          x3, kv3, mem3, mv3, dout3, pd, saved, **kw)),
                      flat(*train_decoder_layer_bwd_plain(
                          x3.float(), kv3, mem3.float(), mv3, dout3.float(),
                          f32(pd), m3, H=H, S=T3)), GRAD_TOL)[0]
        case[f"rate {rate}"] = {"dec_fwd": d_f, "dec_bwd": d_b}
    errs["3 x 40 rows, 8 memory rows"] = case
    # the memory gradient is summed without atomics: two runs, equal bits
    # (at the last batch's 3 x 196 rows, and at 3 x 40 rows)
    same_bits = True
    for args, S_ in (((xd, kvd, mem, mvalid), T), ((x3, kv3, mem3, mv3), T3)):
        out, saved = train_decoder_layer_fwd(*args, pd, H=H, S=S_, rate=RATE,
                                             seed=SEED, return_saved=True)
        dout_ = doutd if S_ == T else dout3
        runs = [train_decoder_layer_bwd(*args, dout_, pd, saved, H=H, S=S_,
                                        rate=RATE, seed=SEED)[1]
                for _ in range(2)]
        same_bits = same_bits and bool(torch.equal(runs[0], runs[1]))
    emit({"phase": "whole_layer_kernels", "worst_rel_err": errs,
          "tol": KERNEL_TOL, "grad_tol": GRAD_TOL,
          "dmem_same_bits_twice": same_bits})
    if not same_bits:
        fail("train_decoder_layer_bwd: the memory gradient differs between "
             "two runs")
    return recs


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after the build "
                    "(e.g. whole_layer_kernels) for a short check; the "
                    "default runs every phase and ends with the ok line")
    only = [p for p in ap.parse_args().only.split(",") if p]
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

    gpu = phase_build()
    unknown = set(only) - {name for name, _ in PHASES}
    if unknown:
        fail(f"no phase {sorted(unknown)}")
    out = {}
    for name, grad in PHASES:
        if only and name not in only:
            continue
        # the route bench prints the default route's samples/s beside its own
        args = ((out["bench"][1],) if name == "route_bench" and "bench" in out
                else (gpu,) if name == "eval_entry" else ())
        with torch.set_grad_enabled(grad):
            out[name] = globals()[f"phase_{name}"](dev, *args)
    if only:
        emit({"phases_run": only})
        return
    recs, (counts, _) = out["kernels"], out["bench"]
    route_recs = out["route_kernels"]
    route_counts, train_recs = out["route_bench"], out["train_kernels"]
    whole_recs, train_counts = out["whole_layer_kernels"], out["train_bench"]
    diffusion_counts, entry_counts = out["diffusion_bench"], out["train_entry"]
    # each kernel's launches on the path that runs it: generation for K1-K4,
    # the stage-1 training steps and their validation pass for kernels 5, 8
    # and 9, the stage-2 and joint steps for kernel 10 and for kernel 9 as
    # the MD sa_block's tail; the stack route for
    # kernel 11, the full-context route for kernel 6 and for kernel 5 as
    # the MD sa_block's tail, the one-token route at head width 256 for
    # kernel 7 (per batch); the training entry point's stage-1 runs on the
    # whole-layer route for kernels 12 and 13
    for rec in recs:
        rec["launches"] = counts[rec["name"]]
    counts_by_route = route_counts["counts"]
    route_path = {"fused_md_stack": counts_by_route["md_stack"],
                  "fused_stylized_ffn": counts_by_route["full_context"],
                  "fused_postnorm_ffn": counts_by_route["full_context"],
                  "fused_broadcast_stylize":
                      route_counts["per_batch"]["one_token_h1"]}
    for rec in route_recs:
        rec["launches"] = route_path[rec["name"]][rec["name"]]
    recs += route_recs
    for rec in train_recs:
        path = (diffusion_counts if rec["name"] == "fused_masked_attention"
                or rec.get("path") == KERNEL9_MD_PATH else train_counts)
        rec["launches"] = path[rec["name"]]
    recs += train_recs
    for rec in whole_recs:
        rec["launches"] = entry_counts[rec["name"]]
    recs += whole_recs
    for rec in recs:
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
