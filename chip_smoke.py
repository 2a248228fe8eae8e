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
   novae_slice  feature-space diffusion (``configs/config_novae_humanml3d
            .yaml``: no VAE, the plain 9-layer skip denoiser at d 512 over
            198 tokens) at full width, batch 4, lengths 16/60/123/196, CFG
            DDPM over 10 steps of the 1000-step grid with every step's
            noise handed in: float32 card against float32 CPU (no launch),
            bf16 card against it beside the plain bf16 CPU control, kernel
            10 exactly 9 times a step and nothing else.
   novae_bench  the same configuration in bf16 at its ``TEST.BATCH_SIZE``
            of 32 over the published 1000 DDPM steps after a 50-step
            warm-up: seconds a batch, samples/s, 9000 launches of kernel
            10 a batch; a profiled 50-step window (device ms by group, idle
            share); kernel 10 alone at 64 x 198 tokens, D 512, head width
            128, unmasked, against its plain version, with SDPA's time.

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
            demo's joints; the demo's other options on the card with their
            launch counts (``EXPECTED_DEMO``: ``random_latent``,
            ``reconstruction``, ``--latentwise_gen fw`` / ``bw``, the
            decode with the cross-attention weights against the float32
            CPU's); the novae configuration as published (float32) for 3
            steps with no launch.
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
            ``vae``, launches per eval batch; (d) the novae configuration
            as published (float32), one replication at 50 DDPM steps (1000
            published), no launch.  Seconds per eval batch, per
            replication and per MultiModality pass.
17. kit_slice  the KIT-ML configuration (``config_ladiff_kit.yaml``, 251
            features, 21 joints) at full width: generation at batch 4
            (float32 card against CPU with no launch, bf16 beside the
            plain bf16 control), a stage-1 and a stage-2 pass against the
            CPU, one bench batch of 256 with ``EXPECTED_PER_BATCH``.
18. ar_slice  ``ARDIFF`` generation at batch 4, "last" and "full", each
            token's noise replayed (float32 card against CPU, bf16 beside
            the control, exact launches); K1 alone at 512 samples of 2 and
            6 stream rows; one AR training pass against the CPU.
19. ar_bench  the bench protocol with ``ARDIFF`` ("last"): seconds a
            batch, ``EXPECTED_AR_PER_BATCH``, a batch's device ms by group
            and idle share.
20. distill_slice / distill_bench  one distill pass at batch 4 against
            the CPU (teacher booted from a checkpoint written there); 10
            steps at batch 128 (ms, samples/s, peak memory, device ms by
            group, idle share, ``EXPECTED_DISTILL_PER_STEP``),
            ``run_training`` stage ``distill`` for 3 steps, the student
            sampled at guidance 1 (``EXPECTED_STUDENT_PER_BATCH``).
21. action_slice  the action family (``config_ladiff_humanact12.yaml``:
            the 6-layer ActorVae, the 15-layer plain denoiser, the synthetic
            SMPL body and HumanAct12 data) at full width, batch 4:
            generation from action tokens (CFG DDIM-10: float32 card
            against CPU with no launch, bf16 beside the plain bf16 control,
            exact launches), a stage-1 pass with the SMPL-vertex loss on
            the split and the whole-layer routes and a stage-2 pass held to
            the control with exact launches (``EXPECTED_ACTION_*``), a
            UESTC batch through the ST-GCN and the GRU card against CPU, K2
            alone at 32 x 60 frames against one memory row.
22. action_bench  an evaluation batch of 32 (CFG DDIM-50, decode, SMPL
            joints, GRU; ``EXPECTED_ACTION_EVAL_PER_BATCH``, device ms by
            group, idle share), 5 stage-1 steps at batch 128 on each route,
            3 stage-2 steps at batch 64, ``run_test`` on the HumanAct12 and
            UESTC configurations as published at one replication, and K2,
            kernels 5, 8, 9, 12 and 13 at the action path's shapes beside
            their plain versions, bounds and library calls.

Then a ``kernels`` line (kernel 10 twice: on the frozen encode's path and
on the novae path, launches a DDPM-1000 batch; K2 and kernels 5, 8, 9, 12
and 13 again at the action path's shapes, with its launches), and last
``{"ok": true,
"device": {...}}``.
``--only PHASE[,PHASE]`` runs the build and the named phases alone (a short
check of a new kernel, or ``--only novae_slice,novae_bench``) and prints no
``ok`` line.
Imports nothing of JAX; needs one CUDA device.
"""
from __future__ import annotations

import dataclasses
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
# feature-space diffusion (the novae configuration): each denoising step
# runs the 9 plain encoder layers' self-attention over 198 tokens (time,
# text, 196 frames) at head width 128 as kernel 10; d 512 is past kernel
# 5's FFN-tail gate, so the tails are plain ops, and nothing else launches
EXPECTED_NOVAE_PER_STEP = {"fused_masked_attention": 9}
EXPECTED_NOVAE_PER_BATCH = {"fused_masked_attention": 9000}
NOVAE_PATH = ("novae denoiser self-attention, 64 x 198 tokens, D 512, "
              "H 4 (head width 128), no mask")
# the demo's other options on the published stage-2 configuration (bf16 on
# the card): every decode is the 9 decoder layers as K2; the
# reconstruction's encode runs the 9 encoder layers (kernel 10, kernel 5);
# a decode that returns the cross-attention weights runs per block
# (kernel 10 the self-attention, kernel 5 the tail, the plain
# cross-attention)
EXPECTED_DEMO = {
    "random_latent": {"fused_decoder_layer": 9},
    "reconstruction": {"fused_decoder_layer": 9, "fused_masked_attention": 9,
                       "fused_postnorm_ffn": 9},
    "latentwise_fw": {"fused_decoder_layer": 9},
    "latentwise_bw": {"fused_decoder_layer": 9},
    "decode_with_weights": {"fused_masked_attention": 9,
                            "fused_postnorm_ffn": 9}}
# the phases in the order they run, each with whether autograd records
PHASES = (("kernels", False), ("slice", False), ("bench", False),
          ("route_kernels", False), ("route_slice", False),
          ("route_bench", False), ("novae_slice", False),
          ("novae_bench", False), ("train_kernels", False),
          ("whole_layer_kernels", False), ("train_slice", True),
          ("whole_layer_slice", True), ("gated_slice", True),
          ("train_bench", True), ("whole_layer_bench", True),
          ("diffusion_slice", True), ("diffusion_bench", True),
          ("train_entry", True), ("float32_entry", True),
          ("eval_entry", False), ("kit_slice", True), ("ar_slice", True),
          ("ar_bench", False), ("distill_slice", True),
          ("distill_bench", True), ("action_slice", True),
          ("action_bench", True))


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def relerr(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _device_window(fn, reps: int):
    """One profiled window of ``reps`` calls of ``fn``: (device ms a call,
    device kernels recorded).  The profiler traces a warm-up step of
    ``reps`` calls and keeps only the second step's: while tracing starts
    a window's first launches can go unrecorded.  Late in the whole script
    it also loses records at random (on an H100, every window of kernel 9's
    20 launches recorded 7), so each kernel counts at its mean recorded
    time times its launches a call, ``round(recorded / reps)`` and at
    least 1: launches are the same in every call, and a window that
    records them all reads its plain sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    per_call_us, n = 0.0, 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            per_call_us += t / ev.count * max(1, round(ev.count / reps))
            n += ev.count
    return per_call_us / 1e3, n


def device_ms(fn, reps: int = 20) -> float:
    """Milliseconds of device time per call of ``fn``: the sum of its CUDA
    kernels' time from the profiler (``_device_window``; host overhead
    excluded).  A window can
    come back empty after a long profiled session (seen on an H100 after
    the full-context breakdown's, and at the first cuBLAS timing of
    ``clip_breakdown``), so an empty one is taken again; fails when five
    record no device time."""
    for _ in range(5):
        ms, n = _device_window(fn, reps)
        if n:
            return ms
    fail("the profiler recorded no device time in five windows")


def interleaved_ms(fns, rounds: int = 5, reps: int = 20):
    """Device ms per call of each of ``fns``, timed in turn ``rounds``
    times after 10 warm-up calls each (``_device_window``s of ``reps``
    calls, an empty one taken again up to 5 times; a kernel and its plain
    version see the same state of the card).  A window can lose some of
    its launches' events (on an H100 one window of kernel 5's 20 launches
    recorded 1): only the windows that recorded the most kernels count.
    Returns (the median of each over those windows, every window's (ms,
    kernels recorded) of each)."""
    import torch
    for fn in fns:
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    reads = [[] for _ in fns]
    for _ in range(rounds):
        for fn, r in zip(fns, reads):
            for _ in range(5):
                r.append(_device_window(fn, reps))
                if r[-1][1]:
                    break
    meds = []
    for r in reads:
        most = max(n for _, n in r)
        if not most:
            fail("the profiler recorded no device time in an interleaved "
                 "timing")
        full = sorted(ms for ms, n in r if n == most)
        meds.append(full[len(full) // 2])
    return meds, reads


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
                 run_timed=None, extra=None, rounds=0):
    """Kernel vs its plain version (float32, same bf16 inputs): error,
    times, bound.  ``run_timed`` is what is timed where it differs from
    what is compared.  ``rounds`` > 0 times the kernel, its plain version
    and the library call in turn (``interleaved_ms``): the medians, and
    every round's readings on the line.  Returns the kernel's record."""
    import torch
    tol = KERNEL_TOL if tol is None else tol
    got = run_kernel()
    torch.cuda.synchronize()
    err, max_abs, errs = compare(name, got, run_plain_f32(), tol)
    del got
    timed = [run_timed or run_kernel, run_plain] + (
        [library] if library is not None else [])
    if rounds:
        meds, reads = interleaved_ms(timed, rounds)
    else:
        meds, reads = [device_ms(fn) for fn in timed], None
    ms, plain_ms = meds[:2]
    lib_ms = meds[2] if library is not None else None
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
    if reads:
        line.update(ms_rounds=reads[0], plain_ms_rounds=reads[1],
                    library_ms_rounds=reads[2] if lib_ms is not None
                    else None)
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


def _novae_config():
    """``configs/config_novae_humanml3d.yaml`` as published."""
    from ladiff_torch.config import assemble_config
    configs = os.path.join(HERE, "configs")
    return assemble_config(os.path.join(configs,
                                        "config_novae_humanml3d.yaml"),
                           os.path.join(configs, "assets.yaml"))


def _novae_system(device, dtype=None, seed=31, state=None):
    """The published novae system (d 512, 9 plain layers, no VAE) on
    ``device``: random weights from ``seed`` (the zero-init projections
    too), or ``state``."""
    from ladiff_torch.models.ladiff import LADiffSystem
    system = LADiffSystem.from_cfg(_novae_config(), nfeats=263, njoints=22,
                                   device=device, dtype=dtype)
    if state is None:
        return randomize_(system, seed)
    system.load_state_dict(state, strict=True)
    return system


def phase_novae_slice(dev):
    """Feature-space diffusion (the novae family) at the published
    configuration's full width, random weights: batch 4, lengths 16 / 60 /
    123 / 196, CFG 7.5 DDPM over 10 steps of the 1000-step grid, the
    initial frames handed in and every step's noise replayed through a
    patched ``torch.randn``.  float32 on the card (every plain route)
    against float32 on the CPU within ``FLOAT32_LOSS_TOL``, with no launch; bf16 on the card (kernel 10 the
    self-attention of each of the 9 layers) against the float32 CPU run,
    norm-wise, held to ``DIFF_GRAD_RATIO`` times the plain bf16 CPU
    control's error (or ``DIFF_GRAD_FLOOR``), with exactly
    ``EXPECTED_NOVAE_PER_STEP`` launches a step and none of any other
    kernel; padded frames exactly zero."""
    from unittest import mock

    import torch
    from ladiff_torch.ops import cuda_common as cc

    B, steps = 4, 10
    lengths = torch.tensor([16, 60, 123, 196])
    g = torch.Generator().manual_seed(9)
    cond = torch.randn(B, 1, 768, generator=g)
    uncond = 0.1 * torch.randn(B, 1, 768, generator=g)
    init = torch.randn(B, 196, 263, generator=g)
    noise = torch.randn(steps, B, 196, 263, generator=g)
    cpu = _novae_system("cpu", torch.float32)
    state = cpu.state_dict()

    def run(system, on_card):
        # the sampler's per-step draws replayed in order, each on the
        # device and in the dtype it asks for
        draws = list(noise)
        cc.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(torch, "randn", lambda *a, **k: draws.pop(
                0).to(device=k["device"], dtype=k["dtype"])):
            z, _ = system.generate(cond, uncond, lengths, init_latents=init,
                                   num_inference_timesteps=steps)
        if on_card:
            torch.cuda.synchronize()
        if draws:
            fail(f"novae_slice: {len(draws)} of the {steps} step draws "
                 "unused")
        return (z.float().cpu(), time.perf_counter() - t0,
                {k: v for k, v in cc.launch_counts().items() if v})

    want, cpu_s, _ = run(cpu, False)
    del cpu
    ctl, ctl_s, _ = run(_novae_system("cpu", torch.bfloat16, state=state),
                        False)
    f32, f32_s, f32_counts = run(_novae_system(dev, torch.float32,
                                               state=state), True)
    bf16, bf16_s, bf16_counts = run(_novae_system(dev, state=state), True)
    ctl_err = relerr(ctl, want)
    bf16_tol = max(DIFF_GRAD_RATIO * ctl_err, DIFF_GRAD_FLOOR)
    want_counts = {k: n * steps for k, n in EXPECTED_NOVAE_PER_STEP.items()}
    rec = {"phase": "novae_slice", "batch": B, "steps": steps,
           "lengths": lengths.tolist(),
           "float32_rel_err": relerr(f32, want), "float32_tol":
           FLOAT32_LOSS_TOL, "float32_launches": f32_counts,
           "bf16_rel_err": relerr(bf16, want),
           "bf16_control_rel_err": ctl_err, "bf16_tol": bf16_tol,
           "bf16_launches": bf16_counts,
           "padded_frames_zero": all(
               not bool(z[i, n:].any()) for z in (f32, bf16)
               for i, n in enumerate(lengths.tolist())),
           "finite": bool(torch.isfinite(bf16).all()),
           "seconds": {"cpu_float32": cpu_s, "cpu_bf16_control": ctl_s,
                       "card_float32": f32_s, "card_bf16": bf16_s}}
    emit(rec)
    if rec["float32_rel_err"] > FLOAT32_LOSS_TOL or f32_counts:
        fail(f"novae_slice: float32 on the card {rec['float32_rel_err']} "
             f"from the CPU, launches {f32_counts}")
    if not (rec["bf16_rel_err"] <= bf16_tol and rec["finite"]
            and rec["padded_frames_zero"]):
        fail(f"novae_slice: bf16 {rec['bf16_rel_err']} from float32 "
             f"(control {ctl_err}), finite={rec['finite']}, padded frames "
             f"zero={rec['padded_frames_zero']}")
    if bf16_counts != want_counts:
        fail(f"novae_slice: launches {bf16_counts}, expected {want_counts}")


# device-time groups of a novae denoising step (profiler kernel names)
NOVAE_GROUPS = (
    ("fused_masked_attention (kernel 10)", r"attn_tile_kernel"),
    ("library GEMMs", r"gemm|cutlass|nvjet|cublas|xmma"),
    ("LayerNorm (plain FFN tail, skip stack)", r"layer_norm|LayerNorm"),
    ("GELU (plain FFN tail)", r"gelu|GeluCUDA"),
    ("memcpy and memset", r"[Mm]emcpy|[Mm]emset"),
    ("other ATen kernels (sampler, CFG, adds, casts, concat)", r""),
)


def phase_novae_bench(dev, gpu=""):
    """The novae configuration's generation at full width in bf16: batch
    32 (its ``TEST.BATCH_SIZE``), lengths 16..196, CFG 7.5 DDPM over the
    published 1000 steps; one warm-up batch of 50 steps, then 2 timed
    batches (host clock, a sync each): seconds a batch, samples/s, and
    exactly ``EXPECTED_NOVAE_PER_BATCH`` launches a batch.  A 50-step
    window profiled (device ms by group, ``NOVAE_GROUPS``) against the same
    window unprofiled (the idle share).  Kernel 10 alone at the path's
    shape, 64 x 198 tokens, D 512, 4 heads (head width 128), no mask:
    against its float32 plain version, timed beside its plain bf16
    version and SDPA.  Returns (kernel 10's record, launches a batch)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.ops.attention_kernel import (fused_masked_attention,
                                                   masked_attention_plain)

    B, batches, steps = 32, 2, 1000
    system = _novae_system(dev)
    lengths = mixed_lengths(B, seed=3).to(dev)
    g = torch.Generator().manual_seed(11)
    cond = torch.randn(B, 1, 768, generator=g).to(dev)
    uncond = torch.zeros(B, 1, 768, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)

    def window(n):
        return system.generate(cond, uncond, lengths, generator=gen,
                               num_inference_timesteps=n)[0]

    window(50)
    torch.cuda.synchronize()
    cc.reset_launch_counts()
    secs, finite = [], True
    for _ in range(batches):
        t0 = time.perf_counter()
        z = window(steps)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(z).all())
    total = {k: v for k, v in cc.launch_counts().items() if v}
    counts = {k: v // batches for k, v in total.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window(50)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window(50)
        torch.cuda.synchronize()
    groups = {name: 0.0 for name, _ in NOVAE_GROUPS}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0:
            name = next(n for n, pat in NOVAE_GROUPS if re.search(pat, ev.key))
            groups[name] += us / 1e3
    window_ms = sum(groups.values())
    rec = {"phase": "novae_bench", "gpu": gpu, "batch": B, "steps": steps,
           "seconds_per_batch": secs,
           "samples_per_sec": [B / s for s in secs],
           "launches_per_batch": counts, "finite": finite,
           "window_steps": 50, "window_host_ms": host_ms,
           "window_device_ms": window_ms,
           "idle_share": 1.0 - window_ms / host_ms,
           "window_device_ms_by_group": groups}
    emit(rec)
    print(f"# novae_bench: {sum(secs) / batches:.3f} s a batch of {B} "
          f"({B * batches / sum(secs):.2f} samples/s), 50 steps "
          f"{window_ms:.1f} device ms in {host_ms:.1f} ms (idle "
          f"{rec['idle_share']:.0%}); {gpu}", flush=True)
    if not finite:
        fail("novae_bench: non-finite frames")
    if window_ms <= 0:
        fail("novae_bench: the profiler recorded no device time")
    if total != {k: n * batches for k, n in EXPECTED_NOVAE_PER_BATCH.items()}:
        fail(f"novae_bench: launches in {batches} batches {total}, expected "
             f"{EXPECTED_NOVAE_PER_BATCH} a batch")
    del system

    # kernel 10 alone at the path's shape: the 2 x 32 guided rows of 198
    # tokens (time, text, 196 frames), every key valid
    S, D, H = 198, 512, 4
    rg = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn(2 * B, S, D, generator=rg, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    heads = lambda a: a.reshape(2 * B, S, H, D // H).transpose(1, 2)
    qf, kf, vf = q.float(), k.float(), v.float()
    plain_f32_ms = device_ms(
        lambda: masked_attention_plain(qf, kf, vf, None, num_heads=H))
    del qf, kf, vf
    k10 = check_kernel(
        "fused_masked_attention", "ladiff_torch/csrc/masked_attention.cu",
        "ladiff_tpu/ops/pallas_attention.py:52",
        lambda: fused_masked_attention(q, k, v, None, num_heads=H),
        lambda: masked_attention_plain(q.float(), k.float(), v.float(),
                                       None, num_heads=H),
        lambda: masked_attention_plain(q, k, v, None, num_heads=H),
        4 * D * S * S * 2 * B, nbytes(q, k, v, q),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            heads(q), heads(k), heads(v)),
        extra={"path": NOVAE_PATH, "plain_float32_ms": plain_f32_ms})
    k10["path"] = NOVAE_PATH
    return k10, counts


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
    main on the stage-2 checkpoint for the 3 default examples, and each of
    its other options once (``demo_options``); then the novae
    configuration (``configs/config_novae_humanml3d.yaml``, float32 as
    published, batch 64) for 3 steps with no launch and a checkpoint
    without ``vae.*``.  Returns the launch counts of the stage-1 runs."""
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
        demo_rec = _demo_options(dev, tmp, base, ckpt2)
        over = {**base, "TRAIN": {"END_EPOCH": 1}}
        cfg_n = assemble_config(os.path.join(
            configs, "config_novae_humanml3d.yaml"), assets, over)
        cc.reset_launch_counts()
        ckpt_n = run_training(cfg_n, get_datasets(cfg_n, phase="train")[0],
                              create_logger(cfg_n, phase="train"),
                              max_steps_per_epoch=3, device=dev)
        torch.cuda.synchronize()
        novae_counts = {k: v for k, v in cc.launch_counts().items() if v}
        en, sdn = load_checkpoint(latest_checkpoint(ckpt_n)[1])
        with open(os.path.join(cfg_n.FOLDER_EXP, "metrics.jsonl")) as f:
            novae_losses = [json.loads(line)["train/diffusion/total"]
                            for line in f]
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
               "demo_options": demo_rec,
               "novae": {"batch": cfg_n.TRAIN.BATCH_SIZE, "epoch": en,
                         "losses": novae_losses, "launches": novae_counts,
                         "vae_keys": sum(k.startswith("vae.") for k in sdn)},
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
    n = rec["novae"]
    if (n["launches"] or n["vae_keys"] or n["epoch"] != 1
            or not n["losses"] or not all(map(math.isfinite, n["losses"]))):
        fail(f"train_entry: novae {n}")
    return stage1


def _demo_options(dev, tmp, base, ckpt):
    """``ladiff_torch.demo``'s other options on the card from the stage-2
    checkpoint ``ckpt`` (bf16): ``random_latent``, ``reconstruction`` of a
    196-frame clip beside the example, ``--latentwise_gen fw`` and ``bw``
    (on ``random_latent``: MAX_IT samples per line), each with exactly
    ``EXPECTED_DEMO``'s launches and finite joints of its lengths; then
    the decode with the cross-attention weights (what ``--plot_att_map``
    draws; the drawing is left out, so the run needs no matplotlib): its
    launches, and each decoder layer's weights against the float32 CPU's
    within ``KERNEL_TOL``."""
    import numpy as np
    import torch
    from ladiff_torch import demo
    from ladiff_torch.config import assemble_config
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint)

    configs = os.path.join(HERE, "configs")
    cfg_path = os.path.join(configs, "config_ladiff_humanml3d.yaml")
    assets = os.path.join(configs, "assets.yaml")
    over = {**base, "TEST": {"CHECKPOINTS": ckpt}}
    example = os.path.join(tmp, "clip.txt")
    with open(example, "w") as f:
        f.write("196 a person walks forward\n")
    np.save(os.path.join(tmp, "clip.npy"), (0.5 * np.random.RandomState(
        14).randn(196, 263)).astype(np.float32))
    n_ex = len(demo.DEFAULT_EXAMPLES)
    cases = {"random_latent": (["--task", "random_latent"], n_ex, None),
             "reconstruction": (["--task", "reconstruction", "--example",
                                 example], 1, 196),
             "latentwise_fw": (["--task", "random_latent",
                                "--latentwise_gen", "fw"], 5 * n_ex, None),
             "latentwise_bw": (["--task", "random_latent",
                                "--latentwise_gen", "bw"], 5 * n_ex, None)}
    out = {}
    for name, (args, n, length) in cases.items():
        cc.reset_launch_counts()
        out_dir = demo.main(["--cfg", cfg_path, "--cfg_assets", assets,
                             "--out_dir", os.path.join(tmp, name), *args],
                            device=dev, overrides=over)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cc.launch_counts().items() if v}
        files = sorted(f for f in os.listdir(out_dir) if f.endswith(".npy"))
        joints = [np.load(os.path.join(out_dir, f)) for f in files]
        ok = (len(files) == n and all(np.isfinite(j).all() for j in joints)
              and (length is None or all(len(j) == length for j in joints)))
        out[name] = {"launches": counts, "samples": len(files),
                     "files_ok": bool(ok)}
        if counts != EXPECTED_DEMO[name] or not ok:
            fail(f"demo {name}: {out[name]}, expected launches "
                 f"{EXPECTED_DEMO[name]} and {n} samples")

    cfg = assemble_config(cfg_path, assets, over)
    _, sd = load_checkpoint(latest_checkpoint(ckpt)[1])
    systems = {}
    for where, dt in (("cpu", torch.float32), (dev, None)):
        s = LADiffSystem.from_cfg(cfg, nfeats=263, njoints=22, device=where,
                                  dtype=dt)
        s.load_state_dict(sd, strict=True)
        systems[str(where)] = s
    g = torch.Generator().manual_seed(15)
    z = torch.randn(3, 5, 256, generator=g)
    lengths = torch.tensor([196, 120, 64])
    with torch.no_grad():
        _, want = systems["cpu"].vae.decode(z, lengths, 196,
                                            return_cross_weights=True)
        cc.reset_launch_counts()
        _, got = systems[str(dev)].vae.decode(
            z.to(dev, torch.bfloat16), lengths.to(dev), 196,
            return_cross_weights=True)
        torch.cuda.synchronize()
    counts = {k: v for k, v in cc.launch_counts().items() if v}
    errs = [compare(f"decoder layer {i}'s cross-attention weights",
                    w.float().cpu(), wc, KERNEL_TOL)[0]
            for i, (w, wc) in enumerate(zip(got, want))]
    out["decode_with_weights"] = {"launches": counts, "layers": len(got),
                                  "weights_rel_err": errs,
                                  "tol": KERNEL_TOL}
    if counts != EXPECTED_DEMO["decode_with_weights"] or len(got) != 9:
        fail(f"demo decode with weights: {out['decode_with_weights']}")
    return out


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
    ``EXPECTED_EVAL_VAE_PER_BATCH`` per eval batch.  (d) the novae
    configuration (``configs/config_novae_humanml3d.yaml``, float32 as
    published: feature-space diffusion, no VAE) from a seeded random
    checkpoint of its own, reduced to ``REPLICATION_TIMES`` 1 and
    ``num_inference_timesteps`` 50 (published 1000: 1000 steps of the
    MultiModality pass alone would take minutes), ``MM_NUM_SAMPLES`` 11:
    no launch, every metric finite.  Prints the seconds per
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
        ckpt_novae = os.path.join(tmp, "checkpoints_novae")
        cfg_n = assemble_config(
            os.path.join(configs, "config_novae_humanml3d.yaml"), assets,
            {**base, "NAME": "eval_novae_f32",
             "TEST": {**base["TEST"], "REPLICATION_TIMES": 1,
                      "CHECKPOINTS": ckpt_novae},
             "model": {**base["model"],
                       "scheduler": {"num_inference_timesteps": 50}}})
        save_checkpoint(ckpt_novae, 1, randomize_(build_system(
            cfg_n, dm, device="cpu"), 17).state_dict())
        novae = run(cfg_n, dev)
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
           "float32_novae": public(novae),
           "float32_metric_rel_err": f32_errs,
           "float32_lat_rm_rel_err": relerr(f32_card["lat_rm"],
                                            f32_cpu["lat_rm"]),
           "bf16_lat_rm_rel_err": relerr(bf16["lat_rm"], f32_card["lat_rm"]),
           "seconds": time.perf_counter() - t_start}
    emit(rec)
    for name, r in (("float32 card", f32_card), ("float32 CPU", f32_cpu),
                    ("bf16 diffusion", bf16), ("bf16 vae", vae),
                    ("float32 novae (50 steps)", novae)):
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
    for name, r in (("float32 card", f32_card), ("float32 CPU", f32_cpu),
                    ("float32 novae", novae)):
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
    if not ({"FID", "MultiModality", "R_precision_top_1"}
            <= set(novae["summary"]) and all(
                math.isfinite(m) for m, _ in novae["summary"].values())):
        fail(f"eval_entry: novae metrics {novae['summary']}")
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


# -- the KIT-ML family, autoregressive latent diffusion and the distill
#    stage --------------------------------------------------------------------

# AR generation a batch on the bench protocol ("last", 196 frames: every
# sample has 5 tokens): 5 tokens x 50 DDIM steps x 9 MD layers as K1 at
# T = 2 stream rows, then the decode and the CLIP call, as the default route
EXPECTED_AR_PER_BATCH = {"fused_md_layer": 2250, "fused_decoder_layer": 9,
                         "fused_ln_qkv": 12, "fused_proj_mlp": 12,
                         "fused_md_stack": 0, "fused_postnorm_ffn": 0,
                         "fused_stylized_ffn": 0,
                         "fused_broadcast_stylize": 0}
# one distill step: the frozen encode (kernels 10 and 5, 9 layers), two
# guided teacher calls of 9 MD layers as K1 (2B samples, an AdaLN row per
# sample), the student's 9 training-mode MD layers (kernel 9 the ReLU tail
# of each sa_block, forward and backward; plain 7-key attention)
EXPECTED_DISTILL_PER_STEP = {
    "fused_masked_attention": 9, "fused_postnorm_ffn": 9,
    "fused_md_layer": 18, "train_postnorm_ffn": 9,
    "train_postnorm_ffn_bwd": 9, "train_self_attention": 0,
    "train_self_attention_bwd": 0, "fused_decoder_layer": 0,
    "fused_md_stack": 0}
# a distilled student sampled at guidance 1 over its 25 steps: 9 K1
# launches a step at B (no doubled batch), the decode
EXPECTED_STUDENT_PER_BATCH = {"fused_md_layer": 225,
                              "fused_decoder_layer": 9}
AR_K1_PATH = ("AR denoiser layer, 512 samples x {T} stream rows "
              "(motion_conditioning {mode}), E 2")
# device-time groups of a distill step (profiler kernel names)
DISTILL_GROUPS = (
    ("fused_md_layer (teacher, K1)", r"md_layer_kernel"),
    ("fused_masked_attention (frozen encode, kernel 10)", r"attn_tile_kernel"),
    ("fused_postnorm_ffn (frozen encode, kernel 5)",
     r"ffn_tail_fwd_kernel<\d+, false"),
    ("train_postnorm_ffn fwd (student, kernel 9)", r"ffn_tail_fwd_kernel"),
    ("train_postnorm_ffn bwd (student, kernel 9) and weight gradients",
     r"ffn_tail_bwd_kernel|ladiff::(wgrad|colsum|reduce)_kernel"),
    ("AdamW", r"multi_tensor_apply|[Aa]dam"),
    ("library GEMMs", r"gemm|cutlass|nvjet|cublas"),
    ("memcpy and memset", r"[Mm]emcpy|[Mm]emset"),
    ("other ATen kernels", r""),
)


def _config(name, **over):
    """A published configuration with ``over`` merged on top."""
    from ladiff_torch.config import assemble_config
    configs = os.path.join(HERE, "configs")
    return assemble_config(os.path.join(configs, name),
                           os.path.join(configs, "assets.yaml"),
                           over or None)


def _from_cfg(cfg, device, dtype=None, param_dtype=None, state=None,
              seed=None, nfeats=263, njoints=22, **kw):
    """``LADiffSystem.from_cfg`` on ``device`` with unit feature statistics,
    random weights from ``seed`` or ``state``; ``kw`` are further run
    options (``train_whole_layer``)."""
    import numpy as np
    from ladiff_torch.models.ladiff import LADiffSystem
    system = LADiffSystem.from_cfg(
        cfg, nfeats=nfeats, njoints=njoints,
        mean=np.zeros(nfeats, np.float32), std=np.ones(nfeats, np.float32),
        device=device, dtype=dtype, param_dtype=param_dtype, **kw)
    if state is not None:
        system.load_state_dict(state, strict=True)
    elif seed is not None:
        randomize_(system, seed)
    return system


def _loss_grads(system, forward):
    """``forward()``'s loss terms (floats) and every gradient it gives
    (float32, on the CPU)."""
    system.zero_grad(set_to_none=True)
    total, (logs, _) = forward()
    total.backward()
    return ({k: float(v.detach()) for k, v in logs.items()},
            {n: p.grad.detach().float().cpu()
             for n, p in system.named_parameters() if p.grad is not None})


def _held_to_control(name, run, cpu, ctl, gpu, hold_grads=True, refs=None,
                     watch=()):
    """``run(system)`` -> (loss terms, gradients) on the float32 CPU system,
    the plain bf16 CPU control and the card: each of the card's gradient
    tensors held to ``DIFF_GRAD_RATIO`` times the control's error for it
    (at least ``DIFF_GRAD_FLOOR``; printed only without ``hold_grads``),
    each loss term to ``DIFF_LOSS_TOL``.  ``refs``: the CPU's and the
    control's results where the caller has them (``cpu`` and ``ctl`` are
    then not run).  The record gives the median of the card's error over
    the control's across the tensors, the three largest, and those of the
    tensors named in ``watch``.  Returns the record."""
    import numpy as np
    import torch
    if refs is None:
        refs = run(cpu), run(ctl)
    logs_c, grads_c = refs[0]
    rec, errs = {"logs_cpu": logs_c, "grad_ratio": DIFF_GRAD_RATIO,
                 "grad_floor": DIFF_GRAD_FLOOR}, {}
    for who, result in (("cpu_bf16_plain", lambda: refs[1]),
                        ("card", lambda: run(gpu))):
        logs, grads = result()
        if set(grads) != set(grads_c):
            fail(f"{name}: other parameters have gradients than on the CPU: "
                 f"{sorted(set(grads) ^ set(grads_c))[:5]}")
        if not all(bool(torch.isfinite(t).all()) for t in grads.values()):
            fail(f"{name}: a gradient is not finite ({who})")
        errs[who] = {n: relerr(grads[n], w) for n, w in grads_c.items()}
        worst = max(errs[who], key=errs[who].get)
        rec[who] = {"loss_rel_errs": {k: abs(logs[k] - w) / abs(w)
                                      for k, w in logs_c.items()},
                    "worst_grad_rel_err": errs[who][worst],
                    "worst_grad": worst,
                    "median_grad_rel_err": float(np.median(
                        list(errs[who].values()))),
                    "n_grad_tensors": len(grads)}
    limit = {n: max(DIFF_GRAD_RATIO * e, DIFF_GRAD_FLOOR)
             for n, e in errs["cpu_bf16_plain"].items()}
    over = max(limit, key=lambda n: errs["card"][n] / limit[n])
    rec["card"].update(worst_over_limit=errs["card"][over] / limit[over],
                       worst_over_limit_grad=over, grads_held=hold_grads,
                       its_ratio_to_control=errs["card"][over]
                       / max(errs["cpu_bf16_plain"][over], 1e-30))
    ratios = {n: errs["card"][n] / max(errs["cpu_bf16_plain"][n], 1e-30)
              for n in errs["card"]}
    top = sorted(ratios, key=ratios.get, reverse=True)
    rec["card"].update(
        ratio_to_control_median=float(np.median(list(ratios.values()))),
        ratio_to_control_top=[[n, ratios[n]] for n in top[:3]],
        ratio_to_control_watched={n: ratios[n] for n in watch})
    losses = rec["card"]["loss_rel_errs"]
    if (hold_grads and errs["card"][over] > limit[over]) or not all(
            e <= DIFF_LOSS_TOL for e in losses.values()):
        fail(f"{name}: gradient of {over} rel err {errs['card'][over]} "
             f"(limit {limit[over]}), loss terms {losses} (tol "
             f"{DIFF_LOSS_TOL})")
    return rec


def _generate_runs(name, systems, cond, uncond, lengths, steps, init=None,
                   draws=None):
    """``generate`` on each (label, system, on the card) with the same
    inputs: the latents (float32, on the CPU), seconds and the launches of
    each run.  ``draws``: every ``torch.randn`` of the sampler replayed in
    order (the autoregressive sampler's per-token noise)."""
    from unittest import mock

    import torch
    from ladiff_torch.ops import cuda_common as cc
    out = {}
    for label, system, on_card in systems:
        left = list(draws or ())
        cc.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(torch, "randn", lambda *a, **k: left.pop(
                0).to(device=k["device"], dtype=k["dtype"])):
            _, z = system.generate(cond, uncond, lengths, init_latents=init,
                                   num_inference_timesteps=steps)
        if on_card:
            torch.cuda.synchronize()
        if left:
            fail(f"{name}: {len(left)} replayed draws unused ({label})")
        out[label] = (z.float().cpu(), time.perf_counter() - t0,
                      {k: v for k, v in cc.launch_counts().items() if v})
    return out


def _generation_record(name, runs, bf16_want):
    """float32 card against float32 CPU (``FLOAT32_LOSS_TOL``, no launch)
    and bf16 card against it (1e-1, the plain bf16 CPU control beside it),
    exactly ``bf16_want`` launches; padded latent rows zero."""
    import torch
    want = runs["cpu_float32"][0]
    rec = {"float32_rel_err": relerr(runs["card_float32"][0], want),
           "float32_launches": runs["card_float32"][2],
           "bf16_rel_err": relerr(runs["card_bf16"][0], want),
           "bf16_control_rel_err": relerr(runs["cpu_bf16_control"][0], want),
           "bf16_launches": runs["card_bf16"][2],
           "finite": bool(torch.isfinite(runs["card_bf16"][0]).all()),
           "seconds": {k: v[1] for k, v in runs.items()}}
    if rec["float32_rel_err"] > FLOAT32_LOSS_TOL or rec["float32_launches"]:
        fail(f"{name}: float32 on the card {rec['float32_rel_err']} from "
             f"the CPU, launches {rec['float32_launches']}")
    if not (rec["bf16_rel_err"] <= 1e-1 and rec["finite"]):
        fail(f"{name}: bf16 {rec['bf16_rel_err']} from float32 (control "
             f"{rec['bf16_control_rel_err']}), finite={rec['finite']}")
    if rec["bf16_launches"] != bf16_want:
        fail(f"{name}: launches {rec['bf16_launches']}, expected "
             f"{bf16_want}")
    return rec


def phase_kit_slice(dev):
    """The KIT-ML family at full width (``configs/config_ladiff_kit.yaml``:
    d 256, 9 + 9 layers, 251 features, 21 joints), seeded random weights,
    dropout 0: (a) generation at batch 4, lengths 24 / 60 / 123 / 196,
    DDIM-10, the initial noise handed in: float32 card against float32 CPU
    with no launch, bf16 card within 1e-1 of the float32 CPU beside the
    plain bf16 CPU control, K1 9 x 10 and K2 9 launches; (b) one stage-1
    pass (``vae_forward``) at batch 4, loss and every VAE gradient against
    the CPU at ``train_slice``'s tolerance without the joints loss (with
    all losses at feature std 0.1 printed beside the plain bf16 control),
    and one stage-2 pass
    (``diffusion_forward``) held to the bf16 control as
    ``diffusion_slice`` holds it; (c) the bench protocol on this system
    (bf16, batch 256, 196 frames, CLIP in the timed region, CFG DDIM-50):
    seconds a batch and exactly ``EXPECTED_PER_BATCH`` launches."""
    import torch
    from ladiff_torch import bench
    from ladiff_torch.models.clip_text import CLIPTextTower
    from ladiff_torch.ops import cuda_common as cc

    kit = dict(nfeats=251, njoints=21)
    cfg = _config("config_ladiff_kit.yaml", model={"droupout": 0.0})
    B, steps = 4, 10
    lengths = torch.tensor([24, 60, 123, 196])
    g = torch.Generator().manual_seed(15)
    cond = torch.randn(B, 1, 768, generator=g)
    uncond = 0.1 * torch.randn(B, 1, 768, generator=g)
    init = torch.randn(B, 5, 256, generator=g)
    cpu = _from_cfg(cfg, "cpu", torch.float32, seed=51, **kit)
    state = cpu.state_dict()
    runs = _generate_runs("kit_slice", (
        ("cpu_float32", cpu, False),
        ("cpu_bf16_control", _from_cfg(cfg, "cpu", torch.bfloat16,
                                       state=state, **kit), False),
        ("card_float32", _from_cfg(cfg, dev, torch.float32, state=state,
                                   **kit), True),
        ("card_bf16", _from_cfg(cfg, dev, state=state, **kit), True)),
        cond, uncond, lengths, steps, init=init)
    gen_rec = _generation_record(
        "kit_slice", runs, {"fused_md_layer": 9 * steps,
                            "fused_decoder_layer": 9})

    # (b) the two training stages' passes at batch 4: float32 parameters
    # everywhere, bf16 compute on the control and the card
    batch = {"motion": torch.randn(B, 196, 251, generator=g),
             "length": lengths, "text_emb": torch.randn(B, 1, 768,
                                                        generator=g)}
    eps = torch.randn(B, 5, 256, generator=g)
    draws = {"eps": torch.randn(B, 5, 256, generator=g),
             "noise": torch.randn(B, 5, 256, generator=g),
             "timesteps": torch.randint(0, 1000, (B,), generator=g),
             "cond_drop": torch.tensor([False, True, False, False]).reshape(
                 B, 1, 1)}
    ctl = _from_cfg(cfg, "cpu", torch.bfloat16, torch.float32, state, **kit)
    gpu = _from_cfg(cfg, dev, None, torch.float32, state, **kit)
    stage1 = _slice_cases("kit stage 1", gpu, cpu, ctl, batch, eps,
                          cases=("unit_std_no_joints",))
    # through the joints loss the KIT system is worse conditioned in bf16
    # than the HumanML3D one: the plain bf16 CPU control reads 7.7e-3 on
    # the loss and 0.149 on its worst gradient at feature std 0.1, at
    # train_slice's limits themselves, so that case is printed beside its
    # control and held to nothing (as train_slice's third case is)
    loss_c, grads_c = _vae_loss_and_grads(cpu, batch, eps,
                                          *SLICE_CASES["std_0.1_all_losses"])
    stage1["std_0.1_all_losses"] = {
        who: _against_cpu("kit stage 1", system, batch, eps,
                          "std_0.1_all_losses", loss_c, grads_c)[0]
        for who, system in (("card", gpu), ("cpu_bf16_plain", ctl))}
    for system in (cpu, ctl, gpu):
        system.std.fill_(1.0)
    stage2 = _held_to_control(
        "kit stage 2", lambda s: _loss_grads(s, lambda: s.diffusion_forward(
            batch, uncond[:1], train=True, **draws)), cpu, ctl, gpu)
    del cpu, ctl, gpu

    # (c) a full-width batch of 256 on the bench protocol
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tower = CLIPTextTower().to(device=dev, dtype=torch.bfloat16).eval()
    system = _from_cfg(_config("config_ladiff_kit.yaml"), dev, seed=52,
                       **kit)
    cc.reset_launch_counts()
    res = bench.measure(system, tower, batches=1)
    counts = cc.launch_counts()
    per_batch = {k: v / (bench.WARMUP + 1) for k, v in counts.items()}
    emit({"phase": "kit_slice", "batch": B, "steps": steps,
          "lengths": lengths.tolist(), "generate": gen_rec,
          "stage1": stage1, "stage2": stage2,
          "bench": {"batch": bench.BATCH, "frames": bench.FRAMES,
                    "seconds_per_batch": res["seconds_per_batch"],
                    "samples_per_sec": res["samples_per_sec"],
                    "shape": res["shape"], "finite": res["finite"],
                    "launches_per_batch": per_batch}})
    if not res["finite"] or res["shape"] != [bench.BATCH, bench.FRAMES, 251]:
        fail(f"kit_slice: bench features {res['shape']}, finite="
             f"{res['finite']}")
    for name, want in EXPECTED_PER_BATCH.items():
        if per_batch.get(name, 0) != want:
            fail(f"kit_slice: {name}: {per_batch.get(name)} launches a "
                 f"batch, expected {want}")


def phase_ar_slice(dev):
    """Autoregressive latent diffusion (``configs/config_ladiff_humanml3d
    .yaml`` with ``ARDIFF: true``) at full width, seeded random weights,
    dropout 0.  (a) ``generate`` at batch 4, lengths 16 / 60 / 123 / 196,
    CFG 7.5 DDIM-10, with "last" and with "full" conditioning, each
    token's noise replayed through a patched ``torch.randn``: float32 card
    against float32 CPU with no launch, bf16 card within 1e-1 of it beside
    the plain bf16 CPU control, exactly 5 x 10 x 9 K1 and 9 K2 launches.
    (b) K1 alone at the AR shapes: 512 samples of T = 2 ("last") and T = 6
    ("full") stream rows, E 2, the enclat rows masked as the sampler masks
    them, against its float32 plain version (``KERNEL_TOL``), with device
    ms and bound.  (c) one AR training pass (``diffusion_forward_ar``) at
    batch 4 with every draw given, card against the CPU held to the bf16
    control, its launches exactly ``EXPECTED_PER_DIFFUSION_STEP``.
    Returns K1's records."""
    import torch
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.ops.md_layer import (fused_md_layer,
                                           md_launch_geometry,
                                           md_layer_plain)
    from ladiff_torch.ops.stylization import MDTransformerLayer

    cfg = _config("config_ladiff_humanml3d.yaml", ARDIFF=True,
                  model={"droupout": 0.0})
    B, steps = 4, 10
    lengths = torch.tensor([16, 60, 123, 196])
    g = torch.Generator().manual_seed(16)
    cond = torch.randn(B, 1, 768, generator=g)
    uncond = 0.1 * torch.randn(B, 1, 768, generator=g)
    draws = list(torch.randn(5, B, 1, 256, generator=g))
    cpu = _from_cfg(cfg, "cpu", torch.float32, seed=53)
    state = cpu.state_dict()
    systems = (("cpu_float32", cpu, False),
               ("cpu_bf16_control", _from_cfg(cfg, "cpu", torch.bfloat16,
                                              state=state), False),
               ("card_float32", _from_cfg(cfg, dev, torch.float32,
                                          state=state), True),
               ("card_bf16", _from_cfg(cfg, dev, state=state), True))
    gen = {}
    for mode in ("last", "full"):
        for _, system, _ in systems:
            system.motion_conditioning = mode
        gen[mode] = _generation_record(
            f"ar_slice ({mode})", _generate_runs(
                f"ar_slice ({mode})", systems, cond, uncond, lengths, steps,
                draws=draws),
            {"fused_md_layer": 5 * steps * 9, "fused_decoder_layer": 9})
    del systems

    # (b) K1 alone at the AR shapes
    D, H, F, E, N = 256, 4, 1024, 2, 512
    bf = torch.bfloat16
    rg = torch.Generator().manual_seed(17)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=rg) * scale).to(
        dev, bf)
    layer = randomize_(MDTransformerLayer(D, D, F, H), 18).to(dev, bf)
    p1 = layer.kernel_params()
    p32 = {k: v.float() for k, v in p1.items()}
    k_tok = torch.arange(N) % 5  # the token each sample is sampling
    k1 = []
    for mode, T in (("last", 2), ("full", 6)):
        cond_valid = ((k_tok > 0)[:, None] if T == 2
                      else torch.arange(5)[None] < k_tok[:, None])
        kvalid = torch.cat([torch.ones(N, 1, dtype=torch.bool), cond_valid],
                           1).reshape(N * T).float().to(dev)
        a1 = (rnd(N * T, D), rnd(N * E, D), kvalid, rnd(N, D),
              rnd(1, 2 * D, scale=0.3), rnd(1, 2 * D, scale=0.3))
        fl = 2 * N * T * D * (3 * D + 3 * D + 2 * F) \
            + 2 * N * E * D * 2 * D \
            + 4 * T * D * (int(kvalid.sum()) + N * E) \
            + 2 * N * T * 2 * F * D
        path = AR_K1_PATH.format(T=T, mode=mode)
        with torch.no_grad():
            rec = check_kernel(
                "fused_md_layer", "ladiff_torch/csrc/md_layer.cu",
                "ladiff_tpu/ops/pallas_md_layer.py:198",
                lambda: fused_md_layer(*a1, p1, T=T, E=E, H=H),
                lambda: md_layer_plain(*[t.float() for t in a1], p32, T=T,
                                       E=E, H=H),
                lambda: md_layer_plain(*a1, p1, T=T, E=E, H=H),
                fl, nbytes(*a1, *p1.values(), a1[0]),
                extra={"path": path, **md_launch_geometry(
                    "md_layer", dev, N, T, E, D, F, F)})
        rec["path"] = path
        k1.append(rec)
        del a1

    # (c) one AR training pass at batch 4
    batch = {"motion": torch.randn(B, 196, 263, generator=g),
             "length": lengths, "text_emb": cond}
    tdraws = {"eps": torch.randn(B, 5, 256, generator=g),
              "noise": torch.randn(B, 1, 256, generator=g),
              "timesteps": torch.randint(0, 1000, (B,), generator=g),
              "cond_drop": torch.tensor([False, True, False, False]).reshape(
                  B, 1, 1),
              "latent_idx": torch.tensor([0, 1, 2, 3]),
              "coin": torch.tensor(False)}
    counts = {}

    def run(system):
        cc.reset_launch_counts()
        out = _loss_grads(system, lambda: system.diffusion_forward_ar(
            batch, uncond[:1], train=True, **tdraws))
        if system.device.type == "cuda":
            torch.cuda.synchronize()
            counts.update(cc.launch_counts())
        return out

    train = _held_to_control(
        "ar_slice training", run, cpu,
        _from_cfg(cfg, "cpu", torch.bfloat16, torch.float32, state),
        _from_cfg(cfg, dev, None, torch.float32, state))
    emit({"phase": "ar_slice", "batch": B, "steps": steps,
          "lengths": lengths.tolist(), "generate": gen,
          "k1": [{k: r[k] for k in ("path", "ms", "plain_ms", "bound_ms",
                                    "max_abs_err")} for r in k1],
          "training": train, "training_launches": {
              k: v for k, v in counts.items() if v}})
    for name, want in EXPECTED_PER_DIFFUSION_STEP.items():
        if counts.get(name, 0) != want:
            fail(f"ar_slice training: {name}: {counts.get(name)} launches, "
                 f"expected {want}")
    return k1


def phase_ar_bench(dev, gpu=""):
    """The bench protocol on autoregressive generation: the published
    configuration with ``ARDIFF: true`` ("last"), bf16, batch 256, 196
    frames, CLIP at the 32-token bucket inside the timed region, CFG 7.5
    DDIM-50 per token (250 guided denoiser calls a batch at 2 stream rows a
    sample), the decode; one warm-up and 2 timed batches: seconds a batch,
    samples/s, exactly ``EXPECTED_AR_PER_BATCH`` launches a batch; then
    one batch profiled by part (``bench.breakdown``: device ms by group,
    idle share).  Returns the launches a batch."""
    import torch
    from ladiff_torch import bench
    from ladiff_torch.models.clip_text import CLIPTextTower
    from ladiff_torch.ops import cuda_common as cc

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tower = CLIPTextTower().to(device=dev, dtype=torch.bfloat16).eval()
    system = _from_cfg(_config("config_ladiff_humanml3d.yaml", ARDIFF=True),
                       dev, seed=54)
    batches = 2
    cc.reset_launch_counts()
    res = bench.measure(system, tower, batches=batches)
    counts = cc.launch_counts()
    per_batch = {k: v / (bench.WARMUP + batches) for k, v in counts.items()}
    brk = bench.breakdown(system, tower, res["seconds_per_batch"])
    emit({"phase": "ar_bench", "gpu": gpu, "batch": bench.BATCH,
          "frames": bench.FRAMES, "steps": bench.STEPS,
          "motion_conditioning": system.motion_conditioning,
          "seconds_per_batch": res["seconds_per_batch"],
          "samples_per_sec": res["samples_per_sec"], "finite": res["finite"],
          "shape": res["shape"], "launches_per_batch": per_batch, **brk})
    print(f"# ar_bench: {res['seconds_per_batch']} s a batch of "
          f"{bench.BATCH} ({res['samples_per_sec']:.1f} samples/s), "
          f"{brk['device_ms_per_batch']:.1f} device ms a batch (idle "
          f"{brk['idle_share']:.0%}); {gpu}", flush=True)
    if not res["finite"] or res["shape"] != [bench.BATCH, bench.FRAMES, 263]:
        fail(f"ar_bench: features {res['shape']}, finite={res['finite']}")
    for name, want in EXPECTED_AR_PER_BATCH.items():
        if per_batch.get(name, 0) != want:
            fail(f"ar_bench: {name}: {per_batch.get(name)} launches a "
                 f"batch, expected {want}")
    return per_batch


def _teacher_checkpoint(tmp, system):
    """``system``'s weights as a stage-2 checkpoint directory under
    ``tmp``."""
    from ladiff_torch.utils.checkpoint import save_checkpoint
    ckpt = os.path.join(tmp, "teacher", "checkpoints")
    save_checkpoint(ckpt, 1, system.state_dict())
    return ckpt


def phase_distill_slice(dev):
    """One progressive-distillation pass at batch 4 at full width (the
    train_bench system, dropout 0): the teacher and the VAE booted from a
    stage-2 checkpoint written here (``load_teacher``), the student first
    a copy of the teacher, a grid of 25 student steps (ratio 40), every draw
    given (one sample at t = 1, the teacher's one-step target): loss and
    every student gradient, card against the CPU held to the plain bf16
    control, for a student of its own random weights; for the student
    that starts as the teacher the loss is held and the gradients printed
    beside the control; the card's launches exactly
    ``EXPECTED_DISTILL_PER_STEP``."""
    import copy
    import shutil
    import tempfile

    import torch
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.distill import distill_forward
    from ladiff_torch.utils.checkpoint import load_teacher

    lengths = torch.tensor([16, 60, 123, 196])
    B = len(lengths)
    g = torch.Generator().manual_seed(19)
    batch = {"motion": torch.randn(B, 196, 263, generator=g),
             "length": lengths,
             "text_emb": torch.randn(B, 1, 768, generator=g)}
    uncond = 0.1 * torch.randn(1, 1, 768, generator=g)
    draws = {"i": torch.tensor([0, 7, 18, 24]),
             "eps": torch.randn(B, 5, 256, generator=g),
             "noise": torch.randn(B, 5, 256, generator=g)}
    tmp = tempfile.mkdtemp(prefix="ladiff_distill_slice_")
    try:
        src = _teacher_checkpoint(tmp, randomize_(train_bench.build(
            "cpu", dropout=0.0)[0], 24))
        systems, teachers = [], {}
        for device, dtype in (("cpu", None), ("cpu", torch.bfloat16),
                              (dev, None)):
            system = train_bench.build(device, dropout=0.0, dtype=dtype)[0]
            load_teacher(system, src)
            teachers[id(system)] = copy.deepcopy(
                system.denoiser).requires_grad_(False)
            systems.append(system)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = {}

    def run(system):
        cc.reset_launch_counts()
        out = _loss_grads(system, lambda: distill_forward(
            system, system.denoiser, teachers[id(system)], batch, uncond, 25,
            **draws))
        if system.device.type == "cuda":
            torch.cuda.synchronize()
            counts.update(cc.launch_counts())
        return out

    # a student that starts as the teacher (the stage's first step) makes
    # x0_student - x0_target the small difference of one student step and
    # two teacher steps of the same weights, so its gradients are
    # differences of nearly equal terms: printed beside the control, the
    # loss held; a student of its own weights (any later step) is held in
    # full
    copy_rec = _held_to_control("distill_slice (student = teacher)", run,
                                *systems, hold_grads=False)
    state = randomize_(systems[0].denoiser, 25).state_dict()
    for system in systems[1:]:
        system.denoiser.load_state_dict(state, strict=True)
    rec = _held_to_control("distill_slice (student of its own)", run,
                           *systems)
    emit({"phase": "distill_slice", "batch": B, "lengths": lengths.tolist(),
          "student_steps": 25, "positions": draws["i"].tolist(),
          "student_of_its_own": rec, "student_copy_of_teacher": copy_rec,
          "launches": {k: v for k, v in counts.items() if v}})
    for name, want in EXPECTED_DISTILL_PER_STEP.items():
        if counts.get(name, 0) != want:
            fail(f"distill_slice: {name}: {counts.get(name)} launches, "
                 f"expected {want}")


def phase_distill_bench(dev, gpu=""):
    """(a) ``distill_train_step`` at full width on the train_bench batch of
    128 (dropout 0.1, float32 parameters, bf16 compute), grid 25 (ratio
    40): 2 warm-up steps, 10 timed (host clock, a sync at the end): ms a
    step, samples/s, peak memory, launches a step exactly
    ``EXPECTED_DISTILL_PER_STEP``; 2 steps profiled against 2 unprofiled
    (device ms by group, ``DISTILL_GROUPS``, idle share).  (b)
    ``run_training`` with ``TRAIN.STAGE: distill`` on the published
    stage-2 configuration (bf16, batch 128, ``DISTILL_STEPS`` 25) from a
    teacher checkpoint of (a)'s system, 3 steps on 512 synthetic clips:
    losses, launches a step, the VAE unchanged and the student moved.
    (c) the student sampled at guidance 1 over its 25 steps at batch 32:
    exactly ``EXPECTED_STUDENT_PER_BATCH`` launches, every denoiser call on
    B rows (no doubled batch), seconds a batch.  (d) K1 alone at the
    teacher's shape (``_teacher_k1``).  Returns the launches a step of
    (a)."""
    import copy
    import re
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    from ladiff_torch import train_bench
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.data.synthetic import generate_synthetic_dataset
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.loop import run_training
    from ladiff_torch.training.trainer import distill_train_step
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint)
    from ladiff_torch.utils.logger import create_logger

    tmp = tempfile.mkdtemp(prefix="ladiff_distill_")
    try:
        system, opt = train_bench.build(dev, stage="diffusion_train")
        src = _teacher_checkpoint(tmp, system)
        teacher = copy.deepcopy(system.denoiser).requires_grad_(False)
        batch = train_bench.make_batch(device=dev)
        B = int(batch["motion"].shape[0])
        uncond = torch.zeros(1, 1, 768, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        step = lambda: distill_train_step(system, teacher, opt, batch, uncond,
                                          25, gen)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cc.reset_launch_counts()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            logs = step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        per_step = {k: v / iters for k, v in cc.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 2 * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step()
            torch.cuda.synchronize()
        groups = {name: 0.0 for name, _ in DISTILL_GROUPS}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0)
            if us > 0:
                name = next(n for n, pat in DISTILL_GROUPS
                            if re.search(pat, ev.key))
                groups[name] += us / 2 / 1e3
        device_ms = sum(groups.values())
        bench_rec = {"batch": B, "student_steps": 25, "steps": iters,
                     "ms_per_step": ms, "samples_per_sec": B / ms * 1e3,
                     "loss": float(logs["total"]),
                     "grad_norm": float(logs["grad_norm"]),
                     "peak_mem_gb": peak, "launches_per_step": per_step,
                     "window_host_ms_per_step": host_ms,
                     "device_ms_per_step": device_ms,
                     "idle_share": 1.0 - device_ms / host_ms,
                     "device_ms_by_group": groups}
        print(f"# distill_bench: {ms:.2f} ms a step of {B} "
              f"({B / ms * 1e3:.0f} samples/s), {device_ms:.1f} device ms in "
              f"{host_ms:.1f} (idle {bench_rec['idle_share']:.0%}); {gpu}",
              flush=True)
        if not (math.isfinite(bench_rec["loss"])
                and math.isfinite(bench_rec["grad_norm"])):
            fail("distill_bench: non-finite loss or gradient norm")
        for name, want in EXPECTED_DISTILL_PER_STEP.items():
            if per_step.get(name, 0) != want:
                fail(f"distill_bench: {name}: {per_step.get(name)} launches a "
                     f"step, expected {want}")

        del system, opt, teacher, batch
        data = generate_synthetic_dataset(os.path.join(tmp, "humanml3d"),
                                          n_clips=512, seed=0)
        cfg = _config("config_ladiff_humanml3d.yaml", **{
            "DEBUG": False, "FOLDER": os.path.join(tmp, "experiments"),
            "DATASET": {"HUMANML3D": {"ROOT": data}},
            "LOGGER": {"SACE_CHECKPOINT_EPOCH": 1, "TENSORBOARD": False},
            "TRAIN": {"STAGE": "distill", "PRETRAINED": src,
                      "DISTILL_STEPS": 25, "MIXED_PRECISION": True,
                      "END_EPOCH": 1}})
        cc.reset_launch_counts()
        t0 = time.perf_counter()
        ckpt = run_training(cfg, get_datasets(cfg, phase="train")[0],
                            create_logger(cfg, phase="train"),
                            max_steps_per_epoch=3, device=dev)
        torch.cuda.synchronize()
        entry_s = time.perf_counter() - t0
        entry_counts = {k: v / 3 for k, v in cc.launch_counts().items()
                        if k in EXPECTED_DISTILL_PER_STEP}
        with open(os.path.join(cfg.FOLDER_EXP, "metrics.jsonl")) as f:
            losses = [json.loads(line)["train/distill/total"] for line in f]
        _, sd_t = load_checkpoint(latest_checkpoint(src)[1])
        _, sd_s = load_checkpoint(latest_checkpoint(ckpt)[1])
        vae_kept = all(torch.equal(sd_s[k], v) for k, v in sd_t.items()
                       if k.startswith("vae."))
        moved = any(not torch.equal(sd_s[k], v) for k, v in sd_t.items()
                    if k.startswith("denoiser."))

        # (c) the student at guidance 1 over its 25 steps
        scfg = _config("config_ladiff_humanml3d.yaml", model={
            "guidance_scale": 1.0,
            "scheduler": {"num_inference_timesteps": 25}})
        student = _from_cfg(scfg, dev, state=sd_s)
        n = 32
        rows = []
        hook = student.denoiser.register_forward_pre_hook(
            lambda m, a: rows.append(a[0].shape[0]))
        sg = torch.Generator().manual_seed(20)
        cond = torch.randn(n, 1, 768, generator=sg).to(dev)
        lengths = mixed_lengths(n, seed=5).to(dev)
        sgen = torch.Generator(device=dev).manual_seed(21)
        student.generate(cond, torch.zeros_like(cond), lengths,
                         generator=sgen)
        torch.cuda.synchronize()
        rows.clear()
        cc.reset_launch_counts()
        t0 = time.perf_counter()
        feats, _ = student.generate(cond, torch.zeros_like(cond), lengths,
                                    generator=sgen)
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        hook.remove()
        sample_counts = {k: v for k, v in cc.launch_counts().items() if v}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "distill_bench", "gpu": gpu, "step": bench_rec,
           "entry": {"batch": int(cfg.TRAIN.BATCH_SIZE), "steps": 3,
                     "seconds": entry_s, "losses": losses,
                     "launches_per_step": entry_counts,
                     "vae_unchanged": vae_kept, "student_moved": moved},
           "student_sampling": {"batch": n, "steps": 25,
                                "seconds": sample_s,
                                "denoiser_rows": sorted(set(rows)),
                                "denoiser_calls": len(rows),
                                "launches": sample_counts,
                                "finite": bool(torch.isfinite(feats).all())}}
    emit(rec)
    if not (losses and all(map(math.isfinite, losses)) and vae_kept
            and moved):
        fail(f"distill_bench: run_training {rec['entry']}")
    for name, want in EXPECTED_DISTILL_PER_STEP.items():
        if entry_counts.get(name, 0) != want:
            fail(f"distill_bench: run_training: {name}: "
                 f"{entry_counts.get(name)} launches a step, expected {want}")
    s = rec["student_sampling"]
    if (s["denoiser_rows"] != [n] or s["denoiser_calls"] != 25
            or s["launches"] != EXPECTED_STUDENT_PER_BATCH or not s["finite"]):
        fail(f"distill_bench: student sampling {s}")
    _teacher_k1(dev)
    return per_step


def _teacher_k1(dev):
    """K1 at the distill teacher's shape: 2 x 128 samples of 5 latent rows
    (mixed lengths), E 2, an AdaLN row per sample (each sample its own
    timestep), against its float32 plain version (``KERNEL_TOL``), timed
    beside its plain bf16 version and its bound (``check_kernel``)."""
    import torch
    from ladiff_torch.ops.md_layer import fused_md_layer, md_layer_plain
    from ladiff_torch.ops.stylization import MDTransformerLayer
    from ladiff_torch.utils.masks import latent_valid_mask
    D, H, F, E, T, N = 256, 4, 1024, 2, 5, 256
    bf = torch.bfloat16
    rg = torch.Generator().manual_seed(80)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=rg) * scale).to(
        dev, bf)
    layer = randomize_(MDTransformerLayer(D, D, F, H), 81).to(dev, bf)
    p1 = layer.kernel_params()
    lat = latent_valid_mask(mixed_lengths(N, seed=82), 48, T)
    kvalid = lat.reshape(N * T).float().to(dev)
    a1 = (rnd(N * T, D), rnd(N * E, D), kvalid, rnd(N, D),
          rnd(N, 2 * D, scale=0.3), rnd(N, 2 * D, scale=0.3))
    fl = (2 * N * T * D * (3 * D + 3 * D + 2 * F) + 2 * N * E * D * 2 * D
          + 4 * T * D * (int(lat.sum()) + N * E) + 2 * N * T * 2 * F * D)
    path = "distill teacher, 256 x 5 rows, an AdaLN row per sample"
    with torch.no_grad():
        check_kernel(
            "fused_md_layer", "ladiff_torch/csrc/md_layer.cu",
            "ladiff_tpu/ops/pallas_md_layer.py:198",
            lambda: fused_md_layer(*a1, p1, T=T, E=E, H=H),
            lambda: md_layer_plain(*[t.float() for t in a1],
                                   {k: v.float() for k, v in p1.items()},
                                   T=T, E=E, H=H),
            lambda: md_layer_plain(*a1, p1, T=T, E=E, H=H),
            fl, nbytes(*a1, *p1.values(), a1[0]),
            extra={"path": path, "launches_per_distill_step": 18})


# -- the action family ------------------------------------------------------

# configs/config_ladiff_humanact12.yaml: the 6-layer ActorVae (62 encoder
# tokens, 60 decoder frames against one latent) and the 15-layer plain
# denoiser over 3-token samples [latent; time; action], d 256, no MD layer
ACTION = dict(nfeats=150, njoints=25)
ACTION_FRAMES = 60
# HumanAct12 as its benchmark is published (HumanAct12Poses: 1191 clips,
# all of them in the test split)
HUMANACT12_CLIPS = 1191
# the weight seeds of action_slice's stage-1 passes, and the gradient that
# read 1.34x its control's error at the first with every loss on the split
# route (its ratio printed at each)
ACTION_GRAD_SEEDS = (62, 162, 262)
ACTION_WATCHED_GRAD = "vae.encoder.seqTransEncoder.layers.5.norm2.weight"


def expected_action_generation(steps):
    """A guided generation batch: the denoiser's 15 FFN tails as kernel 5
    every step (its 3-token attention stays plain), the decode's 6 layers
    as K2 (L = 1)."""
    return {"fused_postnorm_ffn": 15 * steps, "fused_decoder_layer": 6}


EXPECTED_ACTION_EVAL_PER_BATCH = expected_action_generation(50)
# a stage-1 step, split route: kernel 8 over the encoder's 62 tokens and
# the decoder's 60 frames, kernel 9 every tail (6 + 6 layers each way)
EXPECTED_ACTION_VAE_STEP = {
    "train_self_attention": 12, "train_self_attention_bwd": 12,
    "train_postnorm_ffn": 12, "train_postnorm_ffn_bwd": 12,
    "train_encoder_layer": 0, "train_decoder_layer": 0,
    "fused_postnorm_ffn": 0, "fused_decoder_layer": 0}
# the whole-layer route: kernel 12 the encoder's layers, 13 the decoder's
EXPECTED_ACTION_VAE_STEP_WHOLE = {
    "train_encoder_layer": 6, "train_encoder_layer_bwd": 6,
    "train_decoder_layer": 6, "train_decoder_layer_bwd": 6,
    "train_self_attention": 0, "train_postnorm_ffn": 0}
# a stage-2 step: the frozen encode's 6 tails as kernel 5, the denoiser's
# 15 as kernel 9 each way (3 tokens: plain attention)
EXPECTED_ACTION_DIFFUSION_STEP = {
    "fused_postnorm_ffn": 6, "train_postnorm_ffn": 15,
    "train_postnorm_ffn_bwd": 15, "train_self_attention": 0,
    "fused_masked_attention": 0, "fused_decoder_layer": 0}
ACTION_PATHS = {
    "k2": "ActorVae decode, 32 x 60 frames, L 1",
    "k5": "action denoiser tail, GELU, 64 x 3 rows (CFG batch of 32)",
    "k8": "ActorVae encoder, 128 x 62 tokens",
    "k9": "ActorVae encoder tail, GELU, 128 x 62 rows",
    "k12": "ActorVae encoder, 128 x 62 tokens",
    "k13": "ActorVae decoder, 128 x 60 frames, L 1"}
ACTION_GROUPS = (
    ("fused_postnorm_ffn (denoiser tails, kernel 5)", r"ffn_tail_fwd_kernel"),
    ("fused_decoder_layer (ActorVae decode, K2)",
     r"linear64_kernel|attn_tile_kernel|dec_tail_fwd_kernel"),
    ("library GEMMs (denoiser attention, GRU)", r"gemm|cutlass|nvjet|cublas"),
    ("memcpy and memset", r"[Mm]emcpy|[Mm]emset"),
    ("other ATen kernels (plain attention, SMPL, GRU cells, sampler)", r""),
)


def _action_data(tmp, name="humanact12"):
    """A synthetic HumanAct12 (or UESTC) root under ``tmp`` (the default
    sizes: 48 clips, 24 videos)."""
    from ladiff_torch.data import a2m
    return getattr(a2m, f"generate_synthetic_{name}")(
        os.path.join(tmp, name))


def _action_batch(root, n, lengths=None, name="humanact12"):
    """``n`` collated items of the synthetic dataset's train split (cycled)
    as tensors; ``lengths`` cut the first items' frames."""
    import numpy as np
    import torch
    from ladiff_torch.data import a2m
    cls = a2m.HumanAct12Dataset if name == "humanact12" else a2m.UESTCDataset
    ds = cls(root, num_frames=ACTION_FRAMES, split="train")
    batch = a2m.a2m_collate([ds[i % len(ds)] for i in range(n)],
                            ACTION_FRAMES)
    if lengths is not None:
        for i, n_i in enumerate(lengths):
            batch["motion"][i, n_i:] = 0.0
            batch["length"][i] = n_i
        batch["mask"] = (np.arange(ACTION_FRAMES)[None]
                         < batch["length"][:, None])
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            if k in ("length", "action") else torch.from_numpy(v)
            for k, v in batch.items() if k != "action_text"}


def phase_action_slice(dev):
    """The action family (``configs/config_ladiff_humanact12.yaml``) at full
    width: d 256, the 6-layer ActorVae and the 15-layer plain denoiser,
    seeded random weights, dropout 0, the synthetic SMPL body and the
    synthetic HumanAct12 data, batch 4 with lengths 16 / 33 / 47 / 60.  (a)
    ``generate`` from the action tokens with CFG 7.5 over DDIM-10, the
    initial noise handed in (DDIM at eta 0 draws no other): latents,
    features and 24 SMPL joints, float32 card against float32 CPU with no
    launch, bf16 card within 1e-1 of it beside the plain bf16 CPU control,
    launches exactly ``expected_action_generation(10)``.  (b) stage-1
    passes (``vae_forward``) on the split route and on the whole-layer
    route at each of ``ACTION_GRAD_SEEDS``' weights, and (c) one stage-2
    pass (``diffusion_forward``: the class-id condition with its drop),
    every draw given: loss terms and every gradient, card against the CPU
    and the plain bf16 CPU control, launches exactly
    ``EXPECTED_ACTION_VAE_STEP`` / ``_WHOLE`` /
    ``EXPECTED_ACTION_DIFFUSION_STEP``.  Stage 2, and stage 1 with the
    SMPL-vertex loss's weight at 0, are held to the control as
    ``diffusion_slice`` holds stage 2; stage 1 with every loss as
    ``train_slice`` holds its own (``TRAIN_GRAD_TOL``'s all-losses limit on
    every gradient, the loss terms ``DIFF_LOSS_TOL``), the worst
    gradient's ratio to the control printed.  (d) one UESTC batch of 4 through
    the ST-GCN and the HumanAct12 batch through the GRU, float32 card
    against the CPU.  (e) K2 alone at 32 x 60 frames against one memory
    row, against its plain version (``KERNEL_TOL``)."""
    import shutil
    import tempfile

    import torch
    from ladiff_torch.evaluation.a2m_eval import classify
    from ladiff_torch.models.classifiers import STGCN, MotionDiscriminator
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.ops.decoder_layer import (decoder_layer_plain,
                                                fused_decoder_layer)
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    from ladiff_torch.utils.masks import lengths_to_mask

    cfg = _config("config_ladiff_humanact12.yaml", model={"droupout": 0.0})
    B, steps = 4, 10
    lengths = [16, 33, 47, 60]
    tmp = tempfile.mkdtemp(prefix="ladiff_action_slice_")
    try:
        batch = _action_batch(_action_data(tmp), B, lengths)
        uestc = _action_batch(_action_data(tmp, "uestc"), B, lengths,
                              "uestc")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    g = torch.Generator().manual_seed(61)
    init = torch.randn(B, 1, 256, generator=g)
    cpu = _from_cfg(cfg, "cpu", torch.float32, seed=62, **ACTION)
    state = cpu.state_dict()
    systems = (("cpu_float32", cpu, False),
               ("cpu_bf16_control", _from_cfg(cfg, "cpu", torch.bfloat16,
                                              state=state, **ACTION), False),
               ("card_float32", _from_cfg(cfg, dev, torch.float32,
                                          state=state, **ACTION), True),
               ("card_bf16", _from_cfg(cfg, dev, state=state, **ACTION),
                True))
    # (a) generation: latents, features, SMPL joints
    with torch.no_grad():
        cond = cpu.denoiser.embed_action(batch["action"][:, 0])
    runs = {}
    for label, system, on_card in systems:
        cc.reset_launch_counts()
        t0 = time.perf_counter()
        feats, z = system.generate(cond, torch.zeros_like(cond),
                                   batch["length"], init_latents=init,
                                   nframes=ACTION_FRAMES,
                                   num_inference_timesteps=steps)
        joints = system.feats2joints_action_eval(
            feats, batch["mask"].to(system.device))
        if on_card:
            torch.cuda.synchronize()
        runs[label] = ({"z": z.float().cpu(), "feats": feats.float().cpu(),
                        "joints": joints.float().cpu()},
                      time.perf_counter() - t0,
                      {k: v for k, v in cc.launch_counts().items() if v})
    want = runs["cpu_float32"][0]
    gen = {who: {k: relerr(runs[who][0][k], w) for k, w in want.items()}
           for who in ("card_float32", "card_bf16", "cpu_bf16_control")}
    gen["launches"] = {k: runs[k][2] for k in ("card_float32", "card_bf16")}
    gen["seconds"] = {k: v[1] for k, v in runs.items()}
    bf16_want = expected_action_generation(steps)
    finite = all(bool(torch.isfinite(t).all())
                 for t in runs["card_bf16"][0].values())
    if max(gen["card_float32"].values()) > FLOAT32_LOSS_TOL or gen[
            "launches"]["card_float32"]:
        fail(f"action_slice: float32 generation on the card {gen}")
    if not (max(gen["card_bf16"].values()) <= 1e-1 and finite):
        fail(f"action_slice: bf16 generation {gen}, finite={finite}")
    if gen["launches"]["card_bf16"] != bf16_want:
        fail(f"action_slice: generation launches "
             f"{gen['launches']['card_bf16']}, expected {bf16_want}")
    padded = runs["card_bf16"][0]["feats"][0, 16:]
    if padded.abs().max() != 0:
        fail("action_slice: padded frames are not zero")
    card32 = systems[2][1]
    del systems

    # (b) stage 1 and (c) stage 2, float32 parameters, bf16 compute on
    # the control and the card
    eps = torch.randn(B, 1, 256, generator=g)
    draws = {"eps": torch.randn(B, 1, 256, generator=g),
             "noise": torch.randn(B, 1, 256, generator=g),
             "timesteps": torch.randint(0, 1000, (B,), generator=g),
             "cond_drop": torch.tensor([False, True, False, False]).reshape(
                 B, 1, 1)}
    train, counts = {}, {}

    def runner(forward):
        def run(system):
            cc.reset_launch_counts()
            out = _loss_grads(system, lambda: forward(system))
            if system.device.type == "cuda":
                torch.cuda.synchronize()
                counts.clear()
                counts.update(cc.launch_counts())
            return out
        return run

    def launches_exact(name, want_counts):
        train[name]["launches"] = {k: v for k, v in counts.items() if v}
        for k, n in want_counts.items():
            if counts.get(k, 0) != n:
                fail(f"action_slice {name}: {k}: {counts.get(k)} launches, "
                     f"expected {n}")

    run1 = runner(lambda s: s.vae_forward(batch, train=True, eps=eps))
    limit = TRAIN_GRAD_TOL["std_0.1_all_losses"]
    for seed in ACTION_GRAD_SEEDS:
        sd = state if seed == 62 else _from_cfg(
            cfg, "cpu", torch.float32, seed=seed, **ACTION).state_dict()
        ref = (_from_cfg(cfg, "cpu", torch.float32, state=sd, **ACTION),
               _from_cfg(cfg, "cpu", torch.bfloat16, torch.float32, sd,
                         **ACTION))
        cards = {route: _from_cfg(cfg, dev, None, torch.float32, sd,
                                  train_whole_layer=route, **ACTION)
                 for route in ("0", "1")}
        for joint in (True, False):
            for system in (*ref, *cards.values()):
                system.weights = dataclasses.replace(
                    system.weights, lambda_joint=float(joint))
            refs = run1(ref[0]), run1(ref[1])
            for route, want_counts in (
                    ("0", EXPECTED_ACTION_VAE_STEP),
                    ("1", EXPECTED_ACTION_VAE_STEP_WHOLE)):
                name = (f"stage 1, route {route}, seed {seed}, "
                        + ("all losses" if joint else "no vertex loss"))
                rec = _held_to_control(f"action_slice {name}", run1, None,
                                       None, cards[route],
                                       hold_grads=not joint, refs=refs,
                                       watch=(ACTION_WATCHED_GRAD,))
                train[name] = rec
                card = rec["card"]
                print(f"# action_slice {name}: card / control error "
                      f"median {card['ratio_to_control_median']:.3f}, "
                      f"largest {card['ratio_to_control_top'][0]}, "
                      f"{ACTION_WATCHED_GRAD} "
                      f"{card['ratio_to_control_watched'][ACTION_WATCHED_GRAD]:.3f}"
                      f"; worst {card['worst_grad']} "
                      f"{card['worst_grad_rel_err']:.4f} (control "
                      f"{rec['cpu_bf16_plain']['worst_grad_rel_err']:.4f})",
                      flush=True)
                if joint:
                    card["grad_tol"] = limit
                    if not card["worst_grad_rel_err"] <= limit:
                        fail(f"action_slice {name}: gradient of "
                             f"{card['worst_grad']} rel err "
                             f"{card['worst_grad_rel_err']} (tol {limit})")
                launches_exact(name, want_counts)
        del ref, cards
    name = "stage 2"
    train[name] = _held_to_control(
        f"action_slice {name}", runner(lambda s: s.diffusion_forward(
            batch, None, train=True, **draws)),
        _from_cfg(cfg, "cpu", torch.float32, state=state, **ACTION),
        _from_cfg(cfg, "cpu", torch.bfloat16, torch.float32, state,
                  **ACTION),
        _from_cfg(cfg, dev, None, torch.float32, state, **ACTION))
    launches_exact(name, EXPECTED_ACTION_DIFFUSION_STEP)

    # (d) the classifiers, float32, card against the CPU
    clf = {}
    for kind, motion, make in (
            ("gru", runs["cpu_float32"][0]["feats"],
             lambda: MotionDiscriminator(72, 128, 2, 12)),
            ("stgcn", uestc["motion"], lambda: STGCN(num_class=40))):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(63)
            model = make().eval()
        outs = {}
        for device in ("cpu", dev):
            m = model.to(device)
            with torch.no_grad():
                outs[str(device)] = [t.cpu() for t in classify(
                    cpu if device == "cpu" else card32, m, motion.to(device),
                    batch["length"].to(device), batch["mask"].to(device),
                    kind)]
        errs = [relerr(a, b) for a, b in zip(outs[str(dev)], outs["cpu"])]
        clf[kind] = {"features_rel_err": errs[0], "logits_rel_err": errs[1]}
        if max(errs) > FLOAT32_LOSS_TOL:
            fail(f"action_slice: the {kind} classifier on the card {errs}")

    # (e) K2 at the decode's shape: 32 x 60 frames, one memory row
    bf = torch.bfloat16
    D, H, F, T, L, n = 256, 4, 1024, ACTION_FRAMES, 1, 32
    lens = mixed_lengths(n, 16, 60, seed=64)
    kv = lengths_to_mask(lens, T).reshape(-1).float().to(dev)
    layer = randomize_(TransformerDecoderLayer(D, H, F, "gelu"), 65).to(dev,
                                                                         bf)
    p2 = layer.kernel_params()
    rg = torch.Generator().manual_seed(66)
    a2 = ((torch.randn(n * T, D, generator=rg)).to(dev, bf), kv,
          torch.randn(n, L, D, generator=rg).to(dev, bf),
          torch.ones(n, L, device=dev))
    with torch.no_grad():
        k2_err = compare("fused_decoder_layer at L 1",
                         fused_decoder_layer(*a2, p2, T=T, H=H),
                         decoder_layer_plain(*[a.float() for a in a2],
                                             {k: v.float() for k, v in
                                              p2.items()}, T=T, H=H),
                         KERNEL_TOL)[0]
    emit({"phase": "action_slice", "batch": B, "steps": steps,
          "lengths": lengths, "generate": gen, "training": train,
          "classifiers": clf, "k2_l1_rel_err": k2_err, "tol": KERNEL_TOL})


def _action_kernel_records(dev, eval_counts, step_counts, whole_counts):
    """The action path's kernels at their shapes, each against its plain
    version and timed in turn with it over 5 rounds (``check_kernel``'s
    ``rounds``: single windows read 1.1x to 5.4x apart between two runs),
    with the launches of the path that runs them: K2 at 32 x 60 frames
    against one memory row
    and kernel 5 at the denoiser's 64 x 3 rows (an evaluation batch), kernel
    8 over 128 x 62 encoder tokens and kernel 9 at 128 x 62 rows (a stage-1
    step, split route), kernels 12 at 128 x 62 and 13 at 128 x 60 with one
    memory row (the whole-layer route); dropout 0.1 for the training
    kernels, the plain version given the kernel's masks.  The library
    times: ``nn.TransformerDecoderLayer`` (eval) for K2,
    ``nn.TransformerEncoderLayer`` / ``TransformerDecoderLayer`` in
    training mode, forward and ``autograd.grad``, for kernels 12 and 13.
    Kernels 5's and 9's lines carry the launch geometry ``ffn_geometry``
    picks at their rows."""
    import torch
    from ladiff_torch.ops.decoder_layer import (decoder_layer_plain,
                                                fused_decoder_layer)
    from ladiff_torch.ops.postnorm_ffn import (ffn_launch_geometry,
                                               fused_postnorm_ffn,
                                               postnorm_ffn_plain)
    from ladiff_torch.ops.train_attention import (
        train_self_attention_bwd, train_self_attention_bwd_plain,
        train_self_attention_fwd, train_self_attention_masks,
        train_self_attention_plain)
    from ladiff_torch.ops.train_decoder_layer import (
        train_decoder_layer_bwd, train_decoder_layer_bwd_plain,
        train_decoder_layer_fwd, train_decoder_layer_masks,
        train_decoder_layer_plain)
    from ladiff_torch.ops.train_ffn import (
        train_postnorm_ffn_bwd, train_postnorm_ffn_bwd_plain,
        train_postnorm_ffn_fwd, train_postnorm_ffn_masks,
        train_postnorm_ffn_plain)
    from ladiff_torch.ops.train_layer import (
        train_encoder_layer_bwd, train_encoder_layer_bwd_plain,
        train_encoder_layer_fwd, train_encoder_layer_masks,
        train_encoder_layer_plain)
    from ladiff_torch.ops.transformer import (TransformerDecoderLayer,
                                              TransformerEncoderLayer)
    from ladiff_torch.utils.masks import lengths_to_mask

    bf = torch.bfloat16
    D, H, F, T, RATE, SEED = 256, 4, 1024, ACTION_FRAMES, 0.1, 0x5EED0A
    g = torch.Generator().manual_seed(67)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(
        dev, bf)
    f32 = lambda p: {k: v.float() for k, v in p.items()}
    flat = lambda dx, *rest: {"dx": dx, **({"dmem": rest[0]} if len(rest)
                                          == 2 else {}), **rest[-1]}
    enc = randomize_(TransformerEncoderLayer(D, H, F, "gelu"), 68).to(dev, bf)
    dec = randomize_(TransformerDecoderLayer(D, H, F, "gelu"), 69).to(dev, bf)
    pe = {k: v.detach() for k, v in enc.kernel_params().items()}
    pd = {k: v.detach() for k, v in dec.kernel_params().items()}
    pa = {k: pe[k] for k in ("in_w", "in_b", "out_w", "out_b")}
    pf = {k: pe[k] for k in ("ln1_w", "ln1_b", "w1", "b1", "w2", "b2",
                             "ln2_w", "ln2_b")}
    recs = []

    def add(key, name, source, replaces, launches, *args, extra=None,
            **kw):
        rec = check_kernel(name, source, replaces, *args, rounds=5,
                           extra={"path": ACTION_PATHS[key], **(extra or {})},
                           **kw)
        rec.update(path=ACTION_PATHS[key], launches=launches)
        recs.append(rec)

    # K2: an evaluation batch's decode, 32 x 60 frames, one memory row
    n = 32
    fv = lengths_to_mask(mixed_lengths(n, 16, T, seed=70), T).to(dev)
    mv = torch.ones(n, 1, dtype=torch.bool, device=dev)
    a2 = (rnd(n * T, D), fv.reshape(-1).float(), rnd(n, 1, D), mv.float())
    lib = torch.nn.TransformerDecoderLayer(
        D, H, F, dropout=0.0, activation="gelu", batch_first=True,
        norm_first=False).to(dev, bf).eval()
    lib.load_state_dict(dec.state_dict())
    xb = a2[0].reshape(n, T, D)

    def library_k2():
        with torch.no_grad():
            return lib(xb, a2[2], tgt_key_padding_mask=~fv)

    fl2 = 2 * n * T * D * (3 * D + 3 * D + 2 * F) + 2 * n * D * 2 * D \
        + 4 * T * D * (int(fv.sum()) + n)
    with torch.no_grad():
        add("k2", "fused_decoder_layer", "ladiff_torch/csrc/decoder_layer.cu",
            "ladiff_tpu/ops/pallas_decoder_layer.py:234",
            eval_counts.get("fused_decoder_layer", 0),
            lambda: fused_decoder_layer(*a2, pd, T=T, H=H),
            lambda: decoder_layer_plain(*[t.float() for t in a2], f32(pd),
                                        T=T, H=H),
            lambda: decoder_layer_plain(*a2, pd, T=T, H=H),
            fl2, nbytes(*a2, *pd.values(), a2[0]), library=library_k2)
        # kernel 5: the denoiser's tail on a CFG batch of 2 x 32 samples of
        # 3 tokens; also in turn over 15 weight sets, as the denoiser's 15
        # layers call it
        x5 = rnd(2 * n * 3, D)
        sets = [{k: v.clone() for k, v in pf.items()} for _ in range(15)]
        k5_15 = interleaved_ms([lambda: [fused_postnorm_ffn(x5, p)
                                         for p in sets]], 3)[0][0] / 15
        del sets
        add("k5", "fused_postnorm_ffn", "ladiff_torch/csrc/postnorm_ffn.cu",
            "ladiff_tpu/ops/pallas_postnorm_ffn.py:64",
            eval_counts.get("fused_postnorm_ffn", 0),
            lambda: fused_postnorm_ffn(x5, pf),
            lambda: postnorm_ffn_plain(x5.float(), f32(pf)),
            lambda: postnorm_ffn_plain(x5, pf),
            4 * x5.shape[0] * D * F, nbytes(x5, x5, *pf.values()),
            extra={"geometry": ffn_launch_geometry(
                "postnorm_ffn", dev, x5.shape[0], D, F),
                "ms_over_15_weight_sets": k5_15})

    # the training kernels at stage 1's batch of 128
    B = 128
    lens = mixed_lengths(B, 16, T, seed=71)
    ev = torch.cat([torch.ones(B, 2, dtype=torch.bool),
                    lengths_to_mask(lens, T)], 1)
    S, Me, Md = T + 2, B * (T + 2), B * T
    kve = ev.reshape(-1).float().to(dev)
    kvd = lengths_to_mask(lens, T).reshape(-1).float().to(dev)
    xe, doute = rnd(Me, D), rnd(Me, D, scale=0.1)
    xd, doutd, mem = rnd(Md, D), rnd(Md, D, scale=0.1), rnd(B, 1, D)
    mvalid = torch.ones(B, 1, device=dev)
    nv_e, nv_d = int(ev.sum()), int(kvd.sum())
    kw = dict(rate=RATE, seed=SEED)
    # kernel 8, forward and backward
    ma = train_self_attention_masks(B, S, D, H, RATE, SEED, dev)
    mab = tuple(m.to(bf) for m in ma)
    pa_bytes = nbytes(*pa.values())
    with torch.no_grad():
        add("k8", "train_self_attention",
            "ladiff_torch/csrc/train_attention.cu",
            "ladiff_tpu/ops/pallas_train_attention.py:388",
            step_counts.get("train_self_attention", 0),
            lambda: train_self_attention_fwd(xe, kve, pa, H=H, S=S, **kw),
            lambda: train_self_attention_plain(xe.float(), kve, f32(pa), ma,
                                               H=H, S=S),
            lambda: train_self_attention_plain(xe, kve, pa, mab, H=H, S=S),
            2 * Me * D * 4 * D + 4 * D * S * nv_e,
            nbytes(xe, kve, xe) + pa_bytes)
        _, saved = train_self_attention_fwd(xe, kve, pa, H=H, S=S,
                                            return_saved=True, **kw)
        add("k8", "train_self_attention_bwd",
            "ladiff_torch/csrc/train_attention.cu",
            "ladiff_tpu/ops/pallas_train_attention.py:388",
            step_counts.get("train_self_attention_bwd", 0),
            lambda: flat(*train_self_attention_bwd(xe, kve, doute, pa, saved,
                                                   H=H, S=S, **kw)),
            lambda: flat(*train_self_attention_bwd_plain(
                xe.float(), kve, doute.float(), f32(pa), ma, H=H, S=S)),
            lambda: train_self_attention_bwd_plain(xe, kve, doute, pa, mab,
                                                   H=H, S=S),
            2 * (2 * Me * D * D + 2 * Me * D * 3 * D) + 8 * D * S * nv_e,
            nbytes(xe, kve, doute, xe) + 3 * pa_bytes, tol=GRAD_TOL)
        del ma, mab, saved
        # kernel 9, forward and backward
        mf = train_postnorm_ffn_masks(Me, D, F, RATE, SEED, dev)
        mfb = tuple(m.to(bf) for m in mf)
        pf_bytes = nbytes(*pf.values())
        add("k9", "train_postnorm_ffn", "ladiff_torch/csrc/train_ffn.cu",
            "ladiff_tpu/ops/pallas_train_ffn.py:209",
            step_counts.get("train_postnorm_ffn", 0),
            lambda: train_postnorm_ffn_fwd(xe, pf, **kw),
            lambda: train_postnorm_ffn_plain(xe.float(), f32(pf), mf),
            lambda: train_postnorm_ffn_plain(xe, pf, mfb),
            4 * Me * D * F, nbytes(xe, xe) + pf_bytes,
            extra={"geometry": ffn_launch_geometry("train_ffn", dev, Me, D,
                                                   F)})
        add("k9", "train_postnorm_ffn_bwd", "ladiff_torch/csrc/train_ffn.cu",
            "ladiff_tpu/ops/pallas_train_ffn.py:209",
            step_counts.get("train_postnorm_ffn_bwd", 0),
            lambda: flat(*train_postnorm_ffn_bwd(xe, doute, pf, **kw)),
            lambda: flat(*train_postnorm_ffn_bwd_plain(
                xe.float(), doute.float(), f32(pf), mf)),
            lambda: train_postnorm_ffn_bwd_plain(xe, doute, pf, mfb),
            8 * Me * D * F, nbytes(xe, doute, xe) + 3 * pf_bytes,
            tol=GRAD_TOL)
        del mf, mfb

    def torch_layer(cls, layer):
        lib = cls(D, H, F, dropout=RATE, activation="gelu",
                  batch_first=True, norm_first=False).to(dev, bf).train()
        lib.load_state_dict(layer.state_dict())
        return lib

    def library_fwd_bwd(forward, wrt, dout):
        leaves = [p for w in wrt for p in (
            w.parameters() if isinstance(w, torch.nn.Module) else [w])]
        with torch.enable_grad():
            out = forward()

        def fwd():
            with torch.enable_grad():
                return forward()
        return fwd, lambda: torch.autograd.grad(out, leaves, dout,
                                                retain_graph=True)

    # kernel 12 over the encoder's 62 tokens
    lib_e = torch_layer(torch.nn.TransformerEncoderLayer, enc)
    xle = xe.reshape(B, S, D).detach().requires_grad_(True)
    pad_e = ~ev.to(dev)
    lib_e_fwd, lib_e_bwd = library_fwd_bwd(
        lambda: lib_e(xle, src_key_padding_mask=pad_e), [xle, lib_e],
        doute.reshape(B, S, D))
    me = train_encoder_layer_masks(B, S, D, H, F, RATE, SEED, dev)
    meb = tuple(m.to(bf) for m in me)
    pe_bytes = nbytes(*pe.values())
    fl_ef = 2 * Me * D * 4 * D + 4 * D * S * nv_e + 4 * Me * D * F
    fl_eb = (2 * (2 * Me * D * D + 2 * Me * D * 3 * D) + 8 * D * S * nv_e
             + 8 * Me * D * F)
    with torch.no_grad():
        add("k12", "train_encoder_layer", "ladiff_torch/csrc/train_layer.cu",
            "ladiff_tpu/ops/pallas_train_layer.py:207",
            whole_counts.get("train_encoder_layer", 0),
            lambda: train_encoder_layer_fwd(xe, kve, pe, H=H, S=S, **kw),
            lambda: train_encoder_layer_plain(xe.float(), kve, f32(pe), me,
                                              H=H, S=S),
            lambda: train_encoder_layer_plain(xe, kve, pe, meb, H=H, S=S),
            fl_ef, nbytes(xe, kve, xe) + pe_bytes, library=lib_e_fwd)
        _, saved = train_encoder_layer_fwd(xe, kve, pe, H=H, S=S,
                                           return_saved=True, **kw)
        add("k12", "train_encoder_layer_bwd",
            "ladiff_torch/csrc/train_layer.cu",
            "ladiff_tpu/ops/pallas_train_layer.py:207",
            whole_counts.get("train_encoder_layer_bwd", 0),
            lambda: flat(*train_encoder_layer_bwd(xe, kve, doute, pe, saved,
                                                  H=H, S=S, **kw)),
            lambda: flat(*train_encoder_layer_bwd_plain(
                xe.float(), kve, doute.float(), f32(pe), me, H=H, S=S)),
            lambda: train_encoder_layer_bwd_plain(xe, kve, doute, pe, meb,
                                                  H=H, S=S),
            fl_eb, nbytes(xe, kve, doute, xe) + 3 * pe_bytes,
            library=lib_e_bwd, tol=GRAD_TOL)
    del me, meb, saved, lib_e, lib_e_fwd, lib_e_bwd
    # kernel 13 over the decoder's 60 frames, one memory row
    lib_d = torch_layer(torch.nn.TransformerDecoderLayer, dec)
    xld = xd.reshape(B, T, D).detach().requires_grad_(True)
    meml = mem.detach().requires_grad_(True)
    pad_d = kvd.reshape(B, T) == 0
    lib_d_fwd, lib_d_bwd = library_fwd_bwd(
        lambda: lib_d(xld, meml, tgt_key_padding_mask=pad_d),
        [xld, meml, lib_d], doutd.reshape(B, T, D))
    md = train_decoder_layer_masks(B, T, 1, D, H, F, RATE, SEED, dev)
    mdb = tuple(m.to(bf) for m in md)
    pd_bytes = nbytes(*pd.values())
    fl_df = (2 * Md * D * 4 * D + 4 * D * T * nv_d + 2 * Md * D * 2 * D
             + 2 * B * D * 2 * D + 4 * D * T * B + 4 * Md * D * F)
    fl_db = (2 * (2 * Md * D * D + 2 * Md * D * 3 * D) + 8 * D * T * nv_d
             + 2 * (2 * Md * D * D) * 2 + 2 * (2 * B * D * 2 * D)
             + 8 * D * T * B + 8 * Md * D * F)
    with torch.no_grad():
        add("k13", "train_decoder_layer",
            "ladiff_torch/csrc/train_decoder_layer.cu",
            "ladiff_tpu/ops/pallas_train_decoder_layer.py:410",
            whole_counts.get("train_decoder_layer", 0),
            lambda: train_decoder_layer_fwd(xd, kvd, mem, mvalid, pd, H=H,
                                            S=T, **kw),
            lambda: train_decoder_layer_plain(xd.float(), kvd, mem.float(),
                                              mvalid, f32(pd), md, H=H, S=T),
            lambda: train_decoder_layer_plain(xd, kvd, mem, mvalid, pd, mdb,
                                              H=H, S=T),
            fl_df, nbytes(xd, kvd, mem, mvalid, xd) + pd_bytes,
            library=lib_d_fwd)
        _, saved = train_decoder_layer_fwd(xd, kvd, mem, mvalid, pd, H=H,
                                           S=T, return_saved=True, **kw)
        add("k13", "train_decoder_layer_bwd",
            "ladiff_torch/csrc/train_decoder_layer.cu",
            "ladiff_tpu/ops/pallas_train_decoder_layer.py:410",
            whole_counts.get("train_decoder_layer_bwd", 0),
            lambda: flat(*train_decoder_layer_bwd(
                xd, kvd, mem, mvalid, doutd, pd, saved, H=H, S=T, **kw)),
            lambda: flat(*train_decoder_layer_bwd_plain(
                xd.float(), kvd, mem.float(), mvalid, doutd.float(), f32(pd),
                md, H=H, S=T)),
            lambda: train_decoder_layer_bwd_plain(xd, kvd, mem, mvalid, doutd,
                                                  pd, mdb, H=H, S=T),
            fl_db, nbytes(xd, kvd, mem, mvalid, doutd, xd, mem)
            + 3 * pd_bytes, library=lib_d_bwd, tol=GRAD_TOL)
    return recs


def _steps(step, n_warm, n, dev):
    """``n`` timed calls of ``step`` after ``n_warm`` (host clock, a sync
    at the end): (ms a call, the last result, launches a call, peak GB)."""
    import torch
    from ladiff_torch.ops import cuda_common as cc
    for _ in range(n_warm):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cc.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        out = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    return (ms, out, {k: v / n for k, v in cc.launch_counts().items() if v},
            torch.cuda.max_memory_allocated() / 1e9)


def phase_action_bench(dev, gpu=""):
    """The action family at the published width in bf16 (float32
    parameters where it trains), seeded random weights, the synthetic SMPL
    body and data.  (a) one HumanAct12 evaluation batch of 32
    (``a2m_eval_step``: CFG 7.5 DDIM-50 from the action tokens, the decode,
    the SMPL joints, the GRU on the generated and the ground-truth
    motions), 1 warm-up and 3 timed: seconds a batch, samples/s, exactly
    ``EXPECTED_ACTION_EVAL_PER_BATCH``; one batch profiled (device ms by
    ``ACTION_GROUPS``, idle share); then the same in float32 (no launch).  (b) 5 stage-1 steps at batch 128
    (dropout 0.1) on the split and on the whole-layer route: ms a step,
    samples/s, peak memory, launches a step exactly
    ``EXPECTED_ACTION_VAE_STEP`` / ``_WHOLE``.  (c) 3 stage-2 steps at batch
    64: the same, ``EXPECTED_ACTION_DIFFUSION_STEP``.  (d) ``python -m
    ladiff_torch.test``'s ``run_test`` on ``config_ladiff_humanact12`` (GRU)
    and ``config_ladiff_uestc`` (ST-GCN) as published (float32, no launch)
    at ``REPLICATION_TIMES`` 1 (published 20) from a saved random
    checkpoint, with random classifiers, on the synthetic roots (48
    HumanAct12 clips, 24 UESTC videos: a smoke run of the protocol's code,
    its seconds no measure of its cost); the protocol's cost is estimated
    from (a)'s seconds a batch, in float32 as published and in bf16, at
    ``HUMANACT12_CLIPS`` clips and 20 replications.  (e) the
    path's kernels at their shapes (``_action_kernel_records``).  Returns
    the kernel records."""
    import logging
    import re
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    from ladiff_torch.data import a2m
    from ladiff_torch.evaluation.a2m_eval import a2m_eval_step
    from ladiff_torch.models.classifiers import MotionDiscriminator
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.test import run_test
    from ladiff_torch.training.trainer import (diffusion_train_step,
                                               make_optimizer,
                                               vae_train_step)

    tmp = tempfile.mkdtemp(prefix="ladiff_action_bench_")
    try:
        roots = {name: _action_data(tmp, name)
                 for name in ("humanact12", "uestc")}
        rec = {"phase": "action_bench", "gpu": gpu}
        # (a) an evaluation batch of 32
        system = _from_cfg(_config("config_ladiff_humanact12.yaml"), dev,
                           seed=72, **ACTION)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(73)
            gru = MotionDiscriminator(72, 128, 2, 12).to(dev).eval()
        batch = _action_batch(roots["humanact12"], 32)
        ng = torch.Generator().manual_seed(74)
        step = lambda: a2m_eval_step(system, gru, batch, "gru",
                                     init_latents=torch.randn(
                                         32, 1, 256, generator=ng))
        ms, out, per_batch, peak = _steps(step, 1, 3, dev)
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        groups = {name: 0.0 for name, _ in ACTION_GROUPS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0)
            if us > 0:
                name = next(n for n, pat in ACTION_GROUPS
                            if re.search(pat, ev.key))
                groups[name] += us / 1e3
        device_ms = sum(groups.values())
        rec["eval_batch"] = {
            "batch": 32, "steps": 50, "frames": ACTION_FRAMES,
            "seconds_per_batch": ms / 1e3, "samples_per_sec": 32 / ms * 1e3,
            "launches_per_batch": per_batch, "peak_mem_gb": peak,
            "finite": finite, "profiled_wall_ms": wall,
            "device_ms_per_batch": device_ms,
            "idle_share": 1.0 - device_ms / ms, "device_ms_by_group": groups}
        print(f"# action_bench: an evaluation batch of 32 in {ms:.1f} ms "
              f"({32 / ms * 1e3:.0f} samples/s), {device_ms:.1f} device ms "
              f"(idle {1 - device_ms / ms:.0%}); {gpu}", flush=True)
        if not finite or per_batch != EXPECTED_ACTION_EVAL_PER_BATCH:
            fail(f"action_bench eval batch: launches {per_batch}, expected "
                 f"{EXPECTED_ACTION_EVAL_PER_BATCH}, finite={finite}")
        # the same batch as the published configuration runs it (float32,
        # no launch): the protocol's cost a batch
        system = _from_cfg(_config("config_ladiff_humanact12.yaml"), dev,
                           torch.float32, seed=72, **ACTION)
        ms32, out, per_batch32, _ = _steps(step, 1, 3, dev)
        rec["eval_batch_float32"] = {
            "seconds_per_batch": ms32 / 1e3,
            "samples_per_sec": 32 / ms32 * 1e3,
            "launches_per_batch": per_batch32}
        batches = -(-HUMANACT12_CLIPS // 32)
        rec["humanact12_protocol_estimate"] = {
            "clips": HUMANACT12_CLIPS, "batches_of_32": batches,
            "replications": 20,
            "seconds_float32": batches * 20 * ms32 / 1e3,
            "seconds_bf16": batches * 20 * ms / 1e3}
        print(f"# action_bench: float32 an evaluation batch of 32 in "
              f"{ms32:.1f} ms; the HumanAct12 protocol ({HUMANACT12_CLIPS} "
              f"clips, {batches} batches x 20 replications) ~"
              f"{batches * 20 * ms32 / 1e3:.0f} s float32, "
              f"{batches * 20 * ms / 1e3:.0f} s bf16; {gpu}", flush=True)
        if per_batch32 or not all(bool(torch.isfinite(v).all())
                                  for v in out.values()):
            fail(f"action_bench float32 eval batch: launches {per_batch32}")
        del system, gru

        # (b) stage 1 at batch 128 on both routes, (c) stage 2 at 64
        train = {}
        vae_cfg = _config("config_vae_humanact12.yaml")
        for route, want in (("0", EXPECTED_ACTION_VAE_STEP),
                            ("1", EXPECTED_ACTION_VAE_STEP_WHOLE)):
            system = _from_cfg(vae_cfg, dev, None, torch.float32, seed=75,
                               train_whole_layer=route, **ACTION)
            opt = make_optimizer(system.vae.parameters())
            gen = torch.Generator(device=dev).manual_seed(76)
            b = {k: v.to(dev) for k, v in _action_batch(
                roots["humanact12"], 128).items()}
            ms, logs, per_step, peak = _steps(
                lambda: vae_train_step(system, opt, b, gen), 2, 5, dev)
            train[f"stage1_route_{route}"] = {
                "batch": 128, "ms_per_step": ms,
                "samples_per_sec": 128 / ms * 1e3, "peak_mem_gb": peak,
                "loss": float(logs["total"]), "launches_per_step": per_step}
            for k, n in want.items():
                if per_step.get(k, 0) != n:
                    fail(f"action_bench stage 1 route {route}: {k}: "
                         f"{per_step.get(k)} launches a step, expected {n}")
            if route == "0":
                step_counts = per_step
            else:
                whole_counts = per_step
            del system, opt
        system = _from_cfg(_config("config_ladiff_humanact12.yaml"), dev,
                           None, torch.float32, seed=77, **ACTION)
        opt = make_optimizer(system.denoiser.parameters())
        gen = torch.Generator(device=dev).manual_seed(78)
        b = {k: v.to(dev) for k, v in _action_batch(
            roots["humanact12"], 64).items()}
        ms, logs, per_step, peak = _steps(
            lambda: diffusion_train_step(system, opt, b, None, gen), 1, 3,
            dev)
        train["stage2"] = {"batch": 64, "ms_per_step": ms,
                           "samples_per_sec": 64 / ms * 1e3,
                           "peak_mem_gb": peak, "loss": float(logs["total"]),
                           "launches_per_step": per_step}
        for k, n in EXPECTED_ACTION_DIFFUSION_STEP.items():
            if per_step.get(k, 0) != n:
                fail(f"action_bench stage 2: {k}: {per_step.get(k)} "
                     f"launches a step, expected {n}")
        rec["training"] = train
        for name, t in train.items():
            print(f"# action_bench: {name} {t['ms_per_step']:.2f} ms a step "
                  f"of {t['batch']} ({t['samples_per_sec']:.0f} samples/s); "
                  f"{gpu}", flush=True)
            if not math.isfinite(t["loss"]):
                fail(f"action_bench {name}: loss {t['loss']}")
        del system, opt

        # (d) the benchmark protocol's code path as published (float32), a
        # smoke run: one replication over the synthetic test splits
        entry = {}
        for name, data_key in (("config_ladiff_humanact12.yaml", "HUMANACT12"),
                               ("config_ladiff_uestc.yaml", "UESTC")):
            cfg = _config(name, **{
                "DEBUG": False, "FOLDER": os.path.join(tmp, "experiments"),
                "FOLDER_EXP": tmp,
                "DATASET": {data_key: {"ROOT": roots[data_key.lower()]}},
                "TEST": {"REPLICATION_TIMES": 1},
                "LOGGER": {"TENSORBOARD": False}})
            state = _from_cfg(cfg, "cpu", torch.float32, seed=79,
                              **ACTION).state_dict()
            logger = logging.getLogger(f"action_bench.{data_key}")
            cc.reset_launch_counts()
            t0 = time.perf_counter()
            summary = run_test(cfg, logger, state_dict=state, device=dev)
            torch.cuda.synchronize()
            entry[data_key] = {
                "smoke_seconds": time.perf_counter() - t0,
                "test_items": len(getattr(a2m, {
                    "HUMANACT12": "HumanAct12Dataset",
                    "UESTC": "UESTCDataset"}[data_key])(
                        roots[data_key.lower()], num_frames=ACTION_FRAMES,
                        split="test")),
                "metrics": {k: v[0] for k, v in summary.items()},
                "launches": {k: v for k, v in cc.launch_counts().items()
                             if v}}
            if entry[data_key]["launches"] or not all(
                    math.isfinite(v) for v in entry[data_key][
                        "metrics"].values()):
                fail(f"action_bench run_test {name}: {entry[data_key]}")
        rec["run_test_smoke"] = entry
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    recs = _action_kernel_records(dev, per_batch, step_counts, whole_counts)
    rec["kernels"] = [{k: r[k] for k in ("name", "path", "ms", "plain_ms",
                                         "bound_ms", "library_ms",
                                         "launches")} for r in recs]
    emit(rec)
    return recs


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after the build "
                    "(e.g. whole_layer_kernels) for a short check; the "
                    "default runs every phase and ends with the ok line")
    only = [p for p in ap.parse_args().only.split(",") if p]
    t_start = time.perf_counter()
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
                else (gpu,) if name in ("eval_entry", "novae_bench",
                                        "ar_bench", "distill_bench",
                                        "action_bench")
                else ())
        with torch.set_grad_enabled(grad):
            out[name] = globals()[f"phase_{name}"](dev, *args)
    if only:
        emit({"phases_run": only,
              "seconds": time.perf_counter() - t_start})
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
    # kernel 10 on the novae path: its launches a DDPM-1000 batch
    novae_rec, novae_counts = out["novae_bench"]
    novae_rec["launches"] = novae_counts[novae_rec["name"]]
    recs.append(novae_rec)
    # the action family's kernels at its shapes, with the launches of its
    # evaluation batch (K2, kernel 5) and of its stage-1 steps on each
    # route (kernels 8, 9, 12, 13)
    recs += out["action_bench"]
    for rec in recs:
        if rec["launches"] <= 0:
            fail(f"{rec['name']} was not launched on the main path")
    if any(k in sys.modules for k in ("jax", "flax", "ladiff_tpu")):
        fail("JAX was imported")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": recs})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
