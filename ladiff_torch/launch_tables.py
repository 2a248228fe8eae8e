"""Kernel launches of the published paths on the card, and their float32
counterparts.

The published configurations compute in float32 (``configs/base.yaml``
``TRAIN.MIXED_PRECISION: false``).  Every kernel the JAX package runs in
float32 takes float32 on the card as well (``ops.cuda_common
.KERNEL_DTYPES``): K1, K2 and kernels 5, 6, 7, 10 and 11 (the routes of
``ops/f32_layer.py``: K2 and 10 on the tensor-core tiles, the others
chains of FFMA kernels) and the training kernels 8, 9, 12 and 13, forward
and backward (those of ``ops/f32_train.py``); only CLIP's K3 and K4 take
bf16 alone and send CLIP to its plain route.  Per call of a wrapper each
path launches:

  generation (CFG DDIM)  K1 in each MD layer every step (the 2B guided rows
                         in one call), K2 in each decoder layer once
  the other generation   the whole stack as kernel 11 once a step
  routes                 (``md_stack``); with full-context text every MD
                         layer per block, kernels 5 and 6; one text token
                         at head width 256 (which K1 and K2 refuse) every
                         MD layer per block, kernels 5, 7 and 6, and every
                         decoder layer per block, kernel 5
  encode (eval mode)     kernel 10 (>= 64 tokens) and kernel 5 in each
                         encoder layer
  decode (eval mode)     K2 in each decoder layer
  stage-1 step           kernels 8 and 9 in each encoder and decoder layer,
                         forward and backward (the split route); kernels 12
                         and 13 on the whole-layer route
  stage-2 step           the frozen encode; kernel 9 as each MD layer's
                         sa_block tail, forward and backward
  joint step             stage 1's and stage 2's, 10 guided sampling steps
                         of K1 and the decode with gradients through
                         kernels 8 and 9 at rate 0

Each function below gives a path's bf16 launches; each shape gate is one
for both types (``ops/f32_layer.py``, ``ops/f32_train.py``), so a float32
run of the path launches ``float32_launches`` of it: the launches of the
kernels that take float32, which are every kernel of these paths but CLIP's.
``STAGE1_STEP`` and the other float32 tables are derived so.
``chip_smoke.py`` holds the card to these tables and
``tests/test_torch_dtype_routes.py`` holds the CPU's route choices
(``on_card`` patched) to them.
"""
from __future__ import annotations

from typing import Dict

import torch

from ladiff_torch.ops.cuda_common import KERNEL_DTYPES

__all__ = ["FLOAT32_KERNELS", "float32_launches", "generation", "encode",
           "decode", "stage1_step", "whole_layer_step", "STAGE1_STEP",
           "STAGE1_WHOLE_LAYER_STEP", "stage2_step", "joint_step",
           "action_stage1_step", "novae_step", "action_generation",
           "stack_generation", "full_context_generation",
           "one_token_h1_generation"]

FLOAT32_KERNELS = tuple(sorted(k for k, types in KERNEL_DTYPES.items()
                               if torch.float32 in types))


def float32_launches(table: Dict[str, int]) -> Dict[str, int]:
    """The launches of a bf16 table that a float32 run of the same path
    makes: those of the kernels that take float32, the others none."""
    return {k: n for k, n in table.items() if k in FLOAT32_KERNELS and n}


def generation(steps: int, md_layers: int = 9,
               dec_layers: int = 9) -> Dict[str, int]:
    """A guided generation batch of the MD-trans denoiser, then its
    decode."""
    return {"fused_md_layer": md_layers * steps,
            "fused_decoder_layer": dec_layers}


def stack_generation(steps: int, dec_layers: int = 9) -> Dict[str, int]:
    """A guided generation batch on the whole-stack route (``md_stack``):
    kernel 11 once a step, then the decode."""
    return {"fused_md_stack": steps, "fused_decoder_layer": dec_layers}


def full_context_generation(steps: int, md_layers: int = 9,
                            dec_layers: int = 9) -> Dict[str, int]:
    """A guided generation batch with full-context text (more than one
    text token): every MD layer per block, kernel 5 as the sa_block's tail
    (its attention and the linear cross-attention plain) and kernel 6; then
    the decode."""
    return {"fused_postnorm_ffn": md_layers * steps,
            "fused_stylized_ffn": md_layers * steps,
            "fused_decoder_layer": dec_layers}


def one_token_h1_generation(steps: int, md_layers: int = 9,
                            dec_layers: int = 9) -> Dict[str, int]:
    """A guided generation batch of a one-token system at head width 256
    (one head), which neither K1 nor K2 takes: every MD layer per block
    (kernel 5 as the sa_block's tail, kernel 7, kernel 6; the attention
    plain) and every decoder layer per block (kernel 5 as the tail; both
    attentions plain)."""
    return {"fused_broadcast_stylize": md_layers * steps,
            "fused_stylized_ffn": md_layers * steps,
            "fused_postnorm_ffn": md_layers * steps + dec_layers}


def encode(layers: int = 9) -> Dict[str, int]:
    """An eval-mode encode of at least 64 tokens a sample."""
    return {"fused_masked_attention": layers, "fused_postnorm_ffn": layers}


def decode(layers: int = 9) -> Dict[str, int]:
    """An eval-mode decode."""
    return {"fused_decoder_layer": layers}


def _both_ways(counts: Dict[str, int]) -> Dict[str, int]:
    """A training table: each wrapper's forward and its backward."""
    return {k2: n for k, n in counts.items() for k2 in (k, k + "_bwd")}


def stage1_step(enc_layers: int = 9, dec_layers: int = 9) -> Dict[str, int]:
    """A stage-1 (LA-VAE) step on the split route: kernel 8 and kernel 9 in
    each encoder and decoder layer, forward and backward."""
    n = enc_layers + dec_layers
    return _both_ways({"train_self_attention": n, "train_postnorm_ffn": n})


def whole_layer_step(enc_layers: int = 9,
                     dec_layers: int = 9) -> Dict[str, int]:
    """A stage-1 step on the whole-layer route (``LADIFF_TRAIN_WHOLE_LAYER``
    1): kernel 12 in each encoder layer and kernel 13 in each decoder
    layer, forward and backward."""
    return _both_ways({"train_encoder_layer": enc_layers,
                       "train_decoder_layer": dec_layers})


# the published stage 1 (9 + 9 layers) in float32 on each route
STAGE1_STEP: Dict[str, int] = float32_launches(stage1_step())
STAGE1_WHOLE_LAYER_STEP: Dict[str, int] = float32_launches(
    whole_layer_step())


def stage2_step(vae_layers: int = 9, md_layers: int = 9) -> Dict[str, int]:
    """A stage-2 step in float32: the frozen VAE's encode and each MD
    layer's sa_block tail as kernel 9, forward and backward (its 5 latent
    rows take the plain attention)."""
    return float32_launches({**encode(vae_layers), **_both_ways(
        {"train_postnorm_ffn": md_layers})})


def joint_step(steps: int = 10, vae_layers: int = 9,
               md_layers: int = 9) -> Dict[str, int]:
    """A joint-stage step in float32: stage 1's split-route launches and
    stage 2's, ``steps`` guided sampling steps of K1, and the eval-mode
    decode of the sampled latents with gradients through kernels 8 and 9
    at rate 0 (one each way per decoder layer)."""
    table = {**stage1_step(vae_layers, vae_layers),
             "fused_md_layer": md_layers * steps, **encode(vae_layers)}
    for k, n in _both_ways({"train_self_attention": vae_layers,
                            "train_postnorm_ffn": vae_layers + md_layers}
                           ).items():
        table[k] += n
    return float32_launches(table)


def action_stage1_step(layers: int = 6, whole: bool = False
                       ) -> Dict[str, int]:
    """The action family's stage-1 (ActorVae) step in float32: kernels 8
    and 9 in each of the 6 encoder (62 tokens) and 6 decoder (60 frames)
    layers, or kernels 12 and 13 on the whole-layer route (one memory
    row)."""
    return float32_launches(whole_layer_step(layers, layers) if whole
                            else stage1_step(layers, layers))


def novae_step(layers: int = 9) -> Dict[str, int]:
    """A guided step of the plain skip denoiser over 198 tokens at d 512:
    kernel 10 in each layer (d 512 is past kernel 5's FFN-tail gate)."""
    return {"fused_masked_attention": layers}


def action_generation(steps: int, denoiser_layers: int = 15,
                      dec_layers: int = 6) -> Dict[str, int]:
    """A guided generation batch of the action family: kernel 5 in each of
    the plain denoiser's layers every step (its 3-token attention stays
    plain), K2 in each of the ActorVae decoder's layers (one memory
    row)."""
    return {"fused_postnorm_ffn": denoiser_layers * steps,
            "fused_decoder_layer": dec_layers}
