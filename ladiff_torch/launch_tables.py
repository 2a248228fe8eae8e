"""Kernel launches of the published paths in float32 on the card.

The published configurations compute in float32 (``configs/base.yaml``
``TRAIN.MIXED_PRECISION: false``).  There K1, K2, kernel 5 and kernel 10
take float32 (``ops.cuda_common.KERNEL_DTYPES``, the chains of
``ops/f32_layer.py``) and every other kernel sends its module to the plain
route, so each path launches, per call of a wrapper:

  generation (CFG DDIM)  K1 in each MD layer every step (the 2B guided rows
                         in one call), K2 in each decoder layer once
  encode (eval mode)     kernel 10 (>= 64 tokens) and kernel 5 in each
                         encoder layer
  decode (eval mode)     K2 in each decoder layer
  stage-1 step           nothing: training layers take kernels 8, 9, 12
                         and 13, which take bf16 only
  stage-2 step           the frozen encode; the denoiser's training tails
                         stay plain

Each shape gate is one for both types (``ops/f32_layer.py``), so a float32
run of a path launches exactly the bf16 run's launches of those four
kernels: ``float32_launches`` of the bf16 table.  ``chip_smoke.py`` holds
the card to these tables and ``tests/test_torch_dtype_routes.py`` holds the
CPU's route choices (``on_card`` patched) to them.
"""
from __future__ import annotations

from typing import Dict

import torch

from ladiff_torch.ops.cuda_common import KERNEL_DTYPES

__all__ = ["FLOAT32_KERNELS", "float32_launches", "generation", "encode",
           "decode", "STAGE1_STEP", "stage2_step", "novae_step",
           "action_generation"]

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


def encode(layers: int = 9) -> Dict[str, int]:
    """An eval-mode encode of at least 64 tokens a sample."""
    return {"fused_masked_attention": layers, "fused_postnorm_ffn": layers}


def decode(layers: int = 9) -> Dict[str, int]:
    """An eval-mode decode."""
    return {"fused_decoder_layer": layers}


STAGE1_STEP: Dict[str, int] = {}


def stage2_step(vae_layers: int = 9) -> Dict[str, int]:
    """A stage-2 step: the frozen VAE's encode."""
    return encode(vae_layers)


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
