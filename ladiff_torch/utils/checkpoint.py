"""Training checkpoints (counterpart of ``ladiff_tpu/utils/checkpoint.py``).

A checkpoint is ``torch.save`` of ``{"state_dict": ..., "epoch": n}`` at
``<dir>/epoch_{n}.ckpt``, with the reference LADiff's key layout (``vae.*``,
``denoiser.*``; the frozen CLIP text tower is never saved), so a reference
Lightning checkpoint and one of the port's read the same way.  Kept all, as
the reference keeps every periodic checkpoint; ``latest_checkpoint`` finds
the newest for a resume.  ``load_vae`` boots stage 2 from stage 1: a
checkpoint directory (its newest file) or a reference ``.ckpt``, through
``load_state_dict(strict=True)`` on the ``vae.`` subtree; ``load_teacher``
boots the distill stage from a stage-2 checkpoint the same way, the
denoiser and the VAE (where the system has one) each strictly.
"""
from __future__ import annotations

import os
import re
from os.path import join as pjoin
from typing import Dict, Optional, Tuple

import torch
from torch import nn

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "subtree", "load_vae", "load_teacher"]

_NAME = re.compile(r"epoch_(\d+)\.ckpt")


def save_checkpoint(ckpt_dir: str, epoch: int,
                    state_dict: Dict[str, torch.Tensor]) -> str:
    """Writes ``epoch_{epoch}.ckpt`` (tensors moved to the CPU) through a
    temporary file, so a run cut mid-write leaves no partial checkpoint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = pjoin(ckpt_dir, f"epoch_{epoch}.ckpt")
    tmp = path + ".tmp"
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in state_dict.items()},
                "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Tuple[int, Dict[str, torch.Tensor]]:
    """(epoch, state dict) of a checkpoint file (a reference Lightning
    checkpoint too: its extra entries are ignored)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return int(ckpt.get("epoch", 0)), sd


def latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """(epoch, path) of the highest ``epoch_*.ckpt`` in ``ckpt_dir``, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = _NAME.fullmatch(name)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), pjoin(ckpt_dir, name))
    return best


def subtree(state_dict: Dict[str, torch.Tensor],
            prefix: str) -> Dict[str, torch.Tensor]:
    """The entries under ``prefix`` (e.g. ``"vae."``) with it stripped."""
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def _source(src: str) -> Tuple[int, Dict[str, torch.Tensor], str]:
    """(epoch, state dict, path) of ``src``: a ``.ckpt`` file, or a
    checkpoint directory whose newest file is taken."""
    if src.endswith(".ckpt"):
        path = src
    else:
        found = latest_checkpoint(src)
        if found is None:
            raise FileNotFoundError(f"no checkpoints under {src}")
        path = found[1]
    return (*load_checkpoint(path), path)


def load_vae(vae: nn.Module, src: str) -> Tuple[int, str]:
    """Loads ``vae`` (strict) from the ``vae.`` entries of ``src`` (see
    ``_source``).  Returns (epoch, path)."""
    epoch, sd, path = _source(src)
    vae.load_state_dict(subtree(sd, "vae."), strict=True)
    return epoch, path


def load_teacher(system: nn.Module, src: str) -> Tuple[int, str]:
    """Loads ``system.denoiser`` from the ``denoiser.`` entries of ``src``
    and ``system.vae``, where there is one, from its ``vae.`` entries, each
    strictly (a reference checkpoint's other entries are ignored).
    Returns (epoch, path)."""
    epoch, sd, path = _source(src)
    system.denoiser.load_state_dict(subtree(sd, "denoiser."), strict=True)
    if system.vae is not None:
        system.vae.load_state_dict(subtree(sd, "vae."), strict=True)
    return epoch, path
