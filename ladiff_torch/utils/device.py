"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "resolve_dtype"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The GPU unless the caller names another device.

    With no device given and no GPU present this raises instead of running
    on the CPU: a run that silently left the card would report CPU numbers
    under GPU names.  Pass ``device="cpu"`` to run the plain PyTorch paths.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ladiff_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch paths")
    return dev


def resolve_dtype(device: torch.device,
                  dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The compute type on ``device``: bfloat16 on CUDA, the only type the
    CUDA kernels take, and float32 elsewhere unless the caller names one.

    Another type on CUDA raises here, naming it, rather than at the first
    kernel launch."""
    if dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if device.type == "cuda" and dtype != torch.bfloat16:
        raise TypeError(
            f"ladiff_torch's CUDA kernels take torch.bfloat16, not {dtype}; "
            "pass device='cpu' to run the plain PyTorch paths in it")
    return dtype
