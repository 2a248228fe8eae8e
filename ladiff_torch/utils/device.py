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
    """The compute type on ``device``: bfloat16 on CUDA (the kernels' type)
    and float32 elsewhere unless the caller names one.

    On CUDA the caller may name float32 (the published configurations'
    ``TRAIN.MIXED_PRECISION: false``): the kernels that take float32 (K1,
    K2, kernels 5 and 10) then run their float32 chains and every other
    module its plain route (``ops.cuda_common.kernel_route``), and the
    float32 products of the plain routes are held at full float32 here (``torch.backends.cuda.matmul.allow_tf32``
    and ``torch.backends.cudnn.allow_tf32`` off; cuDNN's default is TF32).
    Another type on CUDA raises here, naming it."""
    if dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if device.type == "cuda":
        if dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(
                f"ladiff_torch computes in torch.bfloat16 (the CUDA kernels) "
                f"or torch.float32 (the float32 kernels and the plain routes) "
                f"on CUDA, not {dtype}")
        if dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    return dtype
