"""Quaternion math (w, x, y, z), the part ``recover_from_ric`` needs
(counterpart of ``ladiff_tpu/data/humanml/quaternion.py``)."""
from __future__ import annotations

import torch

__all__ = ["qinv", "qrot"]


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (inverse for unit quaternions)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)
