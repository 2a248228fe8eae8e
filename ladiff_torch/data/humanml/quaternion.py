"""Quaternion (w, x, y, z) and rotation math (counterpart of
``ladiff_tpu/data/humanml/quaternion.py`` and of the rotation pieces of
``ladiff_tpu/transforms/geometry.py``): what ``recover_from_ric``, the SMPL
body model and the action datasets need."""
from __future__ import annotations

import torch

__all__ = ["qinv", "qrot", "qnormalize", "axis_angle_to_quaternion",
           "quaternion_to_matrix", "axis_angle_to_matrix",
           "matrix_to_quaternion", "matrix_to_axis_angle"]


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


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 4) unit quaternions; the norm is
    substituted by 1 below 1e-12 before the division, so the untaken branch
    gives no NaN in the backward (Taylor terms there)."""
    sq = (axis_angle ** 2).sum(-1, keepdim=True)
    small = sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    sin_half_over = torch.where(small, 0.5 - sq / 48.0,
                                torch.sin(half) / angle)
    cos_half = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([cos_half, axis_angle * sin_half_over], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) rotation matrices."""
    w, x, y, z = qnormalize(q).unbind(-1)
    rows = [torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1)]
    return torch.stack(rows, dim=-2)


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues, in float64: (..., 3) -> (..., 3, 3)."""
    aa = aa.double()
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    small = angle < 1e-8
    axis = torch.where(small, torch.zeros_like(aa),
                       aa / torch.where(small, torch.ones_like(angle), angle))
    x, y, z = axis.unbind(-1)
    zeros = torch.zeros_like(x)
    K = torch.stack([torch.stack([zeros, -z, y], -1),
                     torch.stack([z, zeros, -x], -1),
                     torch.stack([-y, x, zeros], -1)], -2)
    a = angle[..., None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)
    return eye + torch.sin(a) * K + (1 - torch.cos(a)) * (K @ K)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz in float64, branchless (pytorch3d's
    algorithm: the candidate of the largest |q_i|)."""
    m = m.double()
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    q_abs = torch.sqrt(torch.clamp(torch.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1), min=0.0))
    d = lambda i, j: m[..., i, j]
    by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, d(2, 1) - d(1, 2), d(0, 2) - d(2, 0),
                     d(1, 0) - d(0, 1)], -1),
        torch.stack([d(2, 1) - d(1, 2), q_abs[..., 1] ** 2, d(1, 0) + d(0, 1),
                     d(0, 2) + d(2, 0)], -1),
        torch.stack([d(0, 2) - d(2, 0), d(1, 0) + d(0, 1), q_abs[..., 2] ** 2,
                     d(2, 1) + d(1, 2)], -1),
        torch.stack([d(1, 0) - d(0, 1), d(2, 0) + d(0, 2), d(2, 1) + d(1, 2),
                     q_abs[..., 3] ** 2], -1)], -2)
    candidates = by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    q = torch.take_along_dim(candidates, best[..., None, None].expand(
        *best.shape, 1, 4), dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) rotation vectors, in float64."""
    q = matrix_to_quaternion(m)
    norms = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms[..., 0], q[..., 0])[..., None]
    angles = 2 * half_angles
    small = angles.abs() < 1e-6
    sin_half = torch.where(
        small, 0.5 - angles ** 2 / 48,
        torch.sin(half_angles) / torch.where(angles.abs() < 1e-12,
                                             torch.ones_like(angles), angles))
    return q[..., 1:] / sin_half
