"""Rotation conversions for the transform stack (numpy, device-free).

Host-side numpy: the counterpart of ``ladiff_tpu/transforms/geometry.py``,
line for line.

Rebuild of the pieces of the reference's ladiff/utils/geometry.py and
utils/temos_utils.py (matrix_to / to_matrix / nfeats_of) that the TEMOS
transform stack uses.  All functions take and return numpy arrays with
arbitrary leading batch dims.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "axis_angle_to_matrix", "matrix_to_axis_angle", "matrix_to_rotation_6d",
    "rotation_6d_to_matrix", "matrix_of_angles", "matrix_to", "to_matrix",
    "nfeats_of", "softmin",
]


def softmin(x: np.ndarray, softness: float = 0.5,
            axis: int = -1) -> np.ndarray:
    """The reference's soft minimum along ``axis`` (the floor height of
    Rifke, the TEMOS metrics and the Blender canonicalization)."""
    maxi, mini = (-x).max(axis=axis), (-x).min(axis=axis)
    return -(maxi + np.log(softness + np.exp(mini - maxi)))


def axis_angle_to_matrix(aa: np.ndarray) -> np.ndarray:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    aa = np.asarray(aa, np.float64)
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    small = angle < 1e-8
    axis = np.where(small, 0.0, aa / np.where(small, 1.0, angle))
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = np.zeros_like(x)
    K = np.stack([
        np.stack([zeros, -z, y], -1),
        np.stack([z, zeros, -x], -1),
        np.stack([-y, x, zeros], -1),
    ], -2)
    a = angle[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)


def matrix_to_quaternion(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) wxyz, branchless (pytorch3d algorithm)."""
    m = np.asarray(m, np.float64)
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    # candidate quaternions from the four diagonal combinations
    q_abs = np.sqrt(np.maximum(0.0, np.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], -1)))
    quat_by_rijk = np.stack([
        np.stack([q_abs[..., 0] ** 2, m[..., 2, 1] - m[..., 1, 2],
                  m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]], -1),
        np.stack([m[..., 2, 1] - m[..., 1, 2], q_abs[..., 1] ** 2,
                  m[..., 1, 0] + m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0]], -1),
        np.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] + m[..., 0, 1],
                  q_abs[..., 2] ** 2, m[..., 2, 1] + m[..., 1, 2]], -1),
        np.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 2, 0] + m[..., 0, 2],
                  m[..., 2, 1] + m[..., 1, 2], q_abs[..., 3] ** 2], -1),
    ], -2)
    flr = 0.1
    # each candidate row scaled by its own q_abs
    quat_candidates = quat_by_rijk / (2.0 * np.maximum(flr, q_abs[..., None]))
    best = np.argmax(q_abs, axis=-1)
    out = np.take_along_axis(
        quat_candidates, best[..., None, None].repeat(4, -1), axis=-2)
    q = out[..., 0, :]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def matrix_to_axis_angle(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 3)."""
    q = matrix_to_quaternion(m)
    norms = np.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    half_angles = np.arctan2(norms[..., 0], q[..., 0])[..., None]
    angles = 2 * half_angles
    small = np.abs(angles) < 1e-6
    sin_half = np.where(
        small, 0.5 - angles ** 2 / 48, np.sin(half_angles) / np.where(
            np.abs(angles) < 1e-12, 1.0, angles))
    return q[..., 1:] / sin_half


def matrix_to_rotation_6d(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 6): first two rows flattened (pytorch3d)."""
    m = np.asarray(m)
    return m[..., :2, :].reshape(m.shape[:-2] + (6,)).copy()


def rotation_6d_to_matrix(d6: np.ndarray) -> np.ndarray:
    """(..., 6) -> (..., 3, 3) via Gram-Schmidt (Zhou et al.)."""
    d6 = np.asarray(d6, np.float64)
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / np.linalg.norm(a1, axis=-1, keepdims=True)
    a2 = a2 - np.sum(b1 * a2, -1, keepdims=True) * b1
    b2 = a2 / np.linalg.norm(a2, axis=-1, keepdims=True)
    b3 = np.cross(b1, b2)
    return np.stack([b1, b2, b3], axis=-2)


def matrix_of_angles(cos: np.ndarray, sin: np.ndarray,
                     inv: bool = False, dim: int = 2) -> np.ndarray:
    """2D/3D rotation matrix from cos/sin (reference geometry.py)."""
    assert dim in (2, 3)
    sin = -sin if inv else sin
    if dim == 2:
        row1 = np.stack((cos, -sin), -1)
        row2 = np.stack((sin, cos), -1)
        return np.stack((row1, row2), -2)
    row1 = np.stack((cos, -sin, np.zeros_like(cos)), -1)
    row2 = np.stack((sin, cos, np.zeros_like(cos)), -1)
    row3 = np.stack((np.zeros_like(cos),) * 2 + (np.ones_like(cos),), -1)
    return np.stack((row1, row2, row3), -2)


_NFEATS = {"rotvec": 3, "axisangle": 3, "rotmat": 9, "matrix": 9,
           "rotquat": 4, "rot6d": 6, "rotation6d": 6}


def nfeats_of(rottype: str) -> int:
    return _NFEATS[rottype]


def matrix_to(rottype: str, m: np.ndarray) -> np.ndarray:
    if rottype in ("matrix", "rotmat"):
        return m
    if rottype in ("rot6d", "rotation6d"):
        return matrix_to_rotation_6d(m)
    if rottype in ("rotvec", "axisangle"):
        return matrix_to_axis_angle(m)
    raise NotImplementedError(rottype)


def to_matrix(rottype: str, x: np.ndarray) -> np.ndarray:
    if rottype in ("matrix", "rotmat"):
        return x
    if rottype in ("rot6d", "rotation6d"):
        return rotation_6d_to_matrix(x)
    if rottype in ("rotvec", "axisangle"):
        return axis_angle_to_matrix(x)
    raise NotImplementedError(rottype)
