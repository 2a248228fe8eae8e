"""Quaternion math (w, x, y, z) in numpy, for host-side preprocessing
(``skeleton.py``, ``process.py``): the numpy branch of
``ladiff_tpu/data/humanml/quaternion.py``.  The torch functions that the
device path uses are in ``quaternion.py`` beside this module.  Fully
batched over leading axes; the callers cast their inputs to float32."""
from __future__ import annotations

import numpy as np

__all__ = ["qinv", "qmul", "qrot", "qnormalize", "qbetween",
           "quaternion_to_matrix", "quaternion_to_cont6d",
           "cont6d_to_matrix", "axis_angle_to_quaternion"]


def qinv(q):
    """Conjugate (inverse for unit quaternions)."""
    return q * np.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def qnormalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def qmul(q, r):
    """Hamilton product q * r, shapes (..., 4)."""
    qw, qx, qy, qz = np.split(q, 4, axis=-1)
    rw, rx, ry, rz = np.split(r, 4, axis=-1)
    w = qw * rw - qx * rx - qy * ry - qz * rz
    x = qw * rx + qx * rw + qy * rz - qz * ry
    y = qw * ry - qx * rz + qy * rw + qz * rx
    z = qw * rz + qx * ry - qy * rx + qz * rw
    return np.concatenate([w, x, y, z], axis=-1)


def qrot(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qbetween(v0, v1, eps: float = 1e-10):
    """Unit quaternion rotating v0 onto v1."""
    v0 = v0 / np.maximum(np.linalg.norm(v0, axis=-1, keepdims=True), eps)
    v1 = v1 / np.maximum(np.linalg.norm(v1, axis=-1, keepdims=True), eps)
    xyz = np.cross(v0, v1)
    w = np.sqrt(np.maximum(
        (v0 ** 2).sum(-1, keepdims=True) * (v1 ** 2).sum(-1, keepdims=True),
        eps)) + (v0 * v1).sum(-1, keepdims=True)
    return qnormalize(np.concatenate([w, xyz], axis=-1))


def quaternion_to_matrix(q):
    """(..., 4) -> (..., 3, 3) rotation matrices."""
    w, x, y, z = np.split(qnormalize(q), 4, axis=-1)
    rows = [np.concatenate([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                            2 * (x * z + w * y)], -1),
            np.concatenate([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                            2 * (y * z - w * x)], -1),
            np.concatenate([2 * (x * z - w * y), 2 * (y * z + w * x),
                            1 - 2 * (x * x + y * y)], -1)]
    return np.stack(rows, axis=-2)


def quaternion_to_cont6d(q):
    """The rotation matrix's first two columns, concatenated."""
    m = quaternion_to_matrix(q)
    return np.concatenate([m[..., 0], m[..., 1]], axis=-1)


def cont6d_to_matrix(cont6d):
    """Gram-Schmidt 6D -> rotation matrix (the columns layout above)."""
    x_raw = cont6d[..., :3]
    y_raw = cont6d[..., 3:]
    x = x_raw / np.linalg.norm(x_raw, axis=-1, keepdims=True)
    z = np.cross(x, y_raw)
    z = z / np.linalg.norm(z, axis=-1, keepdims=True)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=-1)


def axis_angle_to_quaternion(axis_angle):
    """(..., 3) rotation vectors -> (..., 4) unit quaternions (Taylor terms
    below an angle of 1e-6)."""
    sq = (axis_angle ** 2).sum(-1, keepdims=True)
    small = sq < 1e-12
    angle = np.sqrt(np.where(small, np.ones_like(sq), sq))
    half = 0.5 * angle
    sin_half_over = np.where(small, 0.5 - sq / 48.0, np.sin(half) / angle)
    cos_half = np.where(small, 1.0 - sq / 8.0, np.cos(half))
    return np.concatenate([cos_half, axis_angle * sin_half_over], axis=-1)
