"""Joints -> rotation-invariant features (Rifke, Holden et al.).

Host-side numpy: the counterpart of ``ladiff_tpu/transforms/joints2jfeats.py``,
line for line.

Rebuild of the reference's ladiff/transforms/joints2jfeats/{rifke.py,
tools.py,base.py}: floor alignment, root factoring, facing normalization,
velocity encoding — forward and exact inverse.  numpy, arbitrary leading
batch dims (frames axis is -2 of the trajectory / -3 of joints).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ladiff_torch.transforms.geometry import matrix_of_angles, softmin
from ladiff_torch.utils.joints import joints_of

__all__ = ["Rifke", "get_forward_direction", "get_floor",
           "gaussian_filter1d"]


def get_floor(poses: np.ndarray, jointstype: str = "mmm") -> np.ndarray:
    """Soft minimum of the foot-joint heights over time, shaped [..., 1, 1]
    to broadcast against [..., T, J] heights (reference tools.py:33-48)."""
    names = joints_of(jointstype)
    idx = [names.index(n) for n in ("LMrot", "LF", "RMrot", "RF")]
    foot_heights = poses[..., idx, 1].min(-1)
    floor = softmin(foot_heights, softness=0.5, axis=-1)
    return floor[..., None, None]


def get_forward_direction(poses: np.ndarray,
                          jointstype: str = "mmm") -> np.ndarray:
    """Unit XZ facing direction from shoulders+hips
    (reference tools.py:14-30)."""
    names = joints_of(jointstype)
    LS, RS = names.index("LS"), names.index("RS")
    LH, RH = names.index("LH"), names.index("RH")
    across = (poses[..., RH, :] - poses[..., LH, :]
              + poses[..., RS, :] - poses[..., LS, :])
    forward = np.stack((-across[..., 2], across[..., 0]), -1)
    return forward / np.linalg.norm(forward, axis=-1, keepdims=True)


def gaussian_filter1d(x: np.ndarray, sigma: float) -> np.ndarray:
    """Same-padded gaussian smoothing over the frames axis (-2)
    (reference tools.py:58-87)."""
    width = int(4 * sigma + 0.5)
    t = np.arange(-width, width + 1, dtype=np.float64)
    kernel = np.exp(-0.5 / (sigma ** 2) * t ** 2)
    kernel = kernel / kernel.sum()
    xp = np.moveaxis(x, -2, -1)
    pad = np.concatenate([xp[..., 1:width + 1][..., ::-1], xp,
                          xp[..., -width - 1:-1][..., ::-1]], -1)
    out = np.apply_along_axis(
        lambda row: np.convolve(row, kernel, mode="valid"), -1, pad)
    return np.moveaxis(out, -1, -2)


class Rifke:
    """Forward/inverse Rifke featurization (reference rifke.py:11-142).

    Features: [root_y, local_poses ((J-1)*3), vel_angle, local_vel_traj (2)].
    """

    def __init__(self, jointstype: str = "mmm",
                 path: Optional[str] = None, normalization: bool = False,
                 forward_filter: bool = False, eps: float = 1e-12) -> None:
        if jointstype not in ("mmm", "mmmns", "humanml3d"):
            raise NotImplementedError("This jointstype is not implemented.")
        self.jointstype = jointstype
        self.forward_filter = forward_filter
        self.normalization = normalization
        self.eps = eps
        if normalization:
            if path is None:
                raise TypeError("provide a path when normalization is on")
            self.mean = np.load(f"{path}/jfeats_mean.npy")
            self.std = np.load(f"{path}/jfeats_std.npy")

    def normalize(self, features):
        if self.normalization:
            features = (features - self.mean) / (self.std + self.eps)
        return features

    def unnormalize(self, features):
        if self.normalization:
            features = features * self.std + self.mean
        return features

    def __call__(self, joints: np.ndarray) -> np.ndarray:
        return self.forward(joints)

    def forward(self, joints: np.ndarray) -> np.ndarray:
        poses = np.asarray(joints, np.float64).copy()
        poses[..., 1] -= get_floor(poses, jointstype=self.jointstype)

        translation = poses[..., 0, :].copy()
        root_y = translation[..., 1]
        trajectory = translation[..., [0, 2]]

        poses = poses[..., 1:, :]
        poses[..., [0, 2]] -= trajectory[..., None, :]

        vel_trajectory = np.diff(trajectory, axis=-2)
        vel_trajectory = np.concatenate(
            (0 * vel_trajectory[..., [0], :], vel_trajectory), -2)

        forward = get_forward_direction(poses, jointstype=self.jointstype)
        if self.forward_filter:
            forward = gaussian_filter1d(forward, 2)
            forward = forward / np.linalg.norm(forward, axis=-1,
                                               keepdims=True)

        angles = np.arctan2(forward[..., 0], forward[..., 1])
        vel_angles = np.diff(angles, axis=-1)
        vel_angles = np.concatenate((0 * vel_angles[..., [0]], vel_angles),
                                    -1)

        sin, cos = forward[..., 0], forward[..., 1]
        rotations_inv = matrix_of_angles(cos, sin, inv=True)

        poses_local = np.einsum("...lj,...jk->...lk", poses[..., [0, 2]],
                                rotations_inv)
        poses_local = np.stack(
            (poses_local[..., 0], poses[..., 1], poses_local[..., 1]), -1)
        poses_features = poses_local.reshape(
            poses_local.shape[:-2] + (-1,))

        vel_trajectory_local = np.einsum("...j,...jk->...k", vel_trajectory,
                                         rotations_inv)

        features = np.concatenate(
            (root_y[..., None], poses_features, vel_angles[..., None],
             vel_trajectory_local), -1)
        return self.normalize(features)

    def inverse(self, features: np.ndarray) -> np.ndarray:
        features = self.unnormalize(np.asarray(features, np.float64))
        root_y, poses_features, vel_angles, vel_trajectory_local = \
            self.extract(features)

        angles = np.cumsum(vel_angles, axis=-1)
        angles = angles - angles[..., [0]]
        cos, sin = np.cos(angles), np.sin(angles)
        rotations = matrix_of_angles(cos, sin, inv=False)

        poses_local = poses_features.reshape(
            poses_features.shape[:-1] + (-1, 3))
        poses = np.einsum("...lj,...jk->...lk", poses_local[..., [0, 2]],
                          rotations)
        poses = np.stack(
            (poses[..., 0], poses_local[..., 1], poses[..., 1]), -1)

        vel_trajectory = np.einsum("...j,...jk->...k", vel_trajectory_local,
                                   rotations)
        trajectory = np.cumsum(vel_trajectory, axis=-2)
        trajectory = trajectory - trajectory[..., [0], :]

        poses = np.concatenate((0 * poses[..., [0], :], poses), -2)
        poses[..., 0, 1] = root_y
        poses[..., [0, 2]] += trajectory[..., None, :]
        return poses

    def extract(self, features: np.ndarray):
        root_y = features[..., 0]
        poses_features = features[..., 1:-3]
        vel_angles = features[..., -3]
        vel_trajectory_local = features[..., -2:]
        return root_y, poses_features, vel_angles, vel_trajectory_local
