"""SMPL rotations -> rotation features (SMPLVelP).

Host-side numpy: the counterpart of ``ladiff_tpu/transforms/rots2rfeats.py``,
line for line.

Rebuild of the reference's ladiff/transforms/rots2rfeats/{smplvelp.py,
base.py}: features are [root_height, XZ velocity (2), per-joint rotations
(rot6d by default)], with optional facing canonicalization of the global
orientation.  numpy, arbitrary leading batch dims.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ladiff_torch.transforms.geometry import (axis_angle_to_matrix,
                                            matrix_to, matrix_to_axis_angle,
                                            nfeats_of, to_matrix)

__all__ = ["SMPLVelP"]


class SMPLVelP:
    """reference smplvelp.py:13-101 (forward/extract/inverse)."""

    def __init__(self, path: Optional[str] = None,
                 normalization: bool = False, pose_rep: str = "rot6d",
                 canonicalize: bool = False, offset: bool = True,
                 eps: float = 1e-12) -> None:
        self.canonicalize = canonicalize
        self.pose_rep = pose_rep
        self.nfeats = nfeats_of(pose_rep)
        self.offset = offset
        self.normalization = normalization
        self.eps = eps
        if normalization:
            if path is None:
                raise TypeError("provide a path when normalization is on")
            self.mean = np.load(f"{path}/rfeats_mean.npy")
            self.std = np.load(f"{path}/rfeats_std.npy")

    def normalize(self, features):
        if self.normalization:
            features = (features - self.mean) / (self.std + self.eps)
        return features

    def unnormalize(self, features):
        if self.normalization:
            features = features * self.std + self.mean
        return features

    def __call__(self, data):
        return self.forward(data)

    def forward(self, data) -> np.ndarray:
        """data: RotTransDatastruct with .rots [..., J, 3, 3] matrix poses
        and .trans [..., 3] (gravity axis = last coordinate)."""
        matrix_poses = np.asarray(data.rots, np.float64)
        trans = np.asarray(data.trans, np.float64)

        root_y = trans[..., 2]
        trajectory = trans[..., [0, 1]]

        vel_trajectory = np.diff(trajectory, axis=-2)
        vel_trajectory = np.concatenate(
            (0 * vel_trajectory[..., [0], :], vel_trajectory), -2)

        if self.canonicalize:
            global_orient = matrix_poses[..., 0, :, :]
            # vertical component of the FIRST frame's rotation only
            rot2d = matrix_to_axis_angle(global_orient[..., 0, :, :])
            rot2d[..., :2] = 0
            if self.offset:
                rot2d[..., 2] += np.pi / 2
            rot2d = axis_angle_to_matrix(rot2d)  # [..., 3, 3] (no frame axis)

            # rotate every frame's global orientation by the same amount
            global_orient = np.einsum("...kj,...kl->...jl",
                                      rot2d[..., None, :, :], global_orient)
            matrix_poses = np.concatenate(
                (global_orient[..., None, :, :],
                 matrix_poses[..., 1:, :, :]), -3)

            vel_trajectory = np.einsum(
                "...kj,...lk->...lj", rot2d[..., :2, :2], vel_trajectory)

        poses = matrix_to(self.pose_rep, matrix_poses)
        features = np.concatenate(
            (root_y[..., None], vel_trajectory,
             poses.reshape(poses.shape[:-2] + (-1,))), -1)
        return self.normalize(features)

    def extract(self, features: np.ndarray):
        root_y = features[..., 0]
        vel_trajectory = features[..., 1:3]
        poses_features = features[..., 3:]
        poses = poses_features.reshape(
            poses_features.shape[:-1] + (-1, self.nfeats))
        return root_y, vel_trajectory, poses

    def inverse(self, features: np.ndarray):
        from ladiff_torch.transforms.smpl import RotTransDatastruct

        features = self.unnormalize(np.asarray(features, np.float64))
        root_y, vel_trajectory, poses = self.extract(features)

        trajectory = np.cumsum(vel_trajectory, axis=-2)
        trajectory = trajectory - trajectory[..., [0], :]

        trans = np.concatenate([trajectory, root_y[..., None]], -1)
        matrix_poses = to_matrix(self.pose_rep, poses)
        return RotTransDatastruct(rots=matrix_poses, trans=trans)
