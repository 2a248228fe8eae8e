"""SMPL-H rotations -> joints / vertices (counterpart of
``ladiff_tpu/transforms/rots2joints.py``).

Runs the SMPL-H body model on [..., 22|52, 3, 3] matrix poses (the mean hand
pose filled in where the hands are absent), then remaps the output topology
(``mmm`` / ``mmmns`` / ``smplmmm`` / ``smplnh`` / ``smplh`` / ``vertices``)
with the MMM scale and axis conventions and centres every sequence on its
first frame's root.  The LBS runs in PyTorch on the module's device (the
card unless ``device="cpu"``), all frames in one call; the poses come in
and the joints go out as numpy, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ladiff_torch.smpl.body_model import SMPLModel
from ladiff_torch.transforms.geometry import axis_angle_to_matrix
from ladiff_torch.utils.device import resolve_device
from ladiff_torch.utils.joints import (get_root_idx, smplh_extra_vertex_ids,
                                       smplh_indexes,
                                       smplh_to_mmm_scaling_factor)

__all__ = ["SMPLH", "smplh_to"]


class SMPLH:
    def __init__(self, path: str = "deps/smplh/SMPLH_NEUTRAL.npz",
                 jointstype: str = "mmm", device=None,
                 model: Optional[SMPLModel] = None) -> None:
        """The SMPL-H body from ``path``, a synthetic one where the file is
        absent (or ``model`` as given), on ``device``; every frame runs in
        one call."""
        self.jointstype = jointstype
        self.device = resolve_device(device)
        if model is None:
            model = SMPLModel.load(path)
        if model is None:
            model = SMPLModel.synthetic(model_type="smplh")
        self.model = model.to(self.device)

    @functools.cached_property
    def _hands_mean_matrix(self) -> np.ndarray:
        hands_mean = self.model.hands_mean
        if hands_mean is None:
            hands_mean = np.zeros((30, 3), np.float32)
        return axis_angle_to_matrix(hands_mean)  # [30, 3, 3]

    def __call__(self, smpl_data, jointstype: Optional[str] = None):
        return self.forward(smpl_data, jointstype)

    def forward(self, smpl_data, jointstype: Optional[str] = None,
                betas: Optional[np.ndarray] = None) -> np.ndarray:
        jointstype = self.jointstype if jointstype is None else jointstype
        poses = np.asarray(smpl_data.rots, np.float64)  # [..., J, 3, 3]
        trans = smpl_data.trans
        save_shape = poses.shape[:-3]
        nposes = int(np.prod(save_shape)) if save_shape else 1

        if poses.shape[-3] == 52:
            matrix_poses = poses.reshape((nposes, 52, 3, 3))
        elif poses.shape[-3] == 22:
            body = poses.reshape((nposes, 22, 3, 3))
            hands = np.broadcast_to(self._hands_mean_matrix,
                                    (nposes, 30, 3, 3))
            matrix_poses = np.concatenate([body, hands], axis=1)
        else:
            raise NotImplementedError("Could not parse the poses.")

        if trans is None:
            trans_all = np.zeros((nposes, 3), np.float32)
            trans = np.zeros(save_shape + (3,), np.float32)
        else:
            trans = np.asarray(trans, np.float64)
            trans_all = trans.reshape((nposes, 3))
        if betas is None:
            betas = np.zeros((10,), np.float32)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        with torch.no_grad():
            joints52, verts = self.model.forward_matrices(
                dev(matrix_poses), dev(betas), dev(trans_all),
                return_vertices=True)
        verts = verts.cpu().double().numpy()
        if jointstype == "vertices":
            out = verts
        else:
            # the 21 vertex keypoints (face, feet, finger tips) after the 52
            # LBS joints; the ids wrap on a synthetic body with fewer
            # vertices than SMPL-H's 6890
            extra = verts[:, smplh_extra_vertex_ids % verts.shape[1]]
            out = np.concatenate([joints52.cpu().double().numpy(), extra],
                                 axis=1)
        out = out.reshape(save_shape + out.shape[1:])
        return smplh_to(jointstype, out, trans)

    def inverse(self, joints):
        raise NotImplementedError("Cannot inverse SMPLH layer.")


def smplh_to(jointstype: str, data: np.ndarray,
             trans: np.ndarray) -> np.ndarray:
    """Topology remap + centring on the first frame's root."""
    if "mmm" in jointstype:
        data = data[..., smplh_indexes["mmm"], :]
        if jointstype == "mmm":
            data = data * smplh_to_mmm_scaling_factor
        if jointstype == "smplmmm":
            pass
        elif jointstype in ("mmm", "mmmns"):
            data = data[..., [1, 2, 0]]
            data = data.copy()
            data[..., 2] = -data[..., 2]
    elif jointstype == "smplnh":
        data = data[..., smplh_indexes["smplnh"], :]
    elif jointstype in ("smplh", "vertices"):
        pass
    else:
        raise NotImplementedError(f"SMPLH to {jointstype} is not implemented.")

    if jointstype != "vertices":
        root_joint_idx = get_root_idx(jointstype)
        shift = trans[..., 0, :] - data[..., 0, root_joint_idx, :]
        data = data + shift[..., None, None, :]
    return data
