"""SMPL body model: linear blend skinning (counterpart of the SMPL part of
``ladiff_tpu/smpl/body_model.py``).

Shape blendshapes, pose blendshapes, joint regression, the rigid transforms
down the kinematic chain and LBS, differentiable.  The model's tensors load
from a standard SMPL ``.pkl`` / ``.npz`` (``SMPLModel.load``, e.g.
``deps/smpl_models/smpl/SMPL_NEUTRAL.pkl``); without one,
``SMPLModel.synthetic`` builds a small random but consistent model, drawing
from ``np.random.RandomState(seed)`` in the JAX package's order, so both
packages build the same body from the same seed.  The tensors are float32
buffers that the state dict does not carry.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch
from torch import nn

from ladiff_torch.data.humanml.quaternion import (axis_angle_to_quaternion,
                                                  quaternion_to_matrix)

__all__ = ["SMPLModel", "SMPL_PARENTS"]

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21], np.int64)


class SMPLModel(nn.Module):
    def __init__(self, v_template, shapedirs, posedirs, J_regressor, weights,
                 parents=SMPL_PARENTS):
        """v_template [V, 3], shapedirs [V, 3, n_betas], posedirs [(J-1)*9,
        V*3], J_regressor [J, V], weights [V, J], parents [J] (-1 at the
        root)."""
        super().__init__()
        for name, v in (("v_template", v_template), ("shapedirs", shapedirs),
                        ("posedirs", posedirs), ("J_regressor", J_regressor),
                        ("weights", weights)):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(v, np.float32)), persistent=False)
        self.parents = np.asarray(parents, np.int64)

    @property
    def num_joints(self) -> int:
        return int(self.J_regressor.shape[0])

    @classmethod
    def load(cls, path: str) -> Optional["SMPLModel"]:
        """A standard SMPL pickle / npz (e.g. SMPL_NEUTRAL.pkl), or None
        where there is no such file."""
        if not os.path.exists(path):
            return None
        if path.endswith(".npz"):
            d = dict(np.load(path, allow_pickle=True))
        else:
            with open(path, "rb") as f:
                d = pickle.load(f, encoding="latin1")

        def arr(x):
            if hasattr(x, "todense"):
                x = np.asarray(x.todense())
            return np.asarray(np.asarray(x, np.float64), np.float32)

        parents = SMPL_PARENTS
        if "kintree_table" in d:
            parents = np.asarray(d["kintree_table"][0], np.int64)
            parents[0] = -1
        posedirs = np.asarray(d["posedirs"])
        if posedirs.ndim == 3:
            # on disk [V, 3, (J-1)*9]; forward takes [(J-1)*9, V*3]: the
            # (v, c) axes flattened into columns first, then transposed
            posedirs = posedirs.reshape(
                np.asarray(d["v_template"]).size, -1).T
        return cls(arr(d["v_template"]),
                   arr(np.asarray(d["shapedirs"])[..., :10]), arr(posedirs),
                   arr(d["J_regressor"]), arr(d["weights"]), parents)

    @classmethod
    def synthetic(cls, n_verts: int = 128, seed: int = 0) -> "SMPLModel":
        """A small random SMPL-24 body: the JAX package's
        ``SMPLModel.synthetic(n_verts, seed)`` draw for draw."""
        rng = np.random.RandomState(seed)
        J = len(SMPL_PARENTS)
        v = rng.randn(n_verts, 3).astype(np.float32) * 0.3
        reg = rng.rand(J, n_verts).astype(np.float32)
        reg /= reg.sum(1, keepdims=True)
        w = rng.rand(n_verts, J).astype(np.float32) ** 4
        w /= w.sum(1, keepdims=True)
        shapedirs = (rng.randn(n_verts, 3, 10) * 0.01).astype(np.float32)
        posedirs = (rng.randn((J - 1) * 9, n_verts * 3) * 0.001).astype(
            np.float32)
        return cls(v, shapedirs, posedirs, reg, w)

    def forward(self, pose_aa: torch.Tensor, betas: torch.Tensor,
                trans: Optional[torch.Tensor] = None,
                return_vertices: bool = False):
        """LBS from axis-angle poses [T, J, 3] (betas [10], trans [T, 3]):
        joints [T, J, 3], and with ``return_vertices`` (joints, vertices
        [T, V, 3])."""
        rot = quaternion_to_matrix(axis_angle_to_quaternion(pose_aa))
        return self.forward_matrices(rot, betas, trans, return_vertices)

    def forward_matrices(self, rot: torch.Tensor, betas: torch.Tensor,
                         trans: Optional[torch.Tensor] = None,
                         return_vertices: bool = False):
        """LBS from rotation matrices rot [T, J, 3, 3]; as ``forward``."""
        T, J = rot.shape[0], self.num_joints
        v_shaped = self.v_template + torch.einsum("vdb,b->vd",
                                                  self.shapedirs, betas)
        j_rest = self.J_regressor @ v_shaped                     # [J, 3]
        parents = torch.as_tensor(self.parents[1:], device=rot.device)
        rel_j = torch.cat([j_rest[:1], j_rest[1:] - j_rest[parents]])

        def make_tf(R, t):
            top = torch.cat([R, t[..., None]], dim=-1)          # [T, 3, 4]
            bottom = torch.zeros(T, 1, 4, dtype=R.dtype, device=R.device)
            bottom[..., 3] = 1.0
            return torch.cat([top, bottom], dim=-2)

        transforms = [make_tf(rot[:, 0], rel_j[0].expand(T, 3))]
        for j in range(1, J):
            local = make_tf(rot[:, j], rel_j[j].expand(T, 3))
            transforms.append(transforms[self.parents[j]] @ local)
        A = torch.stack(transforms, dim=1)                       # [T, J, 4, 4]
        joints = A[..., :3, 3]
        if trans is not None:
            joints = joints + trans[:, None, :]
        if not return_vertices:
            return joints

        # pose blendshapes from the non-root rotations
        eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
        pose_feat = (rot[:, 1:] - eye).reshape(T, -1)            # [T, (J-1)*9]
        v_posed = v_shaped[None] + (pose_feat @ self.posedirs).reshape(
            T, -1, 3)
        # skinning transforms: the rest-pose joint offset taken out
        correction = torch.einsum("tjab,jb->tja", A[..., :3, :3], j_rest)
        A_skin = torch.cat([A[..., :3, :3], (A[..., :3, 3] - correction)[
            ..., None]], dim=-1)                                 # [T, J, 3, 4]
        Tmat = torch.einsum("vj,tjab->tvab", self.weights, A_skin)
        verts = (torch.einsum("tvab,tvb->tva", Tmat[..., :3], v_posed)
                 + Tmat[..., 3])
        if trans is not None:
            verts = verts + trans[:, None, :]
        return joints, verts
