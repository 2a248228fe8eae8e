"""SMPL-family body models: linear blend skinning (counterpart of
``ladiff_tpu/smpl/body_model.py``).

Shape blendshapes, pose blendshapes, joint regression, the rigid transforms
down the kinematic chain and LBS, differentiable.  One class serves SMPL
(24 joints), SMPL-H (52), SMPL-X's LBS chain (55), MANO (16: ``load_mano``,
``forward_mano`` with the PCA basis and the mean hand) and FLAME (5:
``load_flame``, ``forward_flame`` with the expression blendshapes).  The
model's tensors load from a standard ``.pkl`` / ``.npz`` (``SMPLModel.load``,
e.g. ``deps/smpl_models/smpl/SMPL_NEUTRAL.pkl``); without one,
``SMPLModel.synthetic`` builds a small random but consistent model, drawing
from ``np.random.RandomState(seed)`` in the JAX package's order, so both
packages build the same body from the same seed.  The tensors are float32
buffers that the state dict does not carry; the parents and SMPL-H's mean
hand pose stay numpy (host-side tables).
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

__all__ = ["SMPLModel", "SMPL_PARENTS", "SMPLH_PARENTS", "SMPLX_PARENTS",
           "MANO_PARENTS", "FLAME_PARENTS"]

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21], np.int64)

# SMPL-H: SMPL's 22 body joints (no hand roots) + 15 joints per hand, three
# per finger in index / middle / pinky / ring / thumb order
SMPLH_PARENTS = np.concatenate([
    SMPL_PARENTS[:22],
    np.array([20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
              21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50],
             np.int64),
])

# SMPL-X: SMPL-H's body + jaw / left eye / right eye under the head (15) +
# the same two hands shifted by the 3 face joints: 55 LBS joints
_SMPLH_HANDS = SMPLH_PARENTS[22:]
SMPLX_PARENTS = np.concatenate([
    SMPL_PARENTS[:22], np.array([15, 15, 15], np.int64),
    np.where(_SMPLH_HANDS >= 22, _SMPLH_HANDS + 3, _SMPLH_HANDS),
]).astype(np.int64)

# MANO: wrist + 15 finger joints, 3 per finger
MANO_PARENTS = np.array(
    [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], np.int64)

# FLAME: global, neck, then jaw / left eye / right eye under the neck
FLAME_PARENTS = np.array([-1, 0, 1, 1, 1], np.int64)

_PARENTS = {"smpl": SMPL_PARENTS, "smplh": SMPLH_PARENTS,
            "smplx": SMPLX_PARENTS, "mano": MANO_PARENTS,
            "flame": FLAME_PARENTS}


def _read(path: str) -> dict:
    if path.endswith(".npz"):
        return dict(np.load(path, allow_pickle=True))
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _f32(x) -> np.ndarray:
    if hasattr(x, "todense"):
        x = np.asarray(x.todense())
    return np.asarray(np.asarray(x, np.float64), np.float32)


class SMPLModel(nn.Module):
    def __init__(self, v_template, shapedirs, posedirs, J_regressor, weights,
                 parents=SMPL_PARENTS, hands_mean=None, hand_components=None,
                 hand_mean=None, expr_dirs=None):
        """v_template [V, 3], shapedirs [V, 3, n_betas], posedirs [(J-1)*9,
        V*3], J_regressor [J, V], weights [V, J], parents [J] (-1 at the
        root); SMPL-H / SMPL-X: hands_mean [30, 3] axis-angle (left; right);
        MANO: hand_components [45, 45] (the PCA basis, rows) and hand_mean
        [45]; FLAME: expr_dirs [V, 3, n_expr]."""
        super().__init__()
        for name, v in (("v_template", v_template), ("shapedirs", shapedirs),
                        ("posedirs", posedirs), ("J_regressor", J_regressor),
                        ("weights", weights),
                        ("hand_components", hand_components),
                        ("hand_mean", hand_mean), ("expr_dirs", expr_dirs)):
            self.register_buffer(name, None if v is None else torch.from_numpy(
                np.array(v, np.float32)), persistent=False)
        self.parents = np.asarray(parents, np.int64)
        # the parents as a device index (no host copy in the forward)
        self.register_buffer("parent_index", torch.as_tensor(
            self.parents[1:]), persistent=False)
        self.hands_mean = (None if hands_mean is None
                           else np.asarray(hands_mean, np.float32))

    @property
    def num_joints(self) -> int:
        return int(self.J_regressor.shape[0])

    # -- loading -----------------------------------------------------------
    @classmethod
    def load(cls, path: str, **extra) -> Optional["SMPLModel"]:
        """A standard SMPL / SMPL-H pickle or npz (e.g. SMPL_NEUTRAL.pkl,
        SMPLH_NEUTRAL.npz with its mean hands), or None where there is no
        such file."""
        if not os.path.exists(path):
            return None
        d = _read(path)
        parents = SMPL_PARENTS
        if "kintree_table" in d:
            parents = np.asarray(d["kintree_table"][0], np.int64)
            parents[0] = -1
        hands_mean = None
        if "hands_meanl" in d:
            hands_mean = np.concatenate([
                np.asarray(d["hands_meanl"], np.float64),
                np.asarray(d["hands_meanr"], np.float64),
            ]).reshape(30, 3).astype(np.float32)
        posedirs = np.asarray(d["posedirs"])
        if posedirs.ndim == 3:
            # on disk [V, 3, (J-1)*9]; forward takes [(J-1)*9, V*3]: the
            # (v, c) axes flattened into columns first, then transposed
            posedirs = posedirs.reshape(
                np.asarray(d["v_template"]).size, -1).T
        return cls(_f32(d["v_template"]),
                   _f32(np.asarray(d["shapedirs"])[..., :10]), _f32(posedirs),
                   _f32(d["J_regressor"]), _f32(d["weights"]), parents,
                   hands_mean=hands_mean, **extra)

    @classmethod
    def load_mano(cls, path: str) -> Optional["SMPLModel"]:
        """A MANO_RIGHT / MANO_LEFT pickle: the full 45 x 45 PCA basis
        ``hands_components`` and the mean hand pose kept for
        ``forward_mano``."""
        if not os.path.exists(path):
            return None
        d = _read(path)
        return cls.load(
            path,
            hand_components=np.asarray(d["hands_components"], np.float32),
            hand_mean=np.asarray(d["hands_mean"], np.float32).reshape(-1))

    @classmethod
    def load_flame(cls, path: str,
                   num_expression_coeffs: int = 10) -> Optional["SMPLModel"]:
        """A FLAME pickle / npz: its shape space holds 300 shape + 100
        expression columns; the first 10 stay the shape blendshapes and the
        expression block becomes ``expr_dirs`` (a reduced 10 + 10 model
        takes its columns 10 to 20)."""
        if not os.path.exists(path):
            return None
        shapedirs = np.asarray(_read(path)["shapedirs"], np.float64)
        if shapedirs.shape[-1] < 300 + 100:
            start, end = 10, 10 + min(num_expression_coeffs, 10)
        else:
            start, end = 300, 300 + min(num_expression_coeffs, 100)
        return cls.load(path, expr_dirs=np.asarray(
            shapedirs[..., start:end], np.float32))

    @classmethod
    def synthetic(cls, n_verts: int = 128, seed: int = 0,
                  model_type: str = "smpl") -> "SMPLModel":
        """A small random body of ``model_type`` ("smpl", "smplh", "smplx",
        "mano", "flame"): the JAX package's ``SMPLModel.synthetic`` draw for
        draw (MANO's basis and mean, FLAME's expressions drawn before the
        shape and pose blendshapes)."""
        rng = np.random.RandomState(seed)
        parents = _PARENTS[model_type]
        J = len(parents)
        v = rng.randn(n_verts, 3).astype(np.float32) * 0.3
        reg = rng.rand(J, n_verts).astype(np.float32)
        reg /= reg.sum(1, keepdims=True)
        w = rng.rand(n_verts, J).astype(np.float32) ** 4
        w /= w.sum(1, keepdims=True)
        extra = {}
        if model_type == "mano":
            q, _ = np.linalg.qr(rng.randn(45, 45))
            extra["hand_components"] = q.astype(np.float32)
            extra["hand_mean"] = (rng.randn(45) * 0.05).astype(np.float32)
        if model_type == "flame":
            extra["expr_dirs"] = (rng.randn(n_verts, 3, 10) * 0.01).astype(
                np.float32)
        if model_type in ("smplh", "smplx"):
            extra["hands_mean"] = np.zeros((30, 3), np.float32)
        shapedirs = (rng.randn(n_verts, 3, 10) * 0.01).astype(np.float32)
        posedirs = (rng.randn((J - 1) * 9, n_verts * 3) * 0.001).astype(
            np.float32)
        return cls(v, shapedirs, posedirs, reg, w, parents, **extra)

    # -- forwards ----------------------------------------------------------
    def forward(self, pose_aa: torch.Tensor, betas: torch.Tensor,
                trans: Optional[torch.Tensor] = None,
                return_vertices: bool = False,
                expression: Optional[torch.Tensor] = None):
        """LBS from axis-angle poses [T, J, 3] (betas [10], trans [T, 3],
        FLAME's expression [n_expr]): joints [T, J, 3], and with
        ``return_vertices`` (joints, vertices [T, V, 3])."""
        rot = quaternion_to_matrix(axis_angle_to_quaternion(pose_aa))
        return self.forward_matrices(rot, betas, trans, return_vertices,
                                     expression)

    def forward_mano(self, global_orient: torch.Tensor,
                     hand_pose: torch.Tensor, betas: torch.Tensor,
                     trans: Optional[torch.Tensor] = None,
                     use_pca: bool = True, flat_hand_mean: bool = False,
                     return_vertices: bool = False):
        """MANO: global_orient [T, 3]; hand_pose [T, P] PCA coordinates (P
        <= 45) with ``use_pca``, else [T, 45] axis-angle; the mean hand is
        added unless ``flat_hand_mean``."""
        if use_pca:
            hand_pose = hand_pose @ self.hand_components[:hand_pose.shape[-1]]
        if not flat_hand_mean and self.hand_mean is not None:
            hand_pose = hand_pose + self.hand_mean
        full = torch.cat([global_orient, hand_pose], dim=-1)
        return self.forward(full.reshape(full.shape[0], -1, 3), betas, trans,
                            return_vertices=return_vertices)

    def forward_flame(self, global_orient, neck_pose, jaw_pose, leye_pose,
                      reye_pose, betas, expression=None, trans=None,
                      return_vertices: bool = False):
        """FLAME: the five [T, 3] axis-angle rotations (global, neck, jaw,
        eyes); expression coefficients blend through ``expr_dirs`` as the
        betas blend through ``shapedirs``."""
        full = torch.stack([global_orient, neck_pose, jaw_pose, leye_pose,
                            reye_pose], dim=1)
        return self.forward(full, betas, trans,
                            return_vertices=return_vertices,
                            expression=expression)

    def forward_matrices(self, rot: torch.Tensor, betas: torch.Tensor,
                         trans: Optional[torch.Tensor] = None,
                         return_vertices: bool = False,
                         expression: Optional[torch.Tensor] = None):
        """LBS from rotation matrices rot [T, J, 3, 3]; as ``forward``."""
        T, J = rot.shape[0], self.num_joints
        v_shaped = self.v_template + torch.einsum("vdb,b->vd",
                                                  self.shapedirs, betas)
        if expression is not None and self.expr_dirs is not None:
            v_shaped = v_shaped + torch.einsum(
                "vdb,b->vd", self.expr_dirs[..., :expression.shape[-1]],
                expression)
        j_rest = self.J_regressor @ v_shaped                     # [J, 3]
        rel_j = torch.cat([j_rest[:1],
                           j_rest[1:] - j_rest[self.parent_index]])

        # every joint's local transform at once, then one product a joint
        # down the chain (the chain is the many small launches of a fit)
        top = torch.cat([rot, rel_j.expand(T, J, 3)[..., None]], dim=-1)
        bottom = torch.zeros(T, J, 1, 4, dtype=rot.dtype, device=rot.device)
        bottom[..., 3] = 1.0
        local = torch.cat([top, bottom], dim=-2)                 # [T, J, 4, 4]
        transforms = [local[:, 0]]
        for j in range(1, J):
            transforms.append(transforms[self.parents[j]] @ local[:, j])
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
