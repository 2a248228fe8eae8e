"""rot6d (+ translation) motion features -> SMPL joints or vertices
(counterpart of ``ladiff_tpu/transforms/rotation2xyz.py``).

The action family reads its features two ways:

  * ``feats2joints_action_eval``: ``jointstype="smpl"``, ``vertstrans=True``:
    24 x 3 SMPL joints for the HumanAct12 GRU classifier (input 72);
  * ``feats2joints_action``: ``jointstype="vertices"``, ``vertstrans=False``:
    SMPL vertices for the stage-1 ``recons_joints`` loss.

Semantics, as the JAX package and the reference have them:

  * features [B, T, 6 (J + 1)] unpack CHANNEL-major (feature ``c (J + 1) +
    v`` is channel c of node v); the last node's first three channels carry
    the frame's translation, the first J nodes are rot6d rotations, node 0
    the global orient; betas are zero;
  * masked frames take the identity's rot6d before Gram-Schmidt (zeros
    would give NaN), and every frame runs through the LBS;
  * the outputs are zeroed on masked frames BEFORE the per-frame
    root-centering at joint 0 (not for vertices);
  * with ``vertstrans`` the translation is re-centred at frame 0 and added
    to every frame, masked ones too.

Returns batch-first [B, T, Jout, 3]; flattening the last two axes gives the
``j * 3 + coord`` order that the GRU classifier reads.  In float32 whatever
the features' type.  ``frame_chunk`` bounds the skinning tensor [frames, V,
3, 4] of a real 6890-vertex model by running the frames in chunks.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from ladiff_torch.smpl.body_model import SMPLModel

__all__ = ["Rotation2xyz", "rotation_6d_to_matrix"]


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt (Zhou et al.): the rows are
    the normalized first 3-vector, the second made orthogonal to it, and
    their cross product."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    a2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2 / torch.linalg.norm(a2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


class Rotation2xyz(nn.Module):
    """Callable (feats, mask) -> joints / vertices over a fixed SMPL
    model."""

    def __init__(self, smpl: SMPLModel, frame_chunk: int = 0):
        super().__init__()
        self.smpl = smpl
        self.frame_chunk = frame_chunk

    @classmethod
    def from_path(cls, smpl_path: str,
                  frame_chunk: Optional[int] = None) -> "Rotation2xyz":
        """``<smpl_path>/SMPL_NEUTRAL.pkl``, or where it is absent
        ``SMPLModel.synthetic()`` (the licensed body is not in the
        repository); a real model runs its frames in chunks of 64."""
        model = SMPLModel.load(os.path.join(smpl_path, "SMPL_NEUTRAL.pkl"))
        synthetic = model is None
        if synthetic:
            model = SMPLModel.synthetic()
        if frame_chunk is None:
            frame_chunk = 0 if synthetic else 64
        return cls(model, frame_chunk)

    @property
    def is_synthetic(self) -> bool:
        return int(self.smpl.v_template.shape[0]) < 1000

    def forward(self, feats: torch.Tensor, mask: Optional[torch.Tensor],
                jointstype: str = "smpl", vertstrans: bool = True
                ) -> torch.Tensor:
        """[B, T, 6 (J + 1)] rot6d features with the global orient and the
        translation (and a [B, T] bool mask) -> [B, T, Jout, 3];
        ``jointstype`` "smpl" (24 joints) or "vertices"."""
        if jointstype not in ("smpl", "vertices"):
            raise NotImplementedError("This jointstype is not implemented.")
        B, T, Fd = feats.shape
        n_nodes = Fd // 6
        J = n_nodes - 1
        if mask is None:
            mask = torch.ones(B, T, dtype=torch.bool, device=feats.device)
        x = feats.float().reshape(B, T, 6, n_nodes)
        trans = x[:, :, :3, J]                                   # [B, T, 3]
        rot6d = x[:, :, :, :J].transpose(2, 3)                  # [B, T, J, 6]
        identity = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                                device=feats.device)
        safe = torch.where(mask[:, :, None, None], rot6d, identity)
        flat = rotation_6d_to_matrix(safe).reshape(B * T, J, 3, 3)
        betas = torch.zeros(10, device=feats.device)
        verts = jointstype == "vertices"

        def lbs(rots):
            out = self.smpl.forward_matrices(rots, betas,
                                             return_vertices=verts)
            return out[1] if verts else out

        if self.frame_chunk:
            out = torch.cat([lbs(c) for c in flat.split(self.frame_chunk)])
        else:
            out = lbs(flat)
        xyz = out.reshape(B, T, out.shape[1], 3)
        xyz = torch.where(mask[:, :, None, None], xyz,
                          torch.zeros((), device=xyz.device))
        if not verts:
            xyz = xyz - xyz[:, :, :1, :]
        if vertstrans:
            xyz = xyz + (trans - trans[:, :1, :])[:, :, None, :]
        return xyz
