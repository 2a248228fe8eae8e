"""Numeric preparation for the Blender renderer (bpy-free, testable).

Host-side numpy: the counterpart of ``ladiff_tpu/render/blender_prep.py``,
line for line.

Rebuild of the math half of the reference Blender stack
(the reference's ladiff/render/blender/joints.py:148-360,
meshes.py:68-87, sampler.py:4-15, render.py:17-21): canonicalization
(floor removal, trajectory removal, first-frame forward alignment),
axis swaps into Blender's z-up frame, frame-index sampling per render
mode, and begin/end pruning for sequence stills.  The bpy half
(scripts/blender_render.py) consumes these arrays.

Parity notes:
  * ``get_forward_direction`` reads shoulders from the requested joint
    set but hips from the MMM joint table even for humanml3d input —
    the reference does exactly this (joints.py:163-166); replicated
    deliberately, like the swapped face-joint order elsewhere.
  * humanml3d joints scale by ``mmm_to_smplh_scaling_factor`` only in
    the reference because its canonical frame is MMM-scaled; our decode
    outputs are already SMPL-scale meters, so scaling is OFF by default
    and available via ``scale`` for reference-identical output.
"""
from __future__ import annotations

import numpy as np

from ladiff_torch.transforms.geometry import matrix_of_angles, softmin
from ladiff_torch.utils.joints import (humanml3d_joints,
                                       humanml3d_kinematic_tree, mmm_joints)

__all__ = [
    "HUMANML3D_JOINTS", "HUMANML3D_KINEMATIC_TREE", "KIT_KINEMATIC_TREE",
    "get_floor", "get_forward_direction", "canonicalize_joints",
    "prepare_joints", "prepare_meshes", "get_frameidx", "prune_begin_end",
]

HUMANML3D_JOINTS = humanml3d_joints
# body, right arm, left arm, right leg, left leg
HUMANML3D_KINEMATIC_TREE = humanml3d_kinematic_tree
# the MMM tree with the legs first, as the reference's renderer draws it
KIT_KINEMATIC_TREE = [
    [0, 11, 12, 13, 14, 15], [0, 16, 17, 18, 19, 20],
    [0, 1, 2, 3, 4], [3, 5, 6, 7], [3, 8, 9, 10],
]

# the hips come from the MMM table whatever the joint set (the reference
# mixes tables — see module docstring)
_MMM_LH_INDEX, _MMM_RH_INDEX = mmm_joints.index("LH"), mmm_joints.index("RH")


def get_floor(poses: np.ndarray, joints=None) -> np.ndarray:
    """Soft minimum of the four foot-joint heights (joints.py:271-286)."""
    joints = joints or HUMANML3D_JOINTS
    feet = (joints.index("LMrot"), joints.index("LF"),
            joints.index("RMrot"), joints.index("RF"))
    ndim = poses.ndim
    foot_heights = poses[..., feet, 1].min(-1)
    floor_height = softmin(foot_heights, softness=0.5, axis=-1)
    return floor_height[tuple((ndim - 2) * [None])].T


def get_forward_direction(poses: np.ndarray, joints=None) -> np.ndarray:
    """Unit ground-plane forward vector from shoulders+hips
    (joints.py:157-174; hips via the MMM table — reference behavior)."""
    joints = joints or HUMANML3D_JOINTS
    LS, RS = joints.index("LS"), joints.index("RS")
    LH, RH = _MMM_LH_INDEX, _MMM_RH_INDEX
    across = (poses[..., RH, :] - poses[..., LH, :]
              + poses[..., RS, :] - poses[..., LS, :])
    forward = np.stack((-across[..., 2], across[..., 0]), axis=-1)
    return forward / np.linalg.norm(forward, axis=-1)


def canonicalize_joints(joints: np.ndarray, joint_names=None) -> np.ndarray:
    """First frame faces forward, floor at zero, root at origin
    (joints.py:288-327)."""
    poses = joints.copy()
    translation = joints[..., 0, :].copy()
    translation[..., 1] = 0
    trajectory = translation[..., [0, 2]]

    poses[..., 1] -= get_floor(poses, joint_names)
    poses[..., [0, 2]] -= trajectory[..., None, :]
    trajectory = trajectory - trajectory[..., 0, :]

    forward = get_forward_direction(poses[..., 0, :, :], joint_names)
    sin, cos = forward[..., 0], forward[..., 1]
    rotations_inv = matrix_of_angles(cos, sin, inv=True)

    trajectory_rotated = np.einsum("...j,...jk->...k", trajectory,
                                   rotations_inv)
    poses_rotated = np.einsum("...lj,...jk->...lk", poses[..., [0, 2]],
                              rotations_inv)
    poses_rotated = np.stack(
        (poses_rotated[..., 0], poses[..., 1], poses_rotated[..., 1]),
        axis=-1)
    poses_rotated[..., (0, 2)] += trajectory_rotated[..., None, :]
    return poses_rotated


def prepare_joints(joints: np.ndarray, canonicalize: bool = True,
                   always_on_floor: bool = False, scale: float = 1.0,
                   joint_names=None) -> np.ndarray:
    """[T, J, 3] y-up joints -> Blender z-up, canonicalized, floored
    (joints.py:329-360)."""
    data = canonicalize_joints(joints, joint_names) if canonicalize \
        else joints.astype(np.float64)
    data = data * scale
    data = data[..., [2, 0, 1]]              # gravity Y -> Z
    data = data - data[[0], [0], :]          # first root at origin
    data[..., 2] -= data[..., 2].min()       # floor at zero
    if always_on_floor:                      # every FRAME on the floor
        data[..., 2] -= data[..., 2].min(1)[:, None]
    return data


def prepare_meshes(data: np.ndarray, canonicalize: bool = True,
                   always_on_floor: bool = False) -> np.ndarray:
    """[T, V, 3] vertices -> z-up, floored (meshes.py:68-87; the reference
    skips canonicalization for fitted meshes)."""
    data = data[..., [2, 0, 1]]
    data = data - 0.0
    data[..., 2] -= data[..., 2].min()
    if always_on_floor:
        data[..., 2] -= data[..., 2].min(1)[:, None]
    return data


def get_frameidx(mode: str, nframes: int, exact_frame: float | None,
                 frames_to_keep: int):
    """Frame sampling per render mode (sampler.py:4-15)."""
    if mode == "sequence":
        return list(np.round(np.linspace(0, nframes - 1,
                                         frames_to_keep)).astype(int))
    if mode == "frame":
        return [int(exact_frame * nframes)]
    if mode == "video":
        return list(range(nframes))
    raise ValueError(f"Not support {mode} render mode")


def prune_begin_end(data: np.ndarray, perc: float) -> np.ndarray:
    """Drop the (mostly static) first/last perc of frames (render.py:17-21)."""
    to_remove = int(len(data) * perc)
    if to_remove == 0:
        return data
    return data[to_remove:-to_remove]
