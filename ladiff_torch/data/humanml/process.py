"""Forward motion featurization: raw joints -> 263/251-dim features.

Host-side numpy: the counterpart of ``ladiff_tpu/data/humanml/process.py``,
line for line.

Rebuild of ``process_file``
(the reference's ladiff/data/humanml/scripts/motion_process.py:169-366),
the offline preprocessing that produces the ``new_joint_vecs`` the datasets
load.  Steps: skeleton retarget (uniform_skeleton), floor alignment, origin
centering, initial-facing normalization, foot-contact detection, IK to
cont6d joint rotations, RIC local positions, root rot/lin velocities, local
joint velocities.  Output layout matches ``recover_from_ric``'s input:
  [ r_vel(1) | lin_vel xz(2) | root_y(1) | ric (J-1)*3 | rot6d (J-1)*6
  | local_vel J*3 | feet contacts(4) ]  (T-1 frames for a T-frame input).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ladiff_torch.data.humanml import np_quaternion as Q
from ladiff_torch.data.humanml.skeleton import SKELETONS, Skeleton, qfix

__all__ = ["process_file", "uniform_skeleton"]


def _np(fn, *args):
    return np.asarray(fn(*[np.asarray(a, dtype=np.float32) for a in args]))


def uniform_skeleton(positions: np.ndarray, target_offsets: np.ndarray,
                     dataset: str = "humanml3d") -> np.ndarray:
    """Retarget a clip to the canonical skeleton: scale root trajectory by
    the leg-length ratio, IK on the source, FK with target offsets
    (reference motion_process.py:13-36)."""
    spec = SKELETONS[dataset]
    skel = Skeleton(spec["offsets"], spec["chains"])
    src_offset = skel.get_offsets_joints(positions[0])
    l_idx1, l_idx2 = spec["l_idx"]
    src_leg_len = np.abs(src_offset[l_idx1]).max() + np.abs(src_offset[l_idx2]).max()
    tgt_leg_len = (np.abs(target_offsets[l_idx1]).max()
                   + np.abs(target_offsets[l_idx2]).max())
    scale = tgt_leg_len / src_leg_len
    tgt_root_pos = positions[:, 0] * scale

    quat_params = skel.inverse_kinematics(positions, spec["face_joint_indx"])
    skel.set_offset(target_offsets)
    return skel.forward_kinematics(quat_params, tgt_root_pos)


def process_file(positions: np.ndarray, feet_thre: Optional[float] = None,
                 dataset: str = "humanml3d",
                 target_offsets: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """[T, J, 3] raw joints -> ([T-1, F] features, global_positions,
    rifke positions, l_velocity)."""
    spec = SKELETONS[dataset]
    feet_thre = spec["feet_thre"] if feet_thre is None else feet_thre
    fid_l, fid_r = spec["fid_l"], spec["fid_r"]
    face_joint_indx = spec["face_joint_indx"]
    joints_num = spec["njoints"]
    positions = positions[:, :joints_num].astype(np.float32)

    if target_offsets is not None:
        positions = uniform_skeleton(positions, target_offsets, dataset)

    # floor + origin + initial facing normalization (reference :169-230)
    positions = positions.copy()
    positions[:, :, 1] -= positions.min(axis=0).min(axis=0)[1]
    root_pos_init = positions[0]
    positions = positions - root_pos_init[0] * np.array([1, 0, 1], np.float32)

    r_hip, l_hip, sdr_r, sdr_l = face_joint_indx
    across = (root_pos_init[r_hip] - root_pos_init[l_hip]
              + root_pos_init[sdr_r] - root_pos_init[sdr_l])
    across = across / np.linalg.norm(across)
    forward_init = np.cross(np.array([[0, 1, 0]], np.float32), across, axis=-1)
    forward_init = forward_init / np.linalg.norm(forward_init, axis=-1,
                                                 keepdims=True)
    root_quat_init = _np(Q.qbetween, forward_init,
                         np.array([[0, 0, 1]], np.float32))
    root_quat_init = np.ones(positions.shape[:-1] + (4,),
                             np.float32) * root_quat_init
    positions = _np(Q.qrot, root_quat_init, positions)

    global_positions = positions.copy()

    # foot contacts (reference :232-257)
    def foot_detect(pos, thres):
        # squared frame-to-frame displacement below threshold => contact
        feet_l = ((np.square(pos[1:, fid_l] - pos[:-1, fid_l]).sum(-1) < thres)
                  .astype(np.float32))
        feet_r = ((np.square(pos[1:, fid_r] - pos[:-1, fid_r]).sum(-1) < thres)
                  .astype(np.float32))
        return feet_l, feet_r

    feet_l, feet_r = foot_detect(positions, feet_thre)

    # cont6d joint rotations + root velocities (reference :259-301)
    skel = Skeleton(spec["offsets"], spec["chains"])
    quat_params = skel.inverse_kinematics(positions, face_joint_indx,
                                          smooth_forward=True)
    cont_6d_params = _np(Q.quaternion_to_cont6d, quat_params)
    r_rot = quat_params[:, 0].copy()
    velocity = (positions[1:, 0] - positions[:-1, 0]).copy()
    velocity = _np(Q.qrot, r_rot[1:], velocity)
    r_velocity = _np(Q.qmul, r_rot[1:], _np(Q.qinv, r_rot[:-1]))

    # rifke local positions (reference get_rifke :355-362)
    positions[..., 0] -= positions[:, 0:1, 0]
    positions[..., 2] -= positions[:, 0:1, 2]
    positions = _np(Q.qrot,
                    np.repeat(r_rot[:, None], positions.shape[1], axis=1),
                    positions)

    root_y = positions[:, 0, 1:2]
    r_velocity_y = np.arcsin(np.clip(r_velocity[:, 2:3], -1.0, 1.0))
    l_velocity = velocity[:, [0, 2]]
    root_data = np.concatenate(
        [r_velocity_y, l_velocity, root_y[:-1]], axis=-1)

    rot_data = cont_6d_params[:, 1:].reshape(len(cont_6d_params), -1)
    ric_data = positions[:, 1:].reshape(len(positions), -1)
    local_vel = _np(Q.qrot,
                    np.repeat(r_rot[:-1, None], global_positions.shape[1],
                              axis=1),
                    global_positions[1:] - global_positions[:-1])
    local_vel = local_vel.reshape(len(local_vel), -1)

    data = np.concatenate([root_data, ric_data[:-1], rot_data[:-1],
                           local_vel, feet_l, feet_r], axis=-1)
    return data, global_positions, positions, l_velocity
