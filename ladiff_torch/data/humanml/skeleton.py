"""Skeleton kinematics (numpy, offline preprocessing path).

Host-side numpy: the counterpart of ``ladiff_tpu/data/humanml/skeleton.py``,
line for line.

Rebuild of the reference's ladiff/data/humanml/common/skeleton.py and the
topology constants in data/humanml/utils/paramUtil.py: kinematic chains +
unit raw offsets for the SMPL-derived 22-joint (HumanML3D/T2M) and the MMM
21-joint (KIT) skeletons, inverse kinematics (per-bone quaternion between
the rest offset and the observed bone direction, accumulated down each
chain), and forward kinematics for quaternion / cont6d parameterizations.

This is host-side preprocessing (run once per dataset), so plain numpy is
the right tool; the device-side inverse (``recover_from_ric``) lives in
``motion_repr.py``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ladiff_torch.data.humanml import np_quaternion as Q

__all__ = ["Skeleton", "SKELETONS", "qfix"]

# unit bone directions (paramUtil.py t2m_raw_offsets / kit_raw_offsets)
T2M_RAW_OFFSETS = np.array([
    [0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, -1, 0],
    [0, 1, 0], [0, -1, 0], [0, -1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1],
    [0, 1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, -1, 0], [0, -1, 0],
    [0, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, 0]], dtype=np.float32)

T2M_KINEMATIC_CHAIN = [[0, 2, 5, 8, 11], [0, 1, 4, 7, 10],
                       [0, 3, 6, 9, 12, 15], [9, 14, 17, 19, 21],
                       [9, 13, 16, 18, 20]]

KIT_RAW_OFFSETS = np.array([
    [0, 0, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [1, 0, 0],
    [0, -1, 0], [0, -1, 0], [-1, 0, 0], [0, -1, 0], [0, -1, 0], [1, 0, 0],
    [0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
    [0, -1, 0], [0, 0, 1], [0, 0, 1]], dtype=np.float32)

KIT_KINEMATIC_CHAIN = [[0, 11, 12, 13, 14, 15], [0, 16, 17, 18, 19, 20],
                       [0, 1, 2, 3, 4], [3, 5, 6, 7], [3, 8, 9, 10]]

SKELETONS = {
    # (raw_offsets, chains, face_joint_indx [r_hip,l_hip,sdr_r,sdr_l],
    #  fid_l, fid_r, lower-leg idx pair, feet threshold)
    "humanml3d": dict(offsets=T2M_RAW_OFFSETS, chains=T2M_KINEMATIC_CHAIN,
                      face_joint_indx=[2, 1, 17, 16], fid_l=[7, 10],
                      fid_r=[8, 11], l_idx=(5, 8), feet_thre=0.002,
                      njoints=22),
    "kit": dict(offsets=KIT_RAW_OFFSETS, chains=KIT_KINEMATIC_CHAIN,
                face_joint_indx=[11, 16, 5, 8], fid_l=[19, 20],
                fid_r=[14, 15], l_idx=(5, 8), feet_thre=0.05, njoints=21),
}


def _np(fn, *args):
    return np.asarray(fn(*[np.asarray(a, dtype=np.float32) for a in args]))


def qfix(q: np.ndarray) -> np.ndarray:
    """Enforce quaternion sign continuity over time ([T, J, 4])."""
    result = q.copy()
    dots = np.sum(q[1:] * q[:-1], axis=2)
    flip = (np.cumsum(dots < 0, axis=0) % 2).astype(bool)
    result[1:][flip] *= -1
    return result


class Skeleton:
    def __init__(self, raw_offsets: np.ndarray, kinematic_tree: List[List[int]]):
        self.raw_offsets = np.asarray(raw_offsets, np.float32)
        self.kinematic_tree = kinematic_tree
        self.parents = [0] * len(self.raw_offsets)
        self.parents[0] = -1
        for chain in kinematic_tree:
            for j in range(1, len(chain)):
                self.parents[chain[j]] = chain[j - 1]
        self._offset: Optional[np.ndarray] = None

    def njoints(self) -> int:
        return len(self.raw_offsets)

    def set_offset(self, offsets: np.ndarray):
        self._offset = np.asarray(offsets, np.float32)

    def get_offsets_joints(self, joints: np.ndarray) -> np.ndarray:
        """One pose [J, 3] -> per-bone offsets (bone length * unit dir)."""
        offsets = self.raw_offsets.copy()
        for i in range(1, len(offsets)):
            length = np.linalg.norm(joints[i] - joints[self.parents[i]])
            offsets[i] = length * offsets[i]
        self._offset = offsets
        return offsets

    # -- inverse kinematics --------------------------------------------
    def inverse_kinematics(self, joints: np.ndarray, face_joint_indx,
                           smooth_forward: bool = False) -> np.ndarray:
        """[T, J, 3] -> per-joint local quaternions [T, J, 4]
        (reference skeleton.py:55-101).

        NOTE: the reference unpacks face_joint_idx as (l_hip, r_hip, ...)
        here but as (r_hip, l_hip, ...) in process_file — the IK "across"
        vector is sign-flipped relative to the preprocessing one.  We
        replicate that exactly (it changes the learned feature values)."""
        l_hip, r_hip, sdr_r, sdr_l = face_joint_indx
        across = (joints[:, r_hip] - joints[:, l_hip]
                  + joints[:, sdr_r] - joints[:, sdr_l])
        across = across / np.linalg.norm(across, axis=-1, keepdims=True)
        forward = np.cross(np.array([[0, 1, 0]], np.float32), across, axis=-1)
        if smooth_forward:
            from scipy.ndimage import gaussian_filter1d
            forward = gaussian_filter1d(forward, 20, axis=0, mode="nearest")
        forward = forward / np.linalg.norm(forward, axis=-1, keepdims=True)

        target = np.array([[0, 0, 1]], np.float32).repeat(len(forward), 0)
        root_quat = _np(Q.qbetween, forward, target)
        quat_params = np.zeros(joints.shape[:-1] + (4,), np.float32)
        root_quat[0] = np.array([1.0, 0.0, 0.0, 0.0])
        quat_params[:, 0] = root_quat
        for chain in self.kinematic_tree:
            R = root_quat
            for j in range(len(chain) - 1):
                u = self.raw_offsets[chain[j + 1]][None].repeat(len(joints), 0)
                v = joints[:, chain[j + 1]] - joints[:, chain[j]]
                v = v / np.linalg.norm(v, axis=-1, keepdims=True)
                rot_u_v = _np(Q.qbetween, u, v)
                R_loc = _np(Q.qmul, _np(Q.qinv, R), rot_u_v)
                quat_params[:, chain[j + 1]] = R_loc
                R = _np(Q.qmul, R, R_loc)
        return quat_params

    # -- forward kinematics --------------------------------------------
    def forward_kinematics(self, quat_params: np.ndarray, root_pos: np.ndarray,
                           skel_joints: Optional[np.ndarray] = None,
                           do_root_R: bool = True) -> np.ndarray:
        """Local quats [T, J, 4] + root pos [T, 3] -> joints [T, J, 3]."""
        if skel_joints is not None:
            offsets = np.stack([self.get_offsets_joints(j) for j in skel_joints])
        else:
            offsets = np.broadcast_to(self._offset,
                                      quat_params.shape[:-1] + (3,))
        joints = np.zeros(quat_params.shape[:-1] + (3,), np.float32)
        joints[:, 0] = root_pos
        for chain in self.kinematic_tree:
            if do_root_R:
                R = quat_params[:, 0]
            else:
                R = np.array([[1.0, 0, 0, 0]], np.float32).repeat(
                    len(quat_params), 0)
            for i in range(1, len(chain)):
                R = _np(Q.qmul, R, quat_params[:, chain[i]])
                offset_vec = offsets[:, chain[i]]
                joints[:, chain[i]] = (_np(Q.qrot, R, offset_vec)
                                       + joints[:, chain[i - 1]])
        return joints

    def forward_kinematics_cont6d(self, cont6d: np.ndarray,
                                  root_pos: np.ndarray,
                                  skel_joints: Optional[np.ndarray] = None,
                                  do_root_R: bool = True) -> np.ndarray:
        if skel_joints is not None:
            offsets = np.stack([self.get_offsets_joints(j) for j in skel_joints])
        else:
            offsets = np.broadcast_to(self._offset, cont6d.shape[:-1] + (3,))
        joints = np.zeros(cont6d.shape[:-1] + (3,), np.float32)
        joints[:, 0] = root_pos
        for chain in self.kinematic_tree:
            if do_root_R:
                matR = _np(Q.cont6d_to_matrix, cont6d[:, 0])
            else:
                matR = np.broadcast_to(np.eye(3, dtype=np.float32),
                                       (len(cont6d), 3, 3))
            for i in range(1, len(chain)):
                matR = matR @ _np(Q.cont6d_to_matrix, cont6d[:, chain[i]])
                offset_vec = offsets[:, chain[i]][..., None]
                joints[:, chain[i]] = ((matR @ offset_vec)[..., 0]
                                       + joints[:, chain[i - 1]])
        return joints
