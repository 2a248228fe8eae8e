"""Joint-name tables and cross-skeleton index maps.

Host-side numpy: the counterpart of ``ladiff_tpu/utils/joints.py``,
line for line.

Rebuild of the reference's ladiff/utils/joints.py:1-255: MMM / HumanML3D
/ SMPL-H / SMPL-nohands joint orderings, the MMM<->SMPLH correspondence used
by the TEMOS transform stack, kinematic trees for rendering, and the
MMM<->SMPLH scale factor.
"""
from __future__ import annotations

import numpy as np

mmm_joints = [
    "root", "BP", "BT", "BLN", "BUN", "LS", "LE", "LW", "RS", "RE", "RW",
    "LH", "LK", "LA", "LMrot", "LF", "RH", "RK", "RA", "RMrot", "RF",
]

humanml3d_joints = [
    "root", "RH", "LH", "BP", "RK", "LK", "BT", "RMrot", "LMrot", "BLN",
    "RF", "LF", "BMN", "RSI", "LSI", "BUN", "RS", "LS", "RE", "LE", "RW",
    "LW",
]

# SMPLH model output: 52 LBS joints followed by 21 vertex keypoints (face,
# feet, finger tips) appended by the vertex-joint selector — 73 total
# (reference joints.py:50-123, smplx/vertex_joint_selector.py:36-69)
smplh_joints = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_index1", "left_index2", "left_index3",
    "left_middle1", "left_middle2", "left_middle3", "left_pinky1",
    "left_pinky2", "left_pinky3", "left_ring1", "left_ring2", "left_ring3",
    "left_thumb1", "left_thumb2", "left_thumb3", "right_index1",
    "right_index2", "right_index3", "right_middle1", "right_middle2",
    "right_middle3", "right_pinky1", "right_pinky2", "right_pinky3",
    "right_ring1", "right_ring2", "right_ring3", "right_thumb1",
    "right_thumb2", "right_thumb3",
    "nose", "right_eye", "left_eye", "right_ear", "left_ear",
    "left_big_toe", "left_small_toe", "left_heel",
    "right_big_toe", "right_small_toe", "right_heel",
    "left_thumb", "left_index", "left_middle", "left_ring", "left_pinky",
    "right_thumb", "right_index", "right_middle", "right_ring",
    "right_pinky",
]

# mesh vertex id for each appended keypoint, in selector order
# (reference smplx/vertex_ids.py:24-46, vertex_joint_selector.py:38-69)
smplh_extra_vertex_ids = np.array([
    332, 6260, 2800, 4071, 583,            # nose, reye, leye, rear, lear
    3216, 3226, 3387, 6617, 6624, 6787,    # L/R big toe, small toe, heel
    2746, 2319, 2445, 2556, 2673,          # left finger tips
    6191, 5782, 5905, 6016, 6133,          # right finger tips
], dtype=np.int64)

smplnh_joints = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist",
]

# MMM joint -> closest SMPLH joint (reference joints.py:150-175)
mmm2smplh_correspondence = {
    "root": "pelvis", "BP": "spine1", "BT": "spine3", "BLN": "neck",
    "BUN": "head", "LS": "left_shoulder", "LE": "left_elbow",
    "LW": "left_wrist", "RS": "right_shoulder", "RE": "right_elbow",
    "RW": "right_wrist", "LH": "left_hip", "LK": "left_knee",
    "LA": "left_ankle", "LMrot": "left_heel", "LF": "left_foot",
    "RH": "right_hip", "RK": "right_knee", "RA": "right_ankle",
    "RMrot": "right_heel", "RF": "right_foot",
}
smplh2mmm_indexes = [
    smplh_joints.index(mmm2smplh_correspondence[x]) for x in mmm_joints
]
smplh2smplnh_indexes = [smplh_joints.index(x) for x in smplnh_joints]

smplh_to_mmm_scaling_factor = 480 / 0.75
mmm_to_smplh_scaling_factor = 0.75 / 480

mmm_kinematic_tree = [
    [0, 1, 2, 3, 4],
    [3, 5, 6, 7],
    [3, 8, 9, 10],
    [0, 11, 12, 13, 14, 15],
    [0, 16, 17, 18, 19, 20],
]

humanml3d_kinematic_tree = [
    [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21],
    [9, 13, 16, 18, 20],
    [0, 2, 5, 8, 11],
    [0, 1, 4, 7, 10],
]

root_joints = {
    "mmm": 0, "mmmns": 0, "smplmmm": 0,
    "smplnh": smplnh_joints.index("pelvis"),
    "smplh": smplh_joints.index("pelvis"),
}

smplh_indexes = {"mmm": smplh2mmm_indexes, "smplnh": smplh2smplnh_indexes}


def get_root_idx(jointstype: str) -> int:
    return root_joints[jointstype]


def joints_of(jointstype: str):
    if jointstype in ("mmm", "mmmns"):
        return mmm_joints
    if jointstype == "humanml3d":
        return humanml3d_joints
    if jointstype == "smplnh":
        return smplnh_joints
    if jointstype == "smplh":
        return smplh_joints
    raise NotImplementedError(f"jointstype {jointstype} not supported")
