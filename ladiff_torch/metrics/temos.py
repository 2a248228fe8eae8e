"""TEMOS-style APE/AVE metrics with the internal Rifke canonicalization.

Rebuild of the reference ladiff/models/metrics/compute.py:15-196 and
the Rifke joints->features transform it embeds
(the reference ladiff/transforms/joints2jfeats/rifke.py:27-91,
tools.py:14-55).  Joints are floor-aligned, root-factored, facing-normalized;
APE sums per-frame L2 errors (root / trajectory / local poses / global
joints) over valid frames; AVE compares per-sequence coordinate variances.
``force_in_meter`` divides humanml3d joints by 1000*0.75/480
(compute.py:182-185).

The port's copy of ``ladiff_tpu/metrics/temos.py``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["TemosMetrics", "TemosMetricsBest", "TemosMetricsWorst",
           "rifke_canonicalize"]

_HUMANML3D_JOINTS = [
    "root", "RH", "LH", "BP", "RK", "LK", "BT", "RMrot", "LMrot", "BLN",
    "RF", "LF", "BMN", "RSI", "LSI", "BUN", "RS", "LS", "RE", "LE", "RW", "LW",
]
_MMM_JOINTS = [
    "root", "BP", "BT", "BLN", "BUN", "LS", "LE", "LW", "RS", "RE", "RW",
    "LH", "LK", "LA", "LMrot", "LF", "RH", "RK", "RA", "RMrot", "RF",
]


def _joint_names(jointstype: str) -> List[str]:
    return _HUMANML3D_JOINTS if jointstype == "humanml3d" else _MMM_JOINTS


def _softmin(x, softness=0.5, axis=-1):
    maxi, mini = (-x).max(axis=axis), (-x).min(axis=axis)
    return -(maxi + np.log(softness + np.exp(mini - maxi)))


def rifke_canonicalize(joints: np.ndarray, jointstype: str = "humanml3d"):
    """[T, J, 3] -> (joints_global, poses_local, root, trajectory), all in
    the facing-normalized Rifke frame (reference rifke.py forward followed by
    compute.py:133-179 re-integration)."""
    names = _joint_names(jointstype)
    LS, RS = names.index("LS"), names.index("RS")
    LH, RH = names.index("LH"), names.index("RH")
    LM, RM = names.index("LMrot"), names.index("RMrot")
    LF, RF = names.index("LF"), names.index("RF")

    poses = joints.copy().astype(np.float64)
    foot_heights = poses[..., (LM, LF, RM, RF), 1].min(-1)
    floor = _softmin(foot_heights, softness=0.5, axis=-1)
    poses[..., 1] -= floor

    translation = poses[..., 0, :].copy()
    root_y = translation[..., 1]
    trajectory = translation[..., [0, 2]]
    poses = poses[..., 1:, :]
    poses[..., [0, 2]] -= trajectory[..., None, :]

    vel_traj = np.diff(trajectory, axis=-2)
    vel_traj = np.concatenate([0 * vel_traj[..., :1, :], vel_traj], axis=-2)

    across = (poses[..., RH - 1, :] - poses[..., LH - 1, :]
              + poses[..., RS - 1, :] - poses[..., LS - 1, :])
    forward = np.stack((-across[..., 2], across[..., 0]), axis=-1)
    forward = forward / np.maximum(
        np.linalg.norm(forward, axis=-1, keepdims=True), 1e-12)

    angles = np.arctan2(forward[..., 0], forward[..., 1])
    vel_angles = np.diff(angles, axis=-1)
    vel_angles = np.concatenate([0 * vel_angles[..., :1], vel_angles], axis=-1)

    sin, cos = forward[..., 0], forward[..., 1]
    # inverse rotation (rifke), then re-integration (compute.py transform)
    rot_inv = np.stack([np.stack([cos, sin], -1),
                        np.stack([-sin, cos], -1)], -2)
    poses_xz_local = np.einsum("...lj,...jk->...lk", poses[..., [0, 2]], rot_inv)
    poses_local = np.stack(
        [poses_xz_local[..., 0], poses[..., 1], poses_xz_local[..., 1]], -1)
    vel_traj_local = np.einsum("...j,...jk->...k", vel_traj, rot_inv)

    # --- re-integration in the canonical frame
    angles_c = np.cumsum(vel_angles, axis=-1)
    angles_c = angles_c - angles_c[..., :1]
    cos_c, sin_c = np.cos(angles_c), np.sin(angles_c)
    rot = np.stack([np.stack([cos_c, -sin_c], -1),
                    np.stack([sin_c, cos_c], -1)], -2)
    poses_xz = np.einsum("...lj,...jk->...lk", poses_local[..., [0, 2]], rot)
    poses_g = np.stack([poses_xz[..., 0], poses_local[..., 1],
                        poses_xz[..., 1]], -1)
    vel_traj_g = np.einsum("...j,...jk->...k", vel_traj_local, rot)
    traj = np.cumsum(vel_traj_g, axis=-2)
    traj = traj - traj[..., :1, :]
    root = np.stack([traj[..., 0], root_y, traj[..., 1]], -1)
    jts = np.concatenate([0 * poses_g[..., :1, :], poses_g], axis=-2)
    jts[..., 0, 1] = root_y
    jts[..., [0, 2]] += traj[..., None, :]
    return jts, poses_local, root, traj


class TemosMetrics:
    """APE/AVE accumulator (reference ComputeMetrics)."""

    def __init__(self, njoints: int = 22, jointstype: str = "humanml3d",
                 force_in_meter: bool = True):
        self.njoints = njoints
        self.jointstype = jointstype
        self.factor = (1000.0 * 0.75 / 480.0
                       if (force_in_meter and jointstype == "humanml3d")
                       else (1000.0 if force_in_meter else 1.0))
        self.reset()

    def reset(self):
        self.count = 0
        self.count_seq = 0
        self.APE_root = 0.0
        self.APE_traj = 0.0
        self.APE_pose = np.zeros(self.njoints - 1)
        self.APE_joints = np.zeros(self.njoints)
        self.AVE_root = 0.0
        self.AVE_traj = 0.0
        self.AVE_pose = np.zeros(self.njoints - 1)
        self.AVE_joints = np.zeros(self.njoints)

    def update(self, joints_rst, joints_ref, lengths):
        self.count += int(np.sum(lengths))
        self.count_seq += len(lengths)
        for (APE_root, APE_pose, APE_traj, APE_joints,
             AVE_root, AVE_pose, AVE_traj, AVE_joints) in \
                self._sample_metrics(joints_rst, joints_ref, lengths):
            self.APE_root += APE_root
            self.APE_traj += APE_traj
            self.APE_pose += APE_pose
            self.APE_joints += APE_joints
            self.AVE_root += AVE_root
            self.AVE_traj += AVE_traj
            self.AVE_pose += AVE_pose
            self.AVE_joints += AVE_joints

    def compute(self) -> Dict[str, float]:
        c, cs = self.count, self.count_seq
        return {
            "APE_root": self.APE_root / c,
            "APE_traj": self.APE_traj / c,
            "APE_mean_pose": self.APE_pose.mean() / c,
            "APE_mean_joints": self.APE_joints.mean() / c,
            "AVE_root": self.AVE_root / cs,
            "AVE_traj": self.AVE_traj / cs,
            "AVE_mean_pose": self.AVE_pose.mean() / cs,
            "AVE_mean_joints": self.AVE_joints.mean() / cs,
        }

    def _sample_metrics(self, joints_rst, joints_ref, lengths):
        """Per-sample (APE_root, APE_pose, APE_traj, APE_joints, AVE_*)
        tuples for one batch — the inner body of the reference update loop
        (compute_best.py:23-48), factored so the best/worst variants can
        select among trials before accumulating."""
        joints_rst = np.asarray(joints_rst)  # one host fetch per batch,
        joints_ref = np.asarray(joints_ref)  # not per sample
        out = []
        for i, L in enumerate(lengths):
            L = int(L)
            jt, pt, rt, tt = rifke_canonicalize(joints_rst[i, :L],
                                                self.jointstype)
            jr, pr, rr, tr = rifke_canonicalize(joints_ref[i, :L],
                                                self.jointstype)
            f = self.factor
            jt, pt, rt, tt = jt / f, pt / f, rt / f, tt / f
            jr, pr, rr, tr = jr / f, pr / f, rr / f, tr / f
            var = lambda x: ((x - x.mean(0)) ** 2).sum(0) / (L - 1)
            out.append((
                np.linalg.norm(rt - rr, axis=1).sum(),
                np.linalg.norm(pt - pr, axis=2).sum(0),
                np.linalg.norm(tt - tr, axis=1).sum(),
                np.linalg.norm(jt - jr, axis=2).sum(0),
                np.linalg.norm(var(rt) - var(rr), axis=0),
                np.linalg.norm(var(pt) - var(pr), axis=1),
                np.linalg.norm(var(tt) - var(tr), axis=0),
                np.linalg.norm(var(jt) - var(jr), axis=1),
            ))
        return out


class _TemosMetricsSelect(TemosMetrics):
    """Multi-trial APE/AVE: pick one trial per batch and accumulate it.

    Rebuild of the reference ComputeMetricsBest / ComputeMetricsWorst
    (the reference ladiff/models/metrics/compute_best.py:12-60,
    compute_worst.py:12-60; no runtime consumers in the shipped configs).
    The reference's own "Quick hacks" block is replicated faithfully:
    the trial is chosen by the FIRST sample's APE_root only, and only
    that first sample's metric tuple is accumulated — while count /
    count_seq still advance by the whole batch (compute_best.py:13-14,
    51-60).  The resulting averages are therefore not per-sample means;
    that is the reference's behavior, not a rebuild bug.
    """

    _select = staticmethod(np.argmin)

    def update(self, joints_rst_trials, joints_ref_trials, lengths_trials):
        self.count += int(np.sum(lengths_trials[0]))
        self.count_seq += len(lengths_trials[0])
        per_trial = [self._sample_metrics(jr, jf, ls)
                     for jr, jf, ls in zip(joints_rst_trials,
                                           joints_ref_trials, lengths_trials)]
        chosen = per_trial[int(self._select([t[0][0] for t in per_trial]))][0]
        (APE_root, APE_pose, APE_traj, APE_joints,
         AVE_root, AVE_pose, AVE_traj, AVE_joints) = chosen
        self.APE_root += APE_root
        self.APE_pose += APE_pose
        self.APE_traj += APE_traj
        self.APE_joints += APE_joints
        self.AVE_root += AVE_root
        self.AVE_pose += AVE_pose
        self.AVE_traj += AVE_traj
        self.AVE_joints += AVE_joints


class TemosMetricsBest(_TemosMetricsSelect):
    """Best-of-N trials by first-sample APE_root (ComputeMetricsBest)."""
    _select = staticmethod(np.argmin)


class TemosMetricsWorst(_TemosMetricsSelect):
    """Worst-of-N trials by first-sample APE_root (ComputeMetricsWorst)."""
    _select = staticmethod(np.argmax)
