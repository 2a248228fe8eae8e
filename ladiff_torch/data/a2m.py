"""Action-to-motion datasets, HumanAct12 and UESTC (counterpart of
``ladiff_tpu/data/a2m.py``: the same items, batches and synthetic files
for the same data and seeds).

Pose representation: per-joint rot6d (pytorch3d's convention: the first two
matrix rows) and a zero-padded global translation row, 25 x 6 = 150
features for SMPL-24 and the translation, flattened channel-major.  Frame
sampling is the reference's "conseq" scheme: an evenly strided window of
``num_frames`` with a random shift; clips shorter than the window repeat
their last frame.  ``a2m_collate`` pads time to ``num_frames``.  The
rotation helpers are the port's (``data/humanml/quaternion.py``).
"""
from __future__ import annotations

import os
import pickle
import random
from os.path import join as pjoin
from typing import List, Optional

import numpy as np
import torch

from ladiff_torch.data.humanml import quaternion as Q

__all__ = ["HumanAct12Dataset", "UESTCDataset", "ActionDataModule",
           "a2m_collate", "sample_frame_indices", "axis_angle_to_rot6d",
           "generate_synthetic_humanact12", "generate_synthetic_uestc",
           "HUMANACT12_ACTION_NAMES"]

HUMANACT12_ACTION_NAMES = {
    0: "warm_up", 1: "walk", 2: "run", 3: "jump", 4: "drink",
    5: "lift_dumbbell", 6: "sit", 7: "eat", 8: "turn steering wheel",
    9: "phone", 10: "boxing", 11: "throw",
}


def axis_angle_to_rot6d(aa: np.ndarray) -> np.ndarray:
    """(..., 3) rotvec -> (..., 6), pytorch3d ``matrix_to_rotation_6d``
    convention (first two matrix rows flattened)."""
    m = Q.quaternion_to_matrix(Q.axis_angle_to_quaternion(
        torch.from_numpy(np.ascontiguousarray(aa, np.float32)))).numpy()
    return m[..., :2, :].reshape(aa.shape[:-1] + (6,))


def sample_frame_indices(nframes: int, num_frames: int,
                         sampling: str = "conseq", sampling_step: int = 1,
                         rng: Optional[random.Random] = None) -> np.ndarray:
    """The frame indices of one item (the reference's dataset.py:149-216):
    a clip shorter than ``num_frames`` repeats its last frame; "conseq" a
    strided window with a shift drawn from ``rng``; "random_conseq" a
    random stride too; "random" sorted distinct frames (numpy's global
    stream)."""
    rng = rng or random
    if num_frames > nframes:
        ntoadd = num_frames - nframes
        padding = (nframes - 1) * np.ones(ntoadd, dtype=int)
        return np.concatenate([np.arange(nframes), padding])
    if sampling in ("conseq", "random_conseq"):
        step_max = max((nframes - 1) // max(num_frames - 1, 1), 1)
        if sampling == "conseq":
            if sampling_step == -1 or sampling_step * (num_frames - 1) >= nframes:
                step = step_max
            else:
                step = sampling_step
        else:
            step = rng.randint(1, step_max)
        lastone = step * (num_frames - 1)
        shift_max = nframes - lastone - 1
        shift = rng.randint(0, max(0, shift_max - 1)) if shift_max > 1 else 0
        return shift + np.arange(0, lastone + 1, step)
    if sampling == "random":
        return np.sort(np.random.choice(nframes, num_frames, replace=False))
    raise ValueError(f"sampling {sampling} not recognized")


class _ActionDataset:
    """Common a2m logic: rot6d featurization + frame sampling."""

    num_classes: int = 12

    def __init__(self, num_frames: int = 60, sampling: str = "conseq",
                 sampling_step: int = 1, pose_rep: str = "rot6d",
                 translation: bool = True, glob: bool = True,
                 split: str = "train", seed: int = 1234):
        self.num_frames = num_frames
        self.sampling = sampling
        self.sampling_step = sampling_step
        self.pose_rep = pose_rep
        self.translation = translation
        self.glob = glob
        self.split = split
        self.rng = random.Random(seed)
        # subclasses fill: _pose (list of [T, 24*3]), _joints (list of
        # [T, J, 3] or None), _actions, _num_frames_in_video, _train/_test

    def __len__(self):
        return len(self._train if self.split == "train" else self._test)

    def _featurize(self, pose_aa: np.ndarray,
                   joints3d: Optional[np.ndarray]) -> np.ndarray:
        """[T, 24, 3] rotvecs (+ joints for translation) -> [T, J(+1), 6]."""
        pose = pose_aa
        if not self.glob:
            pose = pose[:, 1:]
        if self.pose_rep == "rot6d":
            feats = axis_angle_to_rot6d(pose)
        elif self.pose_rep == "rotvec":
            feats = np.pad(pose, ((0, 0), (0, 0), (0, 3)))
        else:
            raise ValueError(f"pose_rep {self.pose_rep} unsupported")
        if self.translation:
            assert joints3d is not None
            tr = joints3d[:, 0, :] - joints3d[0, 0, :]
            padded = np.zeros((feats.shape[0], 1, feats.shape[2]), np.float32)
            padded[:, 0, :3] = tr
            feats = np.concatenate([feats, padded], axis=1)
        return feats.astype(np.float32)

    @staticmethod
    def _flatten_channel_major(feats: np.ndarray) -> np.ndarray:
        """[T, J+1, 6] -> [T, 6*(J+1)] with feature index c*(J+1) + v.

        The reference flattens CHANNEL-major: per-item [J+1, 6, T] tensors
        collate to [B, J+1, 6, T], then ``permute(0, 3, 2, 1).flatten(2)``
        (data/utils.py:91) — every downstream consumer (the classifier
        slicing at ladiff.py:1475-1483 and Rotation2xyz's
        ``view(B, T, 6, 25)`` unpack at ladiff.py:152-153) assumes this
        order.  A joint-major flatten trains fine (dense layers absorb any
        fixed permutation) but scrambles rotations for the released
        classifiers and the SMPL forward pass."""
        return np.ascontiguousarray(feats.transpose(0, 2, 1)).reshape(
            feats.shape[0], -1)

    def __getitem__(self, index: int) -> dict:
        ids = self._train if self.split == "train" else self._test
        ind = ids[index]
        nframes = self._num_frames_in_video[ind]
        frame_ix = sample_frame_indices(nframes, self.num_frames,
                                        self.sampling, self.sampling_step,
                                        self.rng)
        pose = self._pose[ind].reshape(-1, 24, 3)[frame_ix]
        joints = (self._joints[ind][frame_ix]
                  if self._joints is not None else None)
        feats = self._featurize(pose, joints)  # [T, J(+1), 6]
        action = int(self._actions[ind])
        return {
            # [T, 6*(J+1)], reference channel-major feature order
            "motion": self._flatten_channel_major(feats),
            "action": action,
            "action_text": self._action_classes[action],
            "length": min(nframes, self.num_frames),
        }


class HumanAct12Dataset(_ActionDataset):
    """HumanAct12 (``humanact12poses.pkl``: poses, joints3D, y), 12
    classes; both splits are the whole set, as in the reference."""

    dataname = "humanact12"

    def __init__(self, datapath: str, **kwargs):
        super().__init__(**kwargs)
        with open(pjoin(datapath, "humanact12poses.pkl"), "rb") as f:
            data = pickle.load(f)
        self._pose = [np.asarray(x, np.float32) for x in data["poses"]]
        self._joints = [np.asarray(x, np.float32) for x in data["joints3D"]]
        self._actions = [int(x) for x in data["y"]]
        self._num_frames_in_video = [len(p) for p in self._pose]
        self.num_classes = 12
        self._action_classes = HUMANACT12_ACTION_NAMES
        self._train = list(range(len(self._pose)))
        self._test = list(range(len(self._pose)))

    @property
    def nfeats(self):
        return (24 + int(self.translation)) * 6


# the 18 action2motion joints selected out of VIBE's 49-joint output, with
# root (8) and nose (0) swapped (reference a2m/uestc.py:10-12)
ACTION2MOTION_JOINTS = [8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14,
                        21, 24, 38]

# 51 training subjects out of 118 (reference a2m/uestc.py:79-84)
UESTC_TRAIN_SUBJECTS = [
    1, 2, 6, 12, 13, 16, 21, 24, 28, 29, 30, 31, 33, 35, 39, 41, 42, 45,
    47, 50, 52, 54, 55, 57, 59, 61, 63, 64, 67, 69, 70, 71, 73, 77, 81,
    84, 86, 87, 88, 90, 91, 93, 96, 99, 102, 103, 104, 107, 108, 112, 113,
]


def get_z(cam_s, cam_pos, joints, img_size, flength):
    """Depth offset approximating the perspective camera with VIBE's
    orthographic one (reference a2m/uestc.py:15-28)."""
    joints_orth_target = (cam_s * (joints[:, :2] + cam_pos) + 1) * 0.5 * img_size
    height3d = np.linalg.norm(
        joints[:, :2].max(0) - joints[:, :2].min(0))
    height2d = np.linalg.norm(
        joints_orth_target.max(0) - joints_orth_target.min(0))
    return float(flength * (height3d / height2d))


def get_trans_from_vibe(vibe: dict, index: int,
                        use_z: bool = True) -> np.ndarray:
    """Per-frame global translation from VIBE's original-image camera
    (reference a2m/uestc.py:31-54), zeroed at the first frame."""
    alltrans = []
    for t in range(vibe["joints3d"][index].shape[0]):
        cam_orig = vibe["orig_cam"][index][t]  # [sx, sy, tx, ty]
        x, y = cam_orig[2], cam_orig[3]
        z = get_z(cam_s=cam_orig[0], cam_pos=cam_orig[2:4],
                  joints=vibe["joints3d"][index][t], img_size=540,
                  flength=500) if use_z else 0.0
        alltrans.append([x, y, z])
    alltrans = np.asarray(alltrans, np.float32)
    return alltrans - alltrans[0]


def _yaw_rotation(view: int) -> np.ndarray:
    """R_y(-view * pi/4) (reference a2m/uestc.py:146-151)."""
    theta = -view * np.pi / 4
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


class UESTCDataset(_ActionDataset):
    """UESTC (the reference's a2m/uestc.py:57-254), 40 classes, with the
    whole VIBE preprocessing:
    video-name parsing (a{act}_d{view}_p{subject}_c{side}), per-view yaw
    rotation of non-frontal captures to the front view, camera-derived
    global translation (cached to globtrans_usez.pkl), min-frame clamping,
    51/67 subject train/test split, and frame-count filtering of train."""

    dataname = "uestc"

    def __init__(self, datapath: str, view: str = "all", **kwargs):
        super().__init__(**kwargs)
        self.view = view
        pkl_path = pjoin(datapath, "vibe_cache_refined.pkl")
        if not os.path.exists(pkl_path):
            raise FileNotFoundError(
                f"UESTC preprocessed cache not found at {pkl_path}")
        with open(pkl_path, "rb") as f:
            vibe = pickle.load(f)

        info = pjoin(datapath, "info")
        with open(pjoin(info, "names.txt")) as f:
            videos = f.read().splitlines()
        with open(pjoin(info, "num_frames_min.txt")) as f:
            num_frames_video = np.asarray(
                [int(s) for s in f.read().splitlines()])
        with open(pjoin(info, "action_classes.txt")) as f:
            self._action_classes = np.array(f.read().splitlines())

        self._pose = [np.asarray(x, np.float32) for x in vibe["pose"]]
        self._joints = [np.asarray(x, np.float32)[:, ACTION2MOTION_JOINTS]
                        for x in vibe["joints3d"]]

        globpath = pjoin(datapath, "globtrans_usez.pkl")
        if os.path.exists(globpath):
            with open(globpath, "rb") as f:
                globtrans = pickle.load(f)
        else:
            # joints3d must be the full VIBE joints for the depth solve
            globtrans = [get_trans_from_vibe(vibe, i, use_z=True)
                         for i in range(len(self._pose))]
            try:
                with open(globpath, "wb") as f:
                    pickle.dump(globtrans, f)
            except OSError:
                pass
        self._globtrans = [np.asarray(g, np.float32) for g in globtrans]

        num_frames_video = np.minimum(
            num_frames_video, np.array([len(p) for p in self._pose]))
        self._num_frames_in_video = [int(x) for x in num_frames_video]

        self._actions = [self._parse_video(v)[0] for v in videos]
        self.num_classes = 40

        test_subjects = [s for s in range(1, 119)
                         if s not in UESTC_TRAIN_SUBJECTS]
        self._train, self._test = [], []
        self.info_actions = []
        for index, video in enumerate(videos):
            act, vw, subject, side = self._parse_video(video)
            self.info_actions.append({"action": act, "view": vw,
                                      "subject": subject, "side": side})
            if self.view == "frontview" and side != 1:
                continue
            if side != 1:
                if vw == 8:  # view 8 side 2 is dropped (uestc.py:172-174)
                    continue
                R = _yaw_rotation(vw)
                gmat = Q.axis_angle_to_matrix(torch.from_numpy(
                    self._pose[index][:, :3])).numpy()
                self._pose[index][:, :3] = Q.matrix_to_axis_angle(
                    torch.from_numpy(R @ gmat)).numpy().astype(np.float32)
                self._joints[index] = self._joints[index] @ R.T
                self._globtrans[index] = self._globtrans[index] @ R.T
            self._joints[index] = (self._joints[index]
                                   + self._globtrans[index][:, None])
            if subject in UESTC_TRAIN_SUBJECTS:
                self._train.append(index)
            elif subject in test_subjects:
                self._test.append(index)

        # drop train sequences below 3/4 of the requested window
        threshold = self.num_frames * 3 / 4 if self.num_frames > 0 else 0
        long_enough = set(np.where(num_frames_video >= threshold)[0].tolist())
        self._train = sorted(set(self._train) & long_enough)
        self._test = sorted(set(self._test))

    @staticmethod
    def _parse_video(videopath: str):
        """'a{act}_d{view}_p{subject}_c{side}_color.avi' -> ints
        (reference uestc.py:228-235)."""
        spl = videopath.split("_")
        return (int(spl[0][1:]), int(spl[1][1:]), int(spl[2][1:]),
                int(spl[3][1:]))

    @property
    def nfeats(self):
        return (24 + int(self.translation)) * 6


class ActionDataModule:
    """An action dataset behind the T2MDataModule's training interface:
    one dataset instance serves both splits (``split`` is an attribute of
    the dataset), ``loader`` yields collated numpy batches padded to
    ``num_frames`` in an order drawn from ``seed``.  ``mean`` / ``std`` are
    None: the features are rot6d (+ translation), not normalized."""

    is_a2m = True
    mean = None
    std = None

    def __init__(self, dataset, batch_size: int = 32):
        self._ds = dataset
        self.batch_size = batch_size
        self.name = type(dataset).__name__.replace("Dataset", "").lower()
        self.nfeats = dataset.nfeats
        self.njoints = 24 + int(dataset.translation)
        self.num_classes = dataset.num_classes
        self.num_frames = dataset.num_frames

    def dataset(self, split: str = "test"):
        self._ds.split = split
        return self._ds

    # the evaluation passes index the module like the raw dataset (its
    # current split)
    def __len__(self):
        return len(self._ds)

    def __getitem__(self, index: int):
        return self._ds[index]

    def loader(self, split: str, batch_size: Optional[int] = None,
               seed: int = 0, buckets=None):
        bs = batch_size or self.batch_size
        ds = self.dataset(split)
        order = np.random.RandomState(seed).permutation(len(ds))
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            yield a2m_collate([ds[int(i)] for i in idx], self.num_frames)


def a2m_collate(items: List[dict], num_frames: int) -> dict:
    """Items -> a batch (the reference's data/utils.py:78-97): "motion" [B,
    num_frames, F] zero-padded, "action" [B, 1], "action_text", "mask" [B,
    num_frames] and "length" [B], numpy."""
    B = len(items)
    F = items[0]["motion"].shape[1]
    motion = np.zeros((B, num_frames, F), np.float32)
    for i, b in enumerate(items):
        T = min(len(b["motion"]), num_frames)
        motion[i, :T] = b["motion"][:T]
    lengths = np.array([min(b["length"], num_frames) for b in items], np.int32)
    mask = np.arange(num_frames)[None, :] < lengths[:, None]
    return {
        "motion": motion,
        "action": np.array([[b["action"]] for b in items], np.int32),
        "action_text": [b["action_text"] for b in items],
        "mask": mask,
        "length": lengths,
    }


def generate_synthetic_uestc(root: str, n_videos: int = 24,
                             seed: int = 0) -> str:
    """Synthetic UESTC datapath with the real layout: a VIBE cache
    (pose/joints3d/orig_cam) + info/{names,num_frames_min,action_classes}.
    Video names cycle actions/views/subjects/sides so every preprocessing
    branch (front/side captures, train/test subjects) is exercised."""
    rng = np.random.RandomState(seed)
    os.makedirs(pjoin(root, "info"), exist_ok=True)
    names, nframes, poses, joints, cams = [], [], [], [], []
    subjects = [1, 3]  # 1 is a train subject, 3 is test
    for i in range(n_videos):
        act = i % 40
        view = i % 8
        subject = subjects[i % 2]
        side = 1 + (i % 2)
        names.append(f"a{act}_d{view}_p{subject:03d}_c{side}_color.avi")
        T = rng.randint(50, 90)
        nframes.append(T)
        poses.append(np.cumsum(
            rng.randn(T, 72).astype(np.float32) * 0.02, axis=0))
        joints.append(np.cumsum(
            rng.randn(T, 49, 3).astype(np.float32) * 0.01, axis=0))
        cam = np.ones((T, 4), np.float32)
        cam[:, 2:] = rng.randn(T, 2).astype(np.float32) * 0.1
        cams.append(cam)
    with open(pjoin(root, "vibe_cache_refined.pkl"), "wb") as f:
        pickle.dump({"pose": poses, "joints3d": joints, "orig_cam": cams}, f)
    with open(pjoin(root, "info", "names.txt"), "w") as f:
        f.write("\n".join(names))
    with open(pjoin(root, "info", "num_frames_min.txt"), "w") as f:
        f.write("\n".join(str(n) for n in nframes))
    with open(pjoin(root, "info", "action_classes.txt"), "w") as f:
        f.write("\n".join(f"action_{i}" for i in range(40)))
    return root


def generate_synthetic_humanact12(root: str, n_clips: int = 48,
                                  seed: int = 0) -> str:
    """Synthetic humanact12poses.pkl with the real file's schema."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    poses, joints, ys = [], [], []
    for _ in range(n_clips):
        T = rng.randint(40, 120)
        poses.append(np.cumsum(
            rng.randn(T, 72).astype(np.float32) * 0.02, axis=0))
        j = np.cumsum(rng.randn(T, 24, 3).astype(np.float32) * 0.01, axis=0)
        joints.append(j)
        ys.append(int(rng.randint(12)))
    with open(pjoin(root, "humanact12poses.pkl"), "wb") as f:
        pickle.dump({"poses": poses, "joints3D": joints, "y": ys}, f)
    return root
