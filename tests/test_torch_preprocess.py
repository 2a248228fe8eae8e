"""The port's offline preprocessing against the JAX package on the CPU: the
numpy quaternion helpers, ``Skeleton`` (IK, FK on quaternions and cont6d,
``qfix``), ``uniform_skeleton`` and ``process_file`` for HumanML3D and KIT,
also against the golden ``tests/golden/process_file.npz`` (a real motion),
the round trip through the port's torch ``recover_from_ric``, ``subsample``
/ ``upsample``, and each legacy dataset item by item on the synthetic tree
of ``tests/test_legacy_datasets.py``, seeded as the JAX classes are.

Tolerances: the same numpy code on both sides, so the features 1e-6
absolute (float32 quaternion calls, float64 elsewhere); the golden file
2e-4 and the round trip 5e-3 (the JAX package's own tests' tolerances);
the datasets' items exactly.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.data.humanml import np_quaternion as PQ
from ladiff_torch.data.humanml import process as pproc
from ladiff_torch.data.humanml import skeleton as pskel
from ladiff_tpu.data.humanml import process as rproc
from ladiff_tpu.data.humanml import quaternion as RQ
from ladiff_tpu.data.humanml import skeleton as rskel

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "process_file.npz")
TOL, GOLDEN_TOL, ROUNDTRIP_TOL = 1e-6, 2e-4, 5e-3


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_numpy_quaternions_match_jax():
    """The numpy helpers against the JAX module's numpy branch, bit for
    bit (float32 in, as ``skeleton.py`` / ``process.py`` call them)."""
    rng = np.random.RandomState(0)
    q = rng.randn(6, 5, 4).astype(np.float32)
    r = rng.randn(6, 5, 4).astype(np.float32)
    v = rng.randn(6, 5, 3).astype(np.float32)
    u = rng.randn(6, 5, 3).astype(np.float32)
    c6 = rng.randn(6, 5, 6).astype(np.float32)
    aa = (rng.randn(6, 5, 3) * 0.7).astype(np.float32)
    aa[0, 0] = 0.0
    qn = PQ.qnormalize(q)
    for name, args in (("qinv", (q,)), ("qnormalize", (q,)),
                       ("qmul", (q, r)), ("qrot", (qn, v)),
                       ("qbetween", (v, u)),
                       ("quaternion_to_matrix", (q,)),
                       ("quaternion_to_cont6d", (q,)),
                       ("cont6d_to_matrix", (c6,)),
                       ("axis_angle_to_quaternion", (aa,))):
        np.testing.assert_array_equal(getattr(PQ, name)(*args),
                                      getattr(RQ, name)(*args), name)


def _skeleton_pair(dataset, seed=1, T=8):
    """A skeleton with the dataset's chains at bone lengths from a seed, and
    joints from random rotations through its FK."""
    spec = pskel.SKELETONS[dataset]
    rng = np.random.RandomState(seed)
    J = spec["njoints"]
    bone = np.linspace(0.1, 0.4, J).astype(np.float32)
    bone[0] = 0
    offsets = spec["offsets"] * bone[:, None]
    aa = np.cumsum(rng.randn(T, J, 3).astype(np.float32) * 0.05, axis=0)
    quats = PQ.axis_angle_to_quaternion(aa)
    root = rng.randn(T, 3).astype(np.float32)
    ours = pskel.Skeleton(spec["offsets"], spec["chains"])
    theirs = rskel.Skeleton(rskel.SKELETONS[dataset]["offsets"],
                            rskel.SKELETONS[dataset]["chains"])
    ours.set_offset(offsets)
    theirs.set_offset(offsets)
    return ours, theirs, quats, root, offsets


@pytest.mark.parametrize("dataset", ["humanml3d", "kit"])
def test_skeleton_ik_fk_matches_jax(dataset):
    """FK (quaternions and cont6d), IK with and without the smoothed facing,
    ``get_offsets_joints``, ``qfix``; IK then FK gives the joints back."""
    ours, theirs, quats, root, _ = _skeleton_pair(dataset)
    for k in ("offsets", "face_joint_indx", "fid_l", "fid_r", "l_idx",
              "feet_thre", "njoints"):
        np.testing.assert_array_equal(pskel.SKELETONS[dataset][k],
                                      rskel.SKELETONS[dataset][k])
    assert ours.parents == theirs.parents and ours.njoints() == \
        theirs.njoints()
    joints = ours.forward_kinematics(quats, root)
    _close(joints, theirs.forward_kinematics(quats, root))
    _close(ours.forward_kinematics(quats, root, do_root_R=False),
           theirs.forward_kinematics(quats, root, do_root_R=False))
    c6 = PQ.quaternion_to_cont6d(quats)
    _close(ours.forward_kinematics_cont6d(c6, root),
           theirs.forward_kinematics_cont6d(c6, root))
    _close(ours.forward_kinematics_cont6d(c6, root, skel_joints=joints),
           theirs.forward_kinematics_cont6d(c6, root, skel_joints=joints))
    face = pskel.SKELETONS[dataset]["face_joint_indx"]
    for smooth in (False, True):
        q2 = ours.inverse_kinematics(joints, face, smooth_forward=smooth)
        _close(q2, theirs.inverse_kinematics(joints, face,
                                             smooth_forward=smooth))
    _close(ours.get_offsets_joints(joints[0]),
           theirs.get_offsets_joints(joints[0]))
    q2 = ours.inverse_kinematics(joints, face)
    _close(ours.forward_kinematics(q2, joints[:, 0]), joints, 1e-3)
    np.testing.assert_array_equal(pskel.qfix(q2), rskel.qfix(q2))


def _kit_motion(T=30):
    """A KIT-skeleton motion at a human scale (millimetres / 1000, legs
    along -y), with a target skeleton of other bone lengths."""
    ours, _, quats, root, offsets = _skeleton_pair("kit", seed=2, T=T)
    root = root * 0.1 + np.array([0, 1.0, 0], np.float32)
    joints = ours.forward_kinematics(quats, root)
    return joints, offsets * 1.1


@pytest.mark.parametrize("dataset", ["humanml3d", "kit"])
def test_process_file_matches_jax(dataset):
    """Retargeting, floor / origin / facing normalization, foot contacts,
    IK to cont6d, RIC positions and velocities: the features (263 or 251
    for T - 1 frames) and the three other outputs."""
    if dataset == "humanml3d":
        d = np.load(GOLDEN)
        joints, tgt = d["joints"].astype(np.float64), d["tgt_offsets"]
        thre, nfeats = 0.002, 263
    else:
        joints, tgt = _kit_motion()
        thre, nfeats = None, 251
    kw = dict(dataset=dataset, target_offsets=tgt)
    got = pproc.process_file(joints, thre, **kw)
    want = rproc.process_file(joints, thre, **kw)
    assert got[0].shape == (len(joints) - 1, nfeats)
    assert np.isfinite(got[0]).all()
    for g, w in zip(got, want):
        _close(g, w)
    _close(pproc.uniform_skeleton(joints[:, :len(tgt)].astype(np.float32),
                                  tgt, dataset),
           rproc.uniform_skeleton(joints[:, :len(tgt)].astype(np.float32),
                                  tgt, dataset))
    _close(pproc.process_file(joints, thre, dataset=dataset)[0],
           rproc.process_file(joints, thre, dataset=dataset)[0])


def test_process_file_golden_and_recover_roundtrip():
    """The golden reference features, and ``recover_from_ric`` (the port's
    torch decoder) gives back the canonical positions frame by frame."""
    from ladiff_torch.data.humanml.motion_repr import recover_from_ric
    d = np.load(GOLDEN)
    data, glob, _, _ = pproc.process_file(
        d["joints"].astype(np.float64), 0.002, dataset="humanml3d",
        target_offsets=d["tgt_offsets"])
    _close(data, d["data"], GOLDEN_TOL)
    _close(glob, d["glob"], GOLDEN_TOL)
    rec = recover_from_ric(torch.from_numpy(data).float()[None], 22)[0]
    _close(rec.numpy(), glob[:-1], ROUNDTRIP_TOL)
    from ladiff_tpu.data.humanml.motion_repr import \
        recover_from_ric as jax_recover
    _close(rec.numpy(), np.asarray(jax_recover(jnp.asarray(data)[None],
                                               22))[0], 1e-5)


def test_framerate_matches_jax():
    from ladiff_torch.data.framerate import subsample, upsample
    from ladiff_tpu.data.framerate import subsample as rsub
    from ladiff_tpu.data.framerate import upsample as rup
    for n, last, new in ((250, 100, 12.5), (40, 12.5, 12.5), (7, 24, 8)):
        np.testing.assert_array_equal(subsample(n, last, new),
                                      rsub(n, last, new))
    motion = np.random.RandomState(3).randn(9, 4, 3)
    for last, new in ((12.5, 100), (20, 20), (10, 30)):
        out = upsample(motion, last, new)
        np.testing.assert_array_equal(out, rup(motion, last, new))
        assert len(out) == (len(motion) - 1) * int(new / last) + 1
    with pytest.raises(AssertionError):
        subsample(10, 10, 20)


# -- the legacy datasets -------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from ladiff_tpu.data.synthetic import generate_synthetic_dataset
    p = tmp_path_factory.mktemp("synth")
    generate_synthetic_dataset(str(p), n_clips=24, seed=0)
    return str(p)


@pytest.fixture(scope="module")
def wvecs():
    from ladiff_torch.data.word_vectorizer import build_word_vectorizer
    from ladiff_tpu.data.word_vectorizer import \
        build_word_vectorizer as ref_build
    return build_word_vectorizer(None), ref_build(None)


def _paths(root):
    return dict(motion_dir=f"{root}/new_joint_vecs",
                text_dir=f"{root}/texts", split_file=f"{root}/train.txt")


def _stats(root):
    return np.load(f"{root}/Mean.npy"), np.load(f"{root}/Std.npy")


def _same_item(got, want):
    assert type(got) is type(want)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_item(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _same_items(ours, theirs, n=None):
    assert len(ours) == len(theirs) > 0
    for i in range(len(theirs) if n is None else min(n, len(theirs))):
        _same_item(ours[i], theirs[i])


@pytest.mark.parametrize("is_train,max_len", [(True, 20), (True, 60),
                                              (False, 20)])
def test_v1_dataset_matches_jax(root, wvecs, is_train, max_len):
    """``Text2MotionDatasetV1``: the curriculum crop (``reset_max_len``),
    ``rebias_std`` on train items, the unit-length snap on eval items; the
    same caption and crop draws item by item."""
    from ladiff_torch.data.humanml import legacy as P
    from ladiff_tpu.data.humanml import legacy as R
    mean, std = _stats(root)
    kw = dict(is_train=is_train, rebias=is_train, **_paths(root))
    ours = P.Text2MotionDatasetV1(mean, std, w_vectorizer=wvecs[0], **kw)
    theirs = R.Text2MotionDatasetV1(mean, std, w_vectorizer=wvecs[1], **kw)
    np.testing.assert_array_equal(ours.std, theirs.std)
    assert ours.name_list == theirs.name_list
    ours.reset_max_len(max_len)
    theirs.reset_max_len(max_len)
    _same_items(ours, theirs)
    np.testing.assert_array_equal(P.rebias_std(std, 22), R.rebias_std(std,
                                                                      22))


def test_baseline_and_snippet_datasets_match_jax(root, wvecs):
    from ladiff_torch.data.humanml import legacy as P
    from ladiff_tpu.data.humanml import legacy as R
    mean, std = _stats(root)
    _same_items(P.Text2MotionDatasetBaseline(mean, std,
                                             w_vectorizer=wvecs[0],
                                             **_paths(root)),
                R.Text2MotionDatasetBaseline(mean, std,
                                             w_vectorizer=wvecs[1],
                                             **_paths(root)))
    kw = dict(motion_dir=f"{root}/new_joint_vecs", window_size=32,
              rebias=True)
    ours = P.MotionDatasetV2(mean, std, f"{root}/train.txt", **kw)
    theirs = R.MotionDatasetV2(mean, std, f"{root}/train.txt", **kw)
    assert len(ours) == len(theirs)
    for i in (0, 1, len(theirs) // 2, len(theirs) - 1):
        _same_item(ours[i], theirs[i])


def test_text_datasets_match_jax(tmp_path, root, wvecs):
    """``RawTextDataset`` (the closed-class fallback tagger where spaCy is
    absent) and ``TextOnlyDataset``."""
    from ladiff_torch.data.humanml import legacy as P
    from ladiff_tpu.data.humanml import legacy as R
    mean, std = _stats(root)
    txt = tmp_path / "prompts.txt"
    txt.write_text("a person walks forward and waves\n\nsomeone jumps "
                   "twice then runs slowly\na man is kicking\n")
    ours = P.RawTextDataset(mean, std, str(txt), wvecs[0])
    theirs = R.RawTextDataset(mean, std, str(txt), wvecs[1])
    assert ours.data_dict == theirs.data_dict
    _same_items(ours, theirs)
    kw = dict(text_dir=f"{root}/texts", fixed_length=96)
    _same_items(P.TextOnlyDataset(mean, std, f"{root}/train.txt", **kw),
                R.TextOnlyDataset(mean, std, f"{root}/train.txt", **kw))
