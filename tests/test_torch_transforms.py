"""The port's TEMOS transform stack against the JAX package on the CPU:
``geometry``, ``Rifke`` (each jointstype, the helpers, batched against a
loop, normalization), ``SMPLVelP`` (canonicalization on and off, the
inverse), ``SMPLH`` on every ``jointstype`` with 22- and 52-joint poses,
``smplh_to``, the lazy ``SMPLDatastruct`` chain, ``collate`` and
``RotIdentityTransform``.

Sizes: 6 to 25 frames, the synthetic 128-vertex SMPL-H body (52 joints; its
21 vertex keypoints wrap: ``smplh_extra_vertex_ids % 128``).  Tolerances:
the numpy math 1e-6 absolute (the same float64 code); through the LBS
(float32 on both sides) 1e-5 norm-wise relative.
"""
import numpy as np
import pytest
import torch

from ladiff_torch import transforms as port
from ladiff_torch.transforms import geometry as pgeo
from ladiff_torch.transforms import joints2jfeats as pj2j
from ladiff_tpu import transforms as ref
from ladiff_tpu.transforms import geometry as rgeo
from ladiff_tpu.transforms import joints2jfeats as rj2j
from test_torch_slice import relerr

NP_TOL, LBS_TOL = 1e-6, 1e-5


def _rotmats(rng, shape):
    """Random proper rotations via QR."""
    q, _ = np.linalg.qr(rng.randn(*shape, 3, 3))
    q[..., :, 0] *= np.linalg.det(q)[..., None]
    return q


def _close(got, want, tol=NP_TOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# -- geometry ------------------------------------------------------------------

@pytest.mark.parametrize("rottype", ["rotvec", "axisangle", "rotmat",
                                     "matrix", "rot6d", "rotation6d"])
def test_geometry_conversions_match_jax(rottype):
    rng = np.random.RandomState(0)
    m = _rotmats(rng, (7, 5))
    assert pgeo.nfeats_of(rottype) == rgeo.nfeats_of(rottype)
    x = pgeo.matrix_to(rottype, m)
    _close(x, rgeo.matrix_to(rottype, m))
    _close(pgeo.to_matrix(rottype, x), rgeo.to_matrix(rottype, x))
    _close(pgeo.to_matrix(rottype, x), m)


def test_geometry_functions_match_jax():
    rng = np.random.RandomState(1)
    aa = rng.randn(20, 3) * 1.2
    aa[0] = 0.0
    m = _rotmats(rng, (20,))
    _close(pgeo.axis_angle_to_matrix(aa), rgeo.axis_angle_to_matrix(aa))
    _close(pgeo.matrix_to_quaternion(m), rgeo.matrix_to_quaternion(m))
    _close(pgeo.matrix_to_axis_angle(m), rgeo.matrix_to_axis_angle(m))
    d6 = rng.randn(20, 6)
    _close(pgeo.rotation_6d_to_matrix(d6), rgeo.rotation_6d_to_matrix(d6))
    _close(pgeo.matrix_to_rotation_6d(m), rgeo.matrix_to_rotation_6d(m))
    c, s = np.cos(aa[:, 0]), np.sin(aa[:, 0])
    for dim in (2, 3):
        for inv in (False, True):
            _close(pgeo.matrix_of_angles(c, s, inv, dim),
                   rgeo.matrix_of_angles(c, s, inv, dim))


# -- Rifke ---------------------------------------------------------------------

@pytest.mark.parametrize("jointstype,forward_filter",
                         [("mmm", False), ("mmmns", True),
                          ("humanml3d", False), ("humanml3d", True)])
def test_rifke_matches_jax(jointstype, forward_filter):
    """Forward features, the inverse, ``extract`` and the helpers."""
    nj = 22 if jointstype == "humanml3d" else 21
    joints = np.random.RandomState(2).randn(25, nj, 3) * 0.4
    ours = port.Rifke(jointstype=jointstype, forward_filter=forward_filter)
    theirs = ref.Rifke(jointstype=jointstype, forward_filter=forward_filter)
    feats = ours(joints)
    _close(feats, theirs(joints))
    _close(ours.inverse(feats), theirs.inverse(feats))
    for a, b in zip(ours.extract(feats), theirs.extract(feats)):
        _close(a, b)
    _close(pj2j.get_floor(joints, jointstype),
           rj2j.get_floor(joints, jointstype))
    _close(pj2j.get_forward_direction(joints[:, 1:], jointstype),
           rj2j.get_forward_direction(joints[:, 1:], jointstype))
    _close(pj2j.gaussian_filter1d(joints[:, 0], 2.0),
           rj2j.gaussian_filter1d(joints[:, 0], 2.0))
    if not forward_filter:
        # the inverse gives back the floored heights, and each frame's
        # ground-plane offsets from its root up to a rotation about y
        floored = joints.copy()
        floored[..., 1] -= pj2j.get_floor(joints, jointstype)
        back = ours.inverse(feats)
        _close(back[..., 1], floored[..., 1])

        def spread(p):
            return np.linalg.norm(p[..., [0, 2]] - p[..., :1, [0, 2]], axis=-1)
        _close(spread(back), spread(floored))


def test_rifke_batched_matches_loop_and_normalizes(tmp_path):
    joints = np.random.RandomState(3).randn(4, 25, 21, 3) * 0.4
    rifke = port.Rifke(jointstype="mmm")
    batched = rifke(joints)
    _close(batched, np.stack([rifke(j) for j in joints]), 1e-10)
    np.save(tmp_path / "jfeats_mean.npy", batched.mean((0, 1)))
    np.save(tmp_path / "jfeats_std.npy", batched.std((0, 1)))
    ours = port.Rifke(jointstype="mmm", path=str(tmp_path),
                      normalization=True)
    theirs = ref.Rifke(jointstype="mmm", path=str(tmp_path),
                       normalization=True)
    _close(ours(joints), theirs(joints))
    _close(ours.inverse(ours(joints)), theirs.inverse(theirs(joints)))
    with pytest.raises(NotImplementedError):
        port.Rifke(jointstype="smplh")


# -- SMPLVelP ------------------------------------------------------------------

@pytest.mark.parametrize("canonicalize,offset,pose_rep",
                         [(False, True, "rot6d"), (True, True, "rot6d"),
                          (True, False, "rotvec"), (False, True, "rotvec")])
def test_smplvelp_matches_jax(canonicalize, offset, pose_rep):
    rng = np.random.RandomState(4)
    rots = _rotmats(rng, (2, 18, 22))
    trans = rng.randn(2, 18, 3) * 0.3
    kw = dict(canonicalize=canonicalize, offset=offset, pose_rep=pose_rep)
    ours, theirs = port.SMPLVelP(**kw), ref.SMPLVelP(**kw)
    feats = ours(port.RotTransDatastruct(rots=rots, trans=trans))
    _close(feats, theirs(ref.RotTransDatastruct(rots=rots, trans=trans)))
    back, want = ours.inverse(feats), theirs.inverse(feats)
    assert isinstance(back, port.RotTransDatastruct)
    _close(back.rots, want.rots)
    _close(back.trans, want.trans)
    if not canonicalize:
        _close(back.rots, rots)


# -- SMPLH ---------------------------------------------------------------------

JOINTSTYPES = ("mmm", "mmmns", "smplmmm", "smplnh", "smplh", "vertices")


@pytest.fixture(scope="module")
def smplh_pair(tmp_path_factory):
    """The synthetic SMPL-H body on both sides (the asset is absent)."""
    absent = str(tmp_path_factory.mktemp("smplh") / "SMPLH_NEUTRAL.npz")
    return (port.SMPLH(path=absent, device="cpu"), ref.SMPLH(path=absent))


@pytest.mark.parametrize("jointstype", JOINTSTYPES)
def test_smplh_matches_jax(smplh_pair, jointstype):
    """22-joint poses (the mean hands filled in), batched [2, T], with a
    translation: every topology, through the LBS."""
    ours, theirs = smplh_pair
    rng = np.random.RandomState(5)
    data = port.RotTransDatastruct(rots=_rotmats(rng, (2, 6, 22)),
                                   trans=rng.randn(2, 6, 3) * 0.3)
    got = ours(data, jointstype=jointstype)
    want = theirs(data, jointstype=jointstype)
    nout = {"vertices": 128, "smplh": 73, "smplnh": 22}.get(jointstype, 21)
    assert got.shape == want.shape == (2, 6, nout, 3)
    assert got.dtype == np.float64
    assert relerr(got, want) <= LBS_TOL


@pytest.mark.parametrize("jointstype", ["smplh", "vertices"])
def test_smplh_full_hands_without_trans(smplh_pair, jointstype):
    """52-joint poses, no translation, betas given."""
    ours, theirs = smplh_pair
    rng = np.random.RandomState(6)
    data = port.RotTransDatastruct(rots=_rotmats(rng, (12, 52)), trans=None)
    betas = rng.randn(10)
    got = ours.forward(data, jointstype, betas=betas)
    want = theirs.forward(data, jointstype, betas=betas)
    assert relerr(got, want) <= LBS_TOL
    with pytest.raises(NotImplementedError):
        ours(port.RotTransDatastruct(rots=_rotmats(rng, (5, 24))))
    with pytest.raises(NotImplementedError):
        ours.inverse(got)


def test_smplh_to_matches_jax():
    from ladiff_torch.transforms.rots2joints import smplh_to
    from ladiff_tpu.transforms.rots2joints import smplh_to as ref_smplh_to
    rng = np.random.RandomState(7)
    data, trans = rng.randn(2, 9, 73, 3), rng.randn(2, 9, 3)
    for jt in JOINTSTYPES:
        _close(smplh_to(jt, data.copy(), trans.copy()),
               ref_smplh_to(jt, data.copy(), trans.copy()))
    with pytest.raises(NotImplementedError):
        smplh_to("humanml3d", data, trans)


def test_smplh_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA device"):
        port.SMPLH(path=str(tmp_path / "absent.npz"))


# -- datastructs ---------------------------------------------------------------

def test_smpl_datastruct_chain_matches_jax(smplh_pair):
    """features -> rots -> joints (mmm) -> jfeats, lazily and cached, and
    collate's padding, against the JAX chain."""
    rng = np.random.RandomState(8)
    rots, trans = _rotmats(rng, (12, 22)), rng.randn(12, 3) * 0.2
    rfeats = port.SMPLVelP()(port.RotTransDatastruct(rots=rots, trans=trans))
    ours_tf = port.SMPLTransform(rots2joints=smplh_pair[0])
    theirs_tf = ref.SMPLTransform(rots2joints=smplh_pair[1])
    ours = ours_tf.Datastruct(features=rfeats)
    theirs = theirs_tf.Datastruct(features=rfeats)
    assert ours.rfeats is rfeats and len(ours) == 12
    _close(ours.rots.rots, theirs.rots.rots)
    assert ours.joints.shape == (12, 21, 3)
    assert relerr(ours.joints, theirs.joints) <= LBS_TOL
    assert ours.jfeats.shape == (12, 1 + 20 * 3 + 3)
    assert relerr(ours.jfeats, theirs.jfeats) <= LBS_TOL
    assert ours.joints_ is not None
    assert sorted(ours.keys()) == sorted(theirs.keys())
    batch = ours_tf.collate([ours_tf.Datastruct(features=rfeats),
                             ours_tf.Datastruct(features=rfeats[:4])])
    want = theirs_tf.collate([theirs_tf.Datastruct(features=rfeats),
                              theirs_tf.Datastruct(features=rfeats[:4])])
    _close(batch.features, want.features)
    assert batch.features.shape == (2, 12, rfeats.shape[-1])
    assert not batch.features[1, 4:].any()
    assert batch.joints_ is None and ours.detach().features is rfeats


def test_rot_identity_transform_and_padding():
    rng = np.random.RandomState(9)
    tf = port.RotIdentityTransform()
    ds = tf.Datastruct(rots=rng.randn(5, 22, 3, 3), trans=rng.randn(5, 3))
    assert len(ds) == 5 and list(ds.datakeys) == ["rots", "trans"]
    assert isinstance(ds.transforms, port.RotIdentityTransform)
    assert repr(tf) == repr(ref.RotIdentityTransform())
    arrays = [rng.randn(4, 3), rng.randn(2, 5), rng.randn(3, 1)]
    np.testing.assert_array_equal(port.collate_tensor_with_padding(arrays),
                                  ref.collate_tensor_with_padding(arrays))
    batch = tf.collate([ds, tf.Datastruct(rots=ds.rots[:3],
                                          trans=ds.trans[:3])])
    assert batch.rots.shape == (2, 5, 22, 3, 3) and not batch.trans[1, 3:].any()


def test_smplh_mean_hands_from_file(tmp_path):
    """An SMPL-H file with non-zero mean hands: a 22-joint pose takes them
    (as matrices) for the 30 hand joints."""
    from ladiff_tpu.smpl.body_model import SMPLModel as JaxSMPL
    src = JaxSMPL.synthetic(seed=2, model_type="smplh")
    rng = np.random.RandomState(10)
    path = str(tmp_path / "SMPLH_NEUTRAL.npz")
    np.savez(path, v_template=np.asarray(src.v_template),
             shapedirs=np.asarray(src.shapedirs),
             posedirs=np.asarray(src.posedirs).T.reshape(128, 3, -1),
             J_regressor=np.asarray(src.J_regressor),
             weights=np.asarray(src.weights),
             kintree_table=np.stack([np.r_[0, src.parents[1:]],
                                     np.arange(52)]),
             hands_meanl=0.3 * rng.randn(45), hands_meanr=0.3 * rng.randn(45))
    ours, theirs = port.SMPLH(path=path, device="cpu"), ref.SMPLH(path=path)
    assert np.abs(ours.model.hands_mean).max() > 0.1
    _close(ours._hands_mean_matrix, theirs._hands_mean_matrix)
    data = port.RotTransDatastruct(rots=_rotmats(rng, (12, 22)),
                                   trans=rng.randn(12, 3))
    for jt in ("smplh", "mmm"):
        assert relerr(ours(data, jt), theirs(data, jt)) <= LBS_TOL
