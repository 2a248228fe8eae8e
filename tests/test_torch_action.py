"""The action family's modules in the PyTorch port against the JAX package
on the CPU: the SMPL body model (synthetic and loaded), ``Rotation2xyz``,
the ActorVae, ``EmbedAction`` and the action denoiser, the GRU and ST-GCN
classifiers and their checkpoint loaders, the HumanAct12 and UESTC data
(synthetic files, items, collate, the datamodule's batches) and the action
metrics.  Mirrors ``tests/test_a2m.py`` and ``tests/test_uestc.py`` case
for case, each held to the JAX package.

Sizes: d 64, 2 or 3 layers, ff 128, 4 heads, 24 frames, 150 features,
``SMPLModel.synthetic(n_verts=32)``.  Inputs come from numpy seeds, JAX
params through ``ladiff_torch.convert``, every JAX draw (the posterior
noise, the action drop) is handed to the port.  Tolerance: 1e-4 relative,
norm-wise, on every output (float32 on both sides); the data's items
within 1e-6 (the same float32 rotations), the metrics 1e-10 (the same numpy
code).
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import (actor_vae_state_dict, flax_state_dict,
                                  gru_classifier_state_dict,
                                  stgcn_state_dict)
from test_torch_metrics import same_dict
from test_torch_slice import randomize, relerr

NFEATS, T, D, TOL = 150, 24, 64, 1e-4
LENGTHS = np.array([24, 13, 1], np.int32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# -- SMPL and Rotation2xyz --------------------------------------------------

def test_smpl_synthetic_matches_jax():
    """``SMPLModel.synthetic`` draws the JAX package's body tensor for
    tensor; ``forward`` (axis-angle, betas, translation) gives its joints
    and vertices."""
    from ladiff_torch.smpl.body_model import SMPLModel
    from ladiff_tpu.smpl.body_model import SMPLModel as JaxSMPL
    ours, theirs = SMPLModel.synthetic(n_verts=32, seed=3), JaxSMPL.synthetic(
        n_verts=32, seed=3)
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                 "weights"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)))
    np.testing.assert_array_equal(ours.parents, theirs.parents)
    rng = np.random.RandomState(0)
    aa = (0.4 * rng.randn(5, 24, 3)).astype(np.float32)
    betas = (0.5 * rng.randn(10)).astype(np.float32)
    trans = rng.randn(5, 3).astype(np.float32)
    jj, jv = jax.jit(lambda *a: theirs.forward(*a, return_vertices=True))(
        aa, betas, trans)
    tj, tv = ours.forward(_t(aa), _t(betas), _t(trans), return_vertices=True)
    assert relerr(tj.numpy(), jj) <= TOL and relerr(tv.numpy(), jv) <= TOL
    assert relerr(ours.forward(_t(aa), _t(betas)).numpy(), jj - trans[:, None]
                  ) <= TOL


def test_smpl_load_matches_jax(tmp_path):
    """``SMPLModel.load`` reads an SMPL pickle (posedirs in the on-disk
    [V, 3, (J-1) 9] layout, a kintree) as the JAX package does; a missing
    file gives None."""
    from ladiff_torch.smpl.body_model import SMPLModel
    from ladiff_tpu.smpl.body_model import SMPLModel as JaxSMPL
    src = JaxSMPL.synthetic(n_verts=32, seed=4)
    V = 32
    posedirs = np.asarray(src.posedirs).T.reshape(V, 3, -1)
    kintree = np.stack([np.r_[-1, src.parents[1:]], np.arange(24)])
    d = {"v_template": np.asarray(src.v_template),
         "shapedirs": np.asarray(src.shapedirs), "posedirs": posedirs,
         "J_regressor": np.asarray(src.J_regressor),
         "weights": np.asarray(src.weights), "kintree_table": kintree}
    path = str(tmp_path / "SMPL_NEUTRAL.pkl")
    with open(path, "wb") as f:
        pickle.dump(d, f)
    ours, theirs = SMPLModel.load(path), JaxSMPL.load(path)
    np.testing.assert_array_equal(ours.posedirs.numpy(),
                                  np.asarray(theirs.posedirs))
    np.testing.assert_array_equal(ours.parents, theirs.parents)
    rng = np.random.RandomState(1)
    rot = (0.3 * rng.randn(4, 24, 3)).astype(np.float32)
    _, tv = ours.forward(_t(rot), torch.zeros(10), return_vertices=True)
    _, jv = jax.jit(lambda r: theirs.forward(r, jnp.zeros(10),
                                             return_vertices=True))(rot)
    assert relerr(tv.numpy(), jv) <= TOL
    assert SMPLModel.load(str(tmp_path / "absent.pkl")) is None


@pytest.mark.parametrize("jointstype,vertstrans,chunk",
                         [("smpl", True, 0), ("vertices", False, 0),
                          ("smpl", True, 7), ("vertices", False, 7)])
def test_rotation2xyz_matches_jax(jointstype, vertstrans, chunk):
    """Channel-major unpack, the translation node, identity rot6d on masked
    frames, outputs zeroed there before the root-centering, the frame-0
    translation re-centred; in chunks of 7 frames too."""
    from ladiff_torch.smpl.body_model import SMPLModel
    from ladiff_torch.transforms.rotation2xyz import (Rotation2xyz,
                                                      rotation_6d_to_matrix)
    from ladiff_tpu.smpl.body_model import SMPLModel as JaxSMPL
    from ladiff_tpu.transforms.rotation2xyz import (
        Rotation2xyz as JaxR2X, rotation_6d_to_matrix_jnp)
    rng = np.random.RandomState(2)
    feats = rng.randn(3, 20, NFEATS).astype(np.float32)
    mask = np.arange(20)[None] < np.array([20, 13, 5])[:, None]
    ours = Rotation2xyz(SMPLModel.synthetic(n_verts=32), chunk)
    theirs = JaxR2X(JaxSMPL.synthetic(n_verts=32), chunk)
    got = ours(_t(feats), _t(mask), jointstype=jointstype,
               vertstrans=vertstrans)
    want = jax.jit(lambda f, m: theirs(f, m, jointstype=jointstype,
                                       vertstrans=vertstrans))(feats, mask)
    assert got.shape == want.shape and relerr(got.numpy(), want) <= TOL
    assert torch.isfinite(got).all()
    d6 = rng.randn(7, 6).astype(np.float32)
    assert relerr(rotation_6d_to_matrix(_t(d6)).numpy(),
                  rotation_6d_to_matrix_jnp(jnp.asarray(d6))) <= TOL


# -- ActorVae, EmbedAction and the action denoiser ---------------------------

def cond_drop_key(jden, params, key):
    """The key the JAX denoiser's ``EmbedAction`` draws its drop from: its
    first ``make_rng("cond_drop")`` under ``rngs={"cond_drop": key}``."""
    return jden.apply({"params": params}, rngs={"cond_drop": key},
                      method=lambda m: m.make_rng("cond_drop"))


def _jax_module(module, seed, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return randomize(shapes["params"], seed)


def test_actor_vae_matches_jax():
    """``encode`` (mu, logvar and the sample with the JAX draw), ``decode``
    (padded frames zero) of the same weights; the 4-tuple of the LA-VAE."""
    from ladiff_torch.models.actor_vae import ActorVae
    from ladiff_tpu.models.actor_vae import ActorVae as JaxActorVae
    jvae = JaxActorVae(nfeats=NFEATS, latent_dim=(1, D), ff_size=128,
                       num_layers=2, num_heads=4, dropout=0.0)
    B = len(LENGTHS)
    rng = np.random.RandomState(3)
    feats = (0.5 * rng.randn(B, T, NFEATS)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    params = _jax_module(jvae, 5, jnp.asarray(feats), jnp.asarray(LENGTHS),
                         key)
    vae = ActorVae(NFEATS, (1, D), 128, 2, 4).eval()
    vae.load_state_dict(actor_vae_state_dict(params, ""), strict=True)
    def encode_decode(p, f, n, k):
        z, mu, logvar, _ = jvae.apply({"params": p}, f, n, rng=k,
                                      method=jvae.encode)
        return z, mu, logvar, jvae.apply({"params": p}, z, n, nframes=T,
                                         method=jvae.decode)

    z, mu, logvar, dec = jax.jit(encode_decode)(params, feats, LENGTHS, key)
    eps = _t(jax.random.normal(key, (B, D)))[:, None]
    with torch.no_grad():
        tz, tmu, tlv, tvalid = vae.encode(_t(feats), _t(LENGTHS).long(),
                                          eps=eps)
        out = vae.decode(tz, _t(LENGTHS).long(), T)
    for got, want in ((tz, z), (tmu, mu), (tlv, logvar)):
        assert got.shape == (B, 1, D) and relerr(got.numpy(), want) <= TOL
    assert tvalid.all() and tvalid.shape == (B, 1)
    assert out.shape == (B, T, NFEATS) and relerr(out.numpy(), dec) <= TOL
    assert (out[1, 13:] == 0).all() and (out[2, 1:] == 0).all()


def test_embed_action_matches_jax():
    """The class table, ``force_mask``'s zeros, and the training drop of
    the JAX draw; ``embed_action`` gives [B, 1, D]."""
    from ladiff_torch.models.denoiser import EmbedAction
    from ladiff_tpu.models.denoiser import EmbedAction as JaxEmbed
    jemb = JaxEmbed(num_actions=12, latent_dim=D, guidance_uncondp=0.5)
    ids = np.array([3, 0, 11, 7, 7, 2], np.int32)
    params = _jax_module(jemb, 6, jnp.asarray(ids))
    emb = EmbedAction(12, D, 0.5)
    emb.load_state_dict(flax_state_dict(params), strict=True)
    want = jemb.apply({"params": params}, jnp.asarray(ids))
    assert relerr(emb.eval()(_t(ids)).detach().numpy(), want) <= TOL
    assert not emb(_t(ids), force_mask=True).any()
    key = jax.random.PRNGKey(7)
    want = jemb.apply({"params": params}, jnp.asarray(ids),
                      deterministic=False, rng=key)
    drop = _t(jax.random.bernoulli(key, 0.5, (len(ids), 1)))
    assert drop.any() and not drop.all()
    got = emb.train()(_t(ids), drop=drop).detach().numpy()
    assert relerr(got, want) <= TOL


@pytest.mark.parametrize("train", [False, True])
def test_action_denoiser_matches_jax(train):
    """The plain skip denoiser under the action condition on 3-token
    samples [latent; time; action]: the time embedding's sinusoid at width
    D, the class token, in training the JAX drop mask replayed."""
    from ladiff_torch.models.denoiser import LADenoiser
    from ladiff_tpu.models.denoiser import LADenoiser as JaxDenoiser
    kw = dict(latent_dim=(1, D), ff_size=128, num_layers=3, num_heads=4)
    jden = JaxDenoiser(nfeats=NFEATS, condition="action", nclasses=12,
                       guidance_uncondp=0.5, md_trans=False, dropout=0.0,
                       **kw)
    B = 5
    rng = np.random.RandomState(8)
    x = rng.randn(B, 1, D).astype(np.float32)
    t = np.array([0, 999, 500, 17, 250], np.int32)
    ids = np.array([1, 11, 4, 4, 0], np.int32)
    params = _jax_module(jden, 9, jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(ids), None)
    den = LADenoiser(NFEATS, md_trans=False, condition="action", nclasses=12,
                     guidance_uncondp=0.5, **kw)
    den.load_state_dict(flax_state_dict(params), strict=True)
    assert den.time_embedding.linear_1.in_features == D
    key = jax.random.PRNGKey(10)
    want = jax.jit(lambda p, *a: jden.apply(
        {"params": p}, *a, None, deterministic=not train,
        rngs={"cond_drop": key, "dropout": key} if train else {}))(
            params, x, t, ids)
    drop = None
    if train:
        drop = _t(jax.random.bernoulli(cond_drop_key(jden, params, key), 0.5,
                                       (B, 1))).reshape(B, 1, 1)
        assert drop.any() and not drop.all()
    got = den.train(train)(_t(x), _t(t).long(), _t(ids).long(),
                           cond_drop=drop)
    assert got.shape == (B, 1, D)
    assert relerr(got.detach().numpy(), want) <= TOL


# -- classifiers ------------------------------------------------------------

def test_gru_classifier_matches_jax():
    """The HumanAct12 GRU (2 layers, 72 inputs) of converted weights:
    features and logits at each sample's last valid frame."""
    from ladiff_torch.models.classifiers import MotionDiscriminator
    from ladiff_tpu.models.classifiers import MotionDiscriminator as JaxGRU
    jclf = JaxGRU(input_size=72, hidden_size=16, hidden_layer=2,
                  output_size=12)
    rng = np.random.RandomState(11)
    x = rng.randn(3, 20, 72).astype(np.float32)
    lengths = np.array([20, 15, 1], np.int32)
    params = _jax_module(jclf, 12, jnp.asarray(x), jnp.asarray(lengths))
    clf = MotionDiscriminator(72, 16, 2, 12).eval()
    clf.load_state_dict(gru_classifier_state_dict(params), strict=True)
    wf, wl = jax.jit(lambda p, *a: jclf.apply({"params": p}, *a))(
        params, x, lengths)
    with torch.no_grad():
        gf, gl = clf(_t(x), _t(lengths))
    assert relerr(gf.numpy(), wf) <= TOL and relerr(gl.numpy(), wl) <= TOL


def _stgcn_params(seed=13, num_class=40, T_in=16):
    """The JAX ST-GCN's params, random, with BN statistics that are not the
    identity (a frozen BN is an affine map of them)."""
    from ladiff_tpu.models.classifiers import STGCN as JaxSTGCN
    jclf = JaxSTGCN(in_channels=6, num_class=num_class, num_nodes=24)
    params = _jax_module(jclf, seed, jnp.zeros((1, T_in, 24, 6)))
    rng = np.random.RandomState(seed)

    def fix(path, a):
        name = str(path[-1].key)
        if name == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        if name == "mean":
            return (0.2 * rng.randn(*a.shape)).astype(np.float32)
        return a

    return jclf, jax.tree_util.tree_map_with_path(fix, params)


def test_stgcn_matches_jax():
    """The UESTC ST-GCN of converted weights on the reference's input
    slicing: adjacency, features [B, 256] and logits."""
    from ladiff_torch.models.classifiers import (STGCN, smpl_graph_adjacency,
                                                 stgcn_input_from_feats)
    from ladiff_tpu.models.classifiers import (
        smpl_graph_adjacency as jax_adjacency,
        stgcn_input_from_feats as jax_slice)
    np.testing.assert_array_equal(smpl_graph_adjacency(24),
                                  jax_adjacency(24))
    jclf, params = _stgcn_params()
    clf = STGCN(in_channels=6, num_class=40, num_nodes=24).eval()
    clf.load_state_dict(stgcn_state_dict(params), strict=True)
    rng = np.random.RandomState(14)
    feats = rng.randn(3, 16, NFEATS).astype(np.float32)
    x = stgcn_input_from_feats(_t(feats))
    np.testing.assert_array_equal(x.numpy(), jax_slice(jnp.asarray(feats)))
    wf, wl = jax.jit(lambda p, f: jclf.apply({"params": p}, jax_slice(f)))(
        params, feats)
    with torch.no_grad():
        gf, gl = clf(x)
    assert gf.shape == (3, 256) and gl.shape == (3, 40)
    assert relerr(gf.numpy(), wf) <= TOL and relerr(gl.numpy(), wl) <= TOL


def test_classifier_checkpoints_load(tmp_path):
    """Reference-layout checkpoints (``{"model": state_dict}`` for the GRU,
    a bare state dict for the ST-GCN) load strictly into the port and read
    as the JAX package's loaders read them; absent files give None."""
    from ladiff_torch.models.classifiers import (
        STGCN, MotionDiscriminator, load_gru_classifier_checkpoint,
        load_stgcn_checkpoint)
    from ladiff_tpu.models import classifiers as J
    gru = MotionDiscriminator(72, 16, 2, 12)
    torch.save({"model": gru.state_dict()}, str(tmp_path / "gru.tar"))
    MotionDiscriminator(72, 16, 2, 12).load_state_dict(
        load_gru_classifier_checkpoint(str(tmp_path / "gru.tar")))
    jp = J.load_gru_classifier_checkpoint(str(tmp_path / "gru.tar"))
    assert relerr(gru_classifier_state_dict(jp)["recurrent.weight_hh_l1"],
                  gru.recurrent.weight_hh_l1.detach()) == 0.0
    st = STGCN(num_class=40)
    torch.save(st.state_dict(), str(tmp_path / "st.tar"))
    STGCN(num_class=40).load_state_dict(
        load_stgcn_checkpoint(str(tmp_path / "st.tar")), strict=True)
    jp = J.load_stgcn_checkpoint(str(tmp_path / "st.tar"))
    sd = stgcn_state_dict(jp)
    for k, v in st.state_dict().items():
        assert torch.equal(sd[k].to(v.dtype), v), k
    assert load_gru_classifier_checkpoint(str(tmp_path / "no.tar")) is None
    assert load_stgcn_checkpoint(str(tmp_path / "no.tar")) is None


def test_reference_action_checkpoints_load(tmp_path):
    """A reference stage-2 checkpoint of the action family (``vae.*`` with
    the ActorVae's sine tables, ``denoiser.*``) loads strictly through
    ``load_reference_actor_vae_checkpoint`` and
    ``load_reference_action_denoiser_checkpoint``."""
    from ladiff_torch.models.actor_vae import ActorVae
    from ladiff_torch.models.denoiser import LADenoiser
    from ladiff_torch.utils.checkpoint import (
        load_reference_action_denoiser_checkpoint,
        load_reference_actor_vae_checkpoint)
    vae = ActorVae(NFEATS, (1, D), 128, 2, 4)
    den = LADenoiser(NFEATS, (1, D), 128, 3, 4, md_trans=False,
                     condition="action")
    sd = {**{f"vae.{k}": v for k, v in vae.state_dict().items()},
          **{f"denoiser.{k}": v for k, v in den.state_dict().items()},
          "vae.encoder.sequence_pos_encoding.pe": torch.zeros(500, 1, D),
          "vae.decoder.sequence_pos_encoding.pe": torch.zeros(500, 1, D)}
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": sd}, path)
    vae2 = ActorVae(NFEATS, (1, D), 128, 2, 4)
    den2 = LADenoiser(NFEATS, (1, D), 128, 3, 4, md_trans=False,
                      condition="action")
    load_reference_actor_vae_checkpoint(vae2, path)
    load_reference_action_denoiser_checkpoint(den2, path)
    for a, b in ((vae, vae2), (den, den2)):
        for k, v in a.state_dict().items():
            assert torch.equal(b.state_dict()[k], v), k


# -- data ---------------------------------------------------------------------

def test_rotation_helpers_match_jax():
    """rot6d of axis angles (pytorch3d's rows), Rodrigues and its inverse as
    the JAX package's numpy geometry computes them."""
    from ladiff_torch.data import a2m
    from ladiff_torch.data.humanml import quaternion as Q
    from ladiff_tpu.data import a2m as ja2m
    from ladiff_tpu.transforms import geometry as G
    rng = np.random.RandomState(15)
    aa = (0.5 * rng.randn(5, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(a2m.axis_angle_to_rot6d(aa),
                               ja2m.axis_angle_to_rot6d(aa), atol=1e-6)
    aa64 = 1.5 * rng.randn(50, 3)
    aa64[0] = 0.0
    m = Q.axis_angle_to_matrix(_t(aa64)).numpy()
    np.testing.assert_allclose(m, G.axis_angle_to_matrix(aa64), atol=1e-12)
    np.testing.assert_allclose(Q.matrix_to_axis_angle(_t(m)).numpy(),
                               G.matrix_to_axis_angle(m), atol=1e-10)


def test_frame_sampling_matches_jax():
    """The "conseq" window and its shift from the same ``random.Random``
    stream; a short clip repeats its last frame."""
    import random
    from ladiff_torch.data.a2m import sample_frame_indices
    from ladiff_tpu.data.a2m import sample_frame_indices as jax_sample
    for args in ((100, 60), (30, 60), (200, 60, "conseq", -1),
                 (200, 60, "random_conseq"), (61, 60, "conseq", 1)):
        got = sample_frame_indices(*args, rng=random.Random(5))
        np.testing.assert_array_equal(
            got, jax_sample(*args, rng=random.Random(5)))
    idx = sample_frame_indices(30, 60)
    assert len(idx) == 60 and (idx[30:] == 29).all()


@pytest.fixture(scope="module")
def a2m_roots(tmp_path_factory):
    """Synthetic HumanAct12 and UESTC roots written by each package."""
    from ladiff_torch.data import a2m
    from ladiff_tpu.data import a2m as ja2m
    base = tmp_path_factory.mktemp("a2m_data")
    roots = {}
    for name, kw in (("humanact12", dict(n_clips=24, seed=0)),
                     ("uestc", dict(n_videos=24, seed=0))):
        roots[name] = tuple(
            getattr(mod, f"generate_synthetic_{name}")(
                str(base / f"{side}_{name}"), **kw)
            for side, mod in (("torch", a2m), ("jax", ja2m)))
    return roots


def _same_files(a, b):
    for root, _, files in os.walk(b):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), b)
            if rel == "globtrans_usez.pkl":  # each reader's cache
                continue
            with open(os.path.join(a, rel), "rb") as fa, open(
                    os.path.join(b, rel), "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("name", ["humanact12", "uestc"])
def test_action_datasets_match_jax(a2m_roots, name):
    """The synthetic writers give the JAX package's files byte for byte;
    every item of both splits (motion [60, 150], action, length) and the
    collated batch are the JAX dataset's."""
    from ladiff_torch.data import a2m
    from ladiff_tpu.data import a2m as ja2m
    troot, jroot = a2m_roots[name]
    _same_files(troot, jroot)
    cls = "HumanAct12Dataset" if name == "humanact12" else "UESTCDataset"
    ds = getattr(a2m, cls)(troot, num_frames=60)
    jds = getattr(ja2m, cls)(jroot, num_frames=60)
    assert ds.nfeats == jds.nfeats == NFEATS
    for split in ("train", "test"):
        ds.split = jds.split = split
        assert len(ds) == len(jds) > 0
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            assert got["motion"].shape == (60, NFEATS)
            np.testing.assert_allclose(got["motion"], want["motion"],
                                       atol=1e-6)
            assert (got["action"], got["length"], got["action_text"]) == (
                want["action"], want["length"], want["action_text"])
        batch = a2m.a2m_collate([ds[i] for i in range(4)], 60)
        jbatch = ja2m.a2m_collate([jds[i] for i in range(4)], 60)
        for key in ("action", "mask", "length"):
            np.testing.assert_array_equal(batch[key], jbatch[key])
        assert batch["motion"].shape == (4, 60, NFEATS)


def test_uestc_preprocessing_matches_jax(a2m_roots):
    """UESTC's subject split, view rotation of the side captures, camera
    translation zeroed at the first frame and joints carrying it, the
    front-view filter: as the JAX package computes them."""
    from ladiff_torch.data import a2m
    from ladiff_tpu.data import a2m as ja2m
    troot, jroot = a2m_roots["uestc"]
    ds = a2m.UESTCDataset(troot, num_frames=60)
    jds = ja2m.UESTCDataset(jroot, num_frames=60)
    assert (ds._train, ds._test) == (jds._train, jds._test)
    assert ds.info_actions == jds.info_actions
    for i in range(len(ds._pose)):
        np.testing.assert_allclose(ds._pose[i], jds._pose[i], atol=1e-6)
        np.testing.assert_allclose(ds._joints[i], jds._joints[i], atol=1e-5)
        np.testing.assert_allclose(ds._globtrans[i][0], 0.0, atol=1e-7)
    front = a2m.UESTCDataset(troot, num_frames=60, view="frontview")
    assert front._train == ja2m.UESTCDataset(jroot, num_frames=60,
                                             view="frontview")._train
    assert all(front.info_actions[i]["side"] == 1 for i in front._train)


def test_action_datamodule_matches_jax(a2m_roots):
    """``get_datasets`` on the published HumanAct12 configuration: 150
    features, 25 joints, 12 classes written back to the configuration, and
    the loader's batches (seeded order) equal to the JAX datamodule's."""
    from ladiff_torch.config import assemble_config
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_tpu.config import assemble_config as jax_assemble
    from ladiff_tpu.data.datamodule import get_datasets as jax_get
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    troot, jroot = a2m_roots["humanact12"]

    def cfg(assemble, root):
        return assemble(os.path.join(repo, "configs",
                                     "config_vae_humanact12.yaml"),
                        os.path.join(repo, "configs", "assets.yaml"),
                        overrides={"DATASET": {"HUMANACT12": {"ROOT": root}}})
    c, jc = cfg(assemble_config, troot), cfg(jax_assemble, jroot)
    dm, jdm = get_datasets(c, "train")[0], jax_get(jc, "train")[0]
    assert (c.DATASET.NFEATS, c.DATASET.NJOINTS, c.DATASET.NCLASSES) == (
        jc.DATASET.NFEATS, jc.DATASET.NJOINTS, jc.DATASET.NCLASSES) == (
            150, 25, 12)
    assert dm.is_a2m and dm.num_frames == 60
    for b, jb in zip(dm.loader("train", batch_size=8, seed=3),
                     jdm.loader("train", batch_size=8, seed=3)):
        np.testing.assert_allclose(b["motion"], jb["motion"], atol=1e-6)
        for key in ("action", "length", "mask"):
            np.testing.assert_array_equal(b[key], jb[key])
    assert len(dm.dataset("test")) == len(jdm.dataset("test")) > 0


# -- metrics ----------------------------------------------------------------

def test_action_metrics_match_jax():
    """``ActionClassifierMetrics`` and ``a2m_diversity_multimodality`` on
    the same features, logits and seeds give the JAX package's numbers; a
    perfect classifier reads accuracy 1 and FID 0 on identical sets."""
    from ladiff_torch.metrics.a2m import (ActionClassifierMetrics,
                                          a2m_diversity_multimodality)
    from ladiff_tpu.metrics import a2m as ja2m
    rng = np.random.RandomState(16)
    labels = rng.randint(0, 12, 64)
    rec, gt = rng.randn(64, 30), rng.randn(64, 30)
    rec_l, gt_l = rng.randn(64, 12), rng.randn(64, 12)
    got = ActionClassifierMetrics(12, 20, 3, seed=2, gt_diversity_times=20,
                                  gt_multimodality_times=3)
    want = ja2m.ActionClassifierMetrics(12, 20, 3, seed=2,
                                        gt_diversity_times=20,
                                        gt_multimodality_times=3)
    for m in (got, want):
        m.update(labels[:40], rec[:40], rec_l[:40], gt[:40], gt_l[:40],
                 [60] * 40)
        m.update(labels[40:], rec[40:], rec_l[40:], gt[40:], gt_l[40:],
                 [33] * 24)
    same_dict(got.compute(), want.compute())
    same_dict(dict(zip("dm", a2m_diversity_multimodality(
        rec, labels, 12, 30, 4, np.random.RandomState(1)))), dict(zip(
            "dm", ja2m.a2m_diversity_multimodality(
                rec, labels, 12, 30, 4, np.random.RandomState(1)))))
    perfect = ActionClassifierMetrics(12, 20, 3)
    logits = np.eye(12)[labels] * 10.0
    perfect.update(labels, rec, logits, rec, logits, [60] * 64)
    out = perfect.compute()
    assert out["accuracy"] == out["gt_accuracy"] == 1.0
    assert out["FID"] < 1e-6 and out["Diversity"] > 0
