"""The action family's system and entry points in the PyTorch port against
the JAX package on the CPU: ``from_cfg`` on the three published action
configurations (the 6-layer ActorVae and the 15-layer plain denoiser at
full width, converted JAX params loading strictly), ``generate``,
``vae_forward`` (the SMPL-vertex joints loss) and ``diffusion_forward``
(the class-id condition with the action drop) with every gradient by name,
the evaluation step with the GRU classifier, ``run_test`` at one
replication for HumanAct12 (GRU) and UESTC (ST-GCN) against the root
``test.py``'s, a tiny ``run_training`` of both stages with a resume, and
the distill stage's refusal.  Mirrors ``tests/test_a2m_eval.py`` and
``tests/test_a2m_training.py``.

Sizes: d 64, ActorVae 2 layers, denoiser 3, ff 128, 4 heads, 24 frames
(the data's 60 in the entry points), 150 features, DDIM-3,
``SMPLModel.synthetic(n_verts=32)`` (the entry points: the configuration's
synthetic body).  Every JAX draw is replayed: the posterior noise, the
action drop (the denoiser's ``make_rng("cond_drop")`` key), the noise and
timesteps of stage 2, the sampler's initial noise per batch.  Tolerance
1e-4 relative, norm-wise, on every output and every gradient (float32 on
both sides); the metrics, computed from features that agree to that,
within 1e-3.
"""
import functools
import importlib.util
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import (actor_vae_state_dict, flax_state_dict,
                                  gru_classifier_state_dict,
                                  system_state_dict)
from test_torch_action import cond_drop_key
from test_torch_slice import randomize, relerr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFEATS, T, D, STEPS, TOL = 150, 24, 64, 3, 1e-4
LENGTHS = np.array([24, 13, 1, 20], np.int32)
ACTIONS = np.array([3, 0, 11, 3], np.int32)
SMALL = {"num_layers": 3, "ff_size": 128, "latent_dim": [1, D],
         "motion_vae": {"params": {"num_layers": 2}},
         "denoiser": {"params": {"num_layers": 3}},
         "scheduler": {"num_inference_timesteps": STEPS},
         "guidance_uncondp": 0.5, "droupout": 0.0}


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _systems():
    """JAX and port action systems on the same randomized weights."""
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.smpl.body_model import SMPLModel
    from ladiff_torch.transforms.rotation2xyz import Rotation2xyz
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    from ladiff_tpu.smpl.body_model import SMPLModel as JaxSMPL
    from ladiff_tpu.transforms.rotation2xyz import Rotation2xyz as JaxR2X
    kw = dict(nfeats=NFEATS, njoints=25, max_frames=T, latent_dim=(1, D),
              ff_size=128, num_layers=3, num_heads=4, max_it=0, lad=False,
              num_inference_timesteps=STEPS, guidance_uncondp=0.5,
              vae_type="actor", md_trans=False, condition="action",
              nclasses=12, vae_num_layers=2)
    jsys = JaxSystem(dropout=0.0, mean=jnp.zeros(NFEATS),
                     std=jnp.ones(NFEATS),
                     rot2xyz=JaxR2X(JaxSMPL.synthetic(n_verts=32)), **kw)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), 21)
    tsys = LADiffSystem(device="cpu",
                        rot2xyz=Rotation2xyz(SMPLModel.synthetic(n_verts=32)),
                        **kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    return jsys, params, tsys


@pytest.fixture(scope="module")
def action():
    return _systems()


def _batch(seed):
    rng = np.random.RandomState(seed)
    motion = (0.5 * rng.randn(len(LENGTHS), T, NFEATS)).astype(np.float32)
    mask = np.arange(T)[None] < LENGTHS[:, None]
    return {"motion": motion * mask[:, :, None], "length": LENGTHS,
            "action": ACTIONS[:, None], "mask": mask}


def _torch_batch(batch):
    return {k: _t(v).long() if k in ("length", "action") else _t(v)
            for k, v in batch.items()}


# -- configurations ---------------------------------------------------------

def _cfg(name, assemble=None, **over):
    from ladiff_torch.config import assemble_config
    return (assemble or assemble_config)(
        os.path.join(REPO, "configs", name),
        os.path.join(REPO, "configs", "assets.yaml"), overrides=over or None)


@pytest.mark.parametrize("name,layers,classes", [
    ("config_vae_humanact12.yaml", (6, 15), 12),
    ("config_ladiff_humanact12.yaml", (6, 15), 12),
    ("config_ladiff_uestc.yaml", (9, 9), 40)])
def test_from_cfg_action(name, layers, classes):
    """The published action configurations, unmodified, build the port's
    system at full width as the JAX package's ``from_cfg`` reads them: the
    ActorVae and the plain denoiser at their own depths (stage 1 too: no
    MD-trans denoiser that a stage-2 checkpoint could not fill), the action
    table, the SMPL body; the converted JAX params load strictly."""
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_tpu.config import assemble_config as jax_assemble
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    cfg = _cfg(name, DATASET={"NCLASSES": classes})
    jcfg = _cfg(name, jax_assemble, DATASET={"NCLASSES": classes})
    tsys = LADiffSystem.from_cfg(cfg, nfeats=NFEATS, njoints=25,
                                 device="cpu")
    jsys = JaxSystem.from_cfg(jcfg, nfeats=NFEATS, njoints=25)
    for key in ("latent_dim", "max_it", "guidance_scale", "guidance_uncondp",
                "num_inference_timesteps", "md_trans", "condition",
                "vae_type"):
        assert getattr(tsys, key) == getattr(jsys, key), key
    assert not tsys.md_trans and tsys.n_latents == 1
    assert (len(tsys.vae.encoder.seqTransEncoder.layers),
            len(tsys.denoiser.encoder.ordered_blocks())) == layers == (
                jsys.vae_num_layers, jsys.denoiser_num_layers)
    assert tsys.denoiser.emb_proj.action_embedding.shape == (classes, 256)
    assert tsys.denoiser.time_embedding.linear_1.in_features == 256
    assert tsys.rot2xyz.is_synthetic and jsys.rot2xyz.is_synthetic
    params = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                          jax.eval_shape(jsys.init_params,
                                         jax.random.PRNGKey(0)))
    tsys.load_state_dict(system_state_dict(params), strict=True)


# -- generation, evaluation and the two stages ----------------------------

def _gru(seed=27):
    """The JAX HumanAct12 GRU (hidden 16) on random weights and the port's
    on the converted ones."""
    from ladiff_torch.models.classifiers import MotionDiscriminator
    from ladiff_tpu.models.classifiers import MotionDiscriminator as JaxGRU
    jclf = JaxGRU(input_size=72, hidden_size=16, hidden_layer=2,
                  output_size=12)
    cparams = randomize(jax.eval_shape(
        jclf.init, jax.random.PRNGKey(0), jnp.zeros((1, T, 72)),
        jnp.array([T]))["params"], seed)
    clf = MotionDiscriminator(72, 16, 2, 12).eval()
    clf.load_state_dict(gru_classifier_state_dict(cparams), strict=True)
    return jclf, cparams, clf


def test_generate_and_eval_step_match_jax(action):
    """One HumanAct12 evaluation batch (``a2m_eval_step`` against the JAX
    package's ``make_a2m_eval_step``): ``generate``'s CFG 7.5 DDIM-3 from
    the action tokens (zeros unconditioned) with the JAX initial noise and
    the ActorVae's decode (padded frames zero), the 24 x 3 SMPL joints and
    the GRU classifier on the generated and the ground-truth motions; the
    classifier's outputs on the JAX step's own generated features too."""
    from ladiff_torch.evaluation.a2m_eval import a2m_eval_step, classify
    from ladiff_tpu.evaluation.a2m_eval import make_a2m_eval_step
    jsys, params, tsys = action
    jclf, cparams, clf = _gru()
    batch = _batch(28)
    key = jax.random.PRNGKey(29)
    want = make_a2m_eval_step(jsys, jsys.vae, jclf, cparams)(
        params, jax.tree.map(jnp.asarray, batch), key)
    init = _t(jax.random.normal(jax.random.split(key)[0],
                                (len(LENGTHS), 1, D)))
    cond = tsys.denoiser.embed_action(_t(ACTIONS).long())
    feats, z = tsys.generate(cond, torch.zeros_like(cond),
                             _t(LENGTHS).long(), init_latents=init, nframes=T)
    assert z.shape == (len(LENGTHS), 1, D)
    assert relerr(feats.numpy(), want["feats_rst"]) <= TOL
    assert (feats[1, 13:] == 0).all() and (feats[2, 1:] == 0).all()
    got = a2m_eval_step(tsys, clf, _torch_batch(batch), "gru",
                        init_latents=init)
    for k in want:
        assert relerr(got[k].numpy(), want[k]) <= TOL, k
    with torch.no_grad():
        f, logits = classify(tsys, clf, _t(want["feats_rst"]),
                             _t(LENGTHS).long(), _t(batch["mask"]))
    assert relerr(f.numpy(), want["rec_feats"]) <= TOL
    assert relerr(logits.numpy(), want["rec_logits"]) <= TOL


def _grads_match(tsys, gtree, prefix, to_sd):
    named = dict(tsys.named_parameters())
    want = to_sd(gtree, prefix)
    assert set(want) == {n for n in named if n.startswith(prefix)}
    for name, g in want.items():
        got = named[name].grad
        if got is None:
            assert not g.any(), name
        else:
            assert relerr(got.numpy(), g.numpy()) <= TOL, name
    assert all(p.grad is None for n, p in named.items()
               if not n.startswith(prefix))


def test_vae_forward_matches_jax(action):
    """Stage 1: the reconstruction, the SMPL-vertex joints loss under the
    batch's mask and the KL, with the JAX posterior noise; every ActorVae
    gradient by name, no denoiser gradient."""
    jsys, params, tsys = action
    batch = _batch(23)
    key = jax.random.PRNGKey(24)

    def loss(vp):
        total, (logs, _) = jsys.vae_forward(
            vp, jax.tree.map(jnp.asarray, batch), key, train=True)
        return total, logs

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params["vae"])
    eps = _t(jax.random.normal(jax.random.split(key, 3)[0],
                               (len(LENGTHS), D)))[:, None]
    tsys.zero_grad(set_to_none=True)
    total, (logs, _) = tsys.vae_forward(_torch_batch(batch), train=True,
                                        eps=eps)
    total.backward()
    assert logs["recons_joints"] > 0
    for k, v in want.items():
        assert abs(float(logs[k]) - float(v)) <= TOL * abs(float(v)), k
    _grads_match(tsys, grads, "vae.", actor_vae_state_dict)


def test_diffusion_forward_matches_jax(action):
    """Stage 2: the frozen ActorVae's encode, the noise prediction of the
    class-id condition with ``EmbedAction``'s training drop (no caption
    drop), the JAX draws replayed; every denoiser gradient by name, no VAE
    gradient."""
    jsys, params, tsys = action
    batch = _batch(25)
    key = jax.random.PRNGKey(26)
    B = len(LENGTHS)

    def loss(dp):
        total, (logs, _) = jsys.diffusion_forward(
            dp, params["vae"], jax.tree.map(jnp.asarray, batch), key,
            jnp.zeros((1, 1, 768)), train=True)
        return total, logs

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params["denoiser"])
    enc, t_key, n_key, cfg_key, _ = jax.random.split(key, 5)
    drop = jax.random.bernoulli(cond_drop_key(
        jsys.denoiser, params["denoiser"], cfg_key), 0.5, (B, 1))
    assert drop.any() and not drop.all()
    draws = {"eps": _t(jax.random.normal(enc, (B, D)))[:, None],
             "noise": _t(jax.random.normal(n_key, (B, 1, D))),
             "timesteps": _t(jax.random.randint(t_key, (B,), 0, 1000)),
             "cond_drop": _t(drop).reshape(B, 1, 1)}
    tsys.zero_grad(set_to_none=True)
    total, (logs, aux) = tsys.diffusion_forward(_torch_batch(batch), None,
                                                train=True, **draws)
    total.backward()
    assert aux["latent_valid"].all() and aux["latent_valid"].shape == (B, 1)
    assert abs(float(logs["inst_loss"]) - float(want["inst_loss"])) <= (
        TOL * float(want["inst_loss"]))
    _grads_match(tsys, grads, "denoiser.", flax_state_dict)


@pytest.fixture(scope="module")
def data_roots(tmp_path_factory):
    from ladiff_torch.data.a2m import (generate_synthetic_humanact12,
                                       generate_synthetic_uestc)
    base = tmp_path_factory.mktemp("a2m_entry")
    return {"humanact12": generate_synthetic_humanact12(
                str(base / "humanact12"), n_clips=20, seed=1),
            "uestc": generate_synthetic_uestc(str(base / "uestc"),
                                              n_videos=24, seed=1)}


def _entry_overrides(tmp, data_roots, **over):
    from ladiff_torch.config import merge
    return merge({"DEBUG": False, "FOLDER": str(tmp / "experiments"),
                  "FOLDER_EXP": str(tmp), "NAME": "a2m", "model": SMALL,
                  "DATASET": {"HUMANACT12": {"ROOT": data_roots["humanact12"],
                                             "NUM_FRAMES": T},
                              "UESTC": {"ROOT": data_roots["uestc"],
                                        "NUM_FRAMES": T}},
                  "TRAIN": {"BATCH_SIZE": 8, "END_EPOCH": 1},
                  "TEST": {"BATCH_SIZE": 8, "REPLICATION_TIMES": 1},
                  "LOGGER": {"SACE_CHECKPOINT_EPOCH": 1,
                             "TENSORBOARD": False}}, over).to_dict()


@pytest.mark.parametrize("name,kind", [
    ("config_ladiff_humanact12.yaml", "gru"),
    ("config_ladiff_uestc.yaml", "stgcn")])
def test_run_test_matches_jax(tmp_path, data_roots, monkeypatch, name, kind):
    """``python -m ladiff_torch.test``'s ``run_test`` at one replication
    against the root ``test.py``'s, from the same weights: the classifier
    picked by ``METRIC.TYPE`` from one released-layout checkpoint both
    read, the JAX noise of each padded batch replayed; every metric."""
    import ladiff_torch.evaluation.a2m_eval as a2m_eval
    from ladiff_torch.config import assemble_config
    from ladiff_torch.models.classifiers import STGCN, MotionDiscriminator
    from ladiff_torch.test import run_test
    from ladiff_tpu.config import assemble_config as jax_assemble
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    classes = 12 if kind == "gru" else 40
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(30)
        clf = (MotionDiscriminator(72, 128, 2, classes) if kind == "gru"
               else STGCN(num_class=classes))
    for m in clf.modules():
        if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.running_var.uniform_(0.5, 1.5)
    clf_dir = tmp_path / "deps"
    clf_dir.mkdir()
    if kind == "gru":
        path = str(clf_dir / "humanact12_gru.tar")
        torch.save({"model": clf.state_dict()}, path)
        model = {"humanact12_rec_path": path}
    else:
        torch.save(clf.state_dict(), str(clf_dir / "uestc_rot6d_stgcn.tar"))
        model = {"uestc_rec_path": str(clf_dir)}
    over = _entry_overrides(tmp_path, data_roots, model=model)
    cfg = _cfg(name, assemble_config, **over)
    jcfg = _cfg(name, jax_assemble, **over)
    jsys = JaxSystem.from_cfg(jcfg, nfeats=NFEATS, njoints=25)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), 31)
    logger = logging.getLogger("a2m_run_test")
    spec = importlib.util.spec_from_file_location(
        "root_test", os.path.join(REPO, "test.py"))
    root_test = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_test)
    want = root_test.run_test(jcfg, logger, params=params)

    rng = {"key": jax.random.PRNGKey(0)}

    def noise(n):
        rng["key"], step = jax.random.split(rng["key"])
        return _t(jax.random.normal(jax.random.split(step)[0], (n, 1, D)))

    monkeypatch.setattr(a2m_eval, "run_a2m_eval", functools.partial(
        a2m_eval.run_a2m_eval, noise=noise))
    got = run_test(cfg, logger, state_dict=system_state_dict(params),
                   device="cpu")
    assert sorted(got) == sorted(want) and "accuracy" in got
    for k, (mean, conf) in want.items():
        assert conf == got[k][1] == 0.0
        assert abs(got[k][0] - mean) <= 1e-3 * max(abs(mean), 1e-3), k


# -- training -----------------------------------------------------------------

def test_run_training_both_stages_with_resume(tmp_path, data_roots):
    """``python -m ladiff_torch.train`` on the action configurations: stage
    1 (the ActorVae) for an epoch, a resume that runs the second from the
    checkpoint, stage 2 booting the VAE from stage 1's checkpoints and
    training the denoiser alone on the class ids."""
    from ladiff_torch import train
    from ladiff_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
    over = _entry_overrides(tmp_path, data_roots)
    vae_dir = train.main(["--cfg", os.path.join(REPO, "configs",
                                                "config_vae_humanact12.yaml"),
                          "--cpu"], overrides=over, max_steps_per_epoch=2)
    ep1, sd1 = load_checkpoint(latest_checkpoint(vae_dir)[1])
    assert ep1 == 1 and sd1 and all(k.startswith("vae.") for k in sd1)
    resumed = train.main(
        ["--cfg", os.path.join(REPO, "configs", "config_vae_humanact12.yaml"),
         "--cpu"], overrides={**over, "TRAIN": {
             **over["TRAIN"], "END_EPOCH": 2,
             "RESUME": os.path.dirname(vae_dir)}},
        max_steps_per_epoch=2)
    ep2, sd2 = load_checkpoint(latest_checkpoint(resumed)[1])
    assert ep2 == 2 and any(not torch.equal(sd2[k], v) for k, v in sd1.items())
    diff_dir = train.main(
        ["--cfg", os.path.join(REPO, "configs",
                               "config_ladiff_humanact12.yaml"), "--cpu"],
        overrides={**over, "NAME": "a2m_diffusion", "TRAIN": {
            **over["TRAIN"], "PRETRAINED_VAE": resumed}},
        max_steps_per_epoch=2)
    _, sd = load_checkpoint(latest_checkpoint(diff_dir)[1])
    assert all(torch.equal(sd[k], v) for k, v in sd2.items())
    assert "denoiser.emb_proj.action_embedding" in sd


def test_distill_refuses_the_action_condition(tmp_path, data_roots):
    """Stage distill folds text guidance into the student: an action
    configuration is refused before any restore, with the JAX package's
    message (``ladiff_tpu/training/loop.py``'s guard)."""
    from ladiff_torch.config import assemble_config
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.training.loop import run_training
    over = _entry_overrides(tmp_path, data_roots, TRAIN={
        "STAGE": "distill", "PRETRAINED": "/nonexistent"})
    cfg = _cfg("config_ladiff_humanact12.yaml", assemble_config, **over)
    with pytest.raises(ValueError, match="supports the text condition only"):
        run_training(cfg, get_datasets(cfg, "train")[0],
                     logging.getLogger("a2m_distill"), max_steps_per_epoch=1,
                     max_epochs=1, device="cpu")
