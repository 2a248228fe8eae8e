"""The plain skip-transformer denoiser and feature-space diffusion (the
novae family) in the PyTorch port against the JAX package on the CPU, on
converted weights: the plain denoiser in its latent and feature wirings
with learned and sine positional embeddings; ``generate`` of a novae system
and of a plain latent denoiser with the LA-VAE under DDPM, the JAX
sampler's draws replayed through ``torch.randn``; ``diffusion_forward``'s loss and gradients;
``eval_step`` against ``make_eval_step``; the unmodified
``configs/config_novae_humanml3d.yaml`` through ``from_cfg``; and the
training, resume and evaluation entry points at a small size.

Sizes: d 64, 3 layers, 64 frames, 3 sampler steps.  Tolerances: the
denoiser, the stage-2 loss and ``eval_step`` 1e-4 norm-wise (float32 on
both sides, sums in another order), gradients 1e-3, ``generate`` 2e-3
(see ``tests/test_torch_slice.py``: guided steps amplify the rounding),
the joints of ``eval_step``'s generated motion 5e-4.
"""
import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import flax_state_dict, system_state_dict
from test_torch_slice import randomize, relerr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFEATS, T, D, STEPS, TEXT = 263, 64, 64, 3, 48
LENGTHS = np.array([64, 40, 17], np.int32)
TOL, GEN_TOL, GRAD_TOL = 1e-4, 2e-3, 1e-3
# eval_step's joints of generated frames: 1.4e-4 measured on the CPU
JOINTS_TOL = 5e-4


def _kw(vae_type):
    """The two plain-wiring systems' shared arguments: feature-space
    diffusion (no VAE) or latent diffusion with the LA-VAE, DDPM over the
    1000-step grid."""
    kw = dict(nfeats=NFEATS, njoints=22, max_frames=T, ff_size=128,
              num_layers=3, num_heads=4, text_encoded_dim=TEXT,
              num_inference_timesteps=STEPS, scheduler_kind="ddpm",
              vae_type=vae_type, md_trans=False)
    if vae_type == "no":
        kw.update(latent_dim=(1, D), max_it=0, lad=False)
    else:
        kw.update(latent_dim=(7, D), max_it=2, frame_per_latent=48)
    return kw


@functools.lru_cache(maxsize=None)
def _systems(vae_type):
    """JAX and port systems of one kind on the same randomized weights."""
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    kw = _kw(vae_type)
    mean = (0.1 * np.random.RandomState(3).randn(NFEATS)).astype(np.float32)
    std = (0.5 + np.random.RandomState(4).rand(NFEATS)).astype(np.float32)
    jsys = JaxSystem(dropout=0.0, mean=jnp.asarray(mean),
                     std=jnp.asarray(std), **kw)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), 1)
    tsys = TorchSystem(mean=mean, std=std, device="cpu", **kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    return vae_type, jsys, params, tsys


@pytest.fixture(scope="module", params=["no", "ladiff"])
def systems(request):
    return _systems(request.param)


@pytest.fixture(scope="module")
def novae():
    return _systems("no")


def _texts(B, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, TEXT).astype(np.float32),
            (0.1 * rng.randn(B, 1, TEXT)).astype(np.float32))


def _jax_draws(key, shape):
    """The JAX sampler's draws in its split order: the initial noise, then
    each DDPM step's."""
    init_key, noise_key = jax.random.split(key)
    steps = []
    for _ in range(STEPS):
        noise_key, step_key = jax.random.split(noise_key)
        steps.append(np.asarray(jax.random.normal(step_key, shape,
                                                  jnp.float32)))
    init = np.asarray(jax.random.normal(init_key, shape, jnp.float32))
    return torch.from_numpy(init), torch.from_numpy(np.stack(steps))


# -- the plain denoiser ----------------------------------------------------

@pytest.mark.parametrize("wiring", ["latent", "feature"])
@pytest.mark.parametrize("pe", ["learned", "sine"])
def test_plain_denoiser_matches_jax(wiring, pe):
    """``md_trans=False``: tokens [latents; time; text] (first rows kept)
    or, ``diffusion_only``, [time; text; frames] through pose_embd /
    pose_proj with the padded frames zeroed; no key mask either way."""
    from ladiff_torch.models.denoiser import LADenoiser as TorchDenoiser
    from ladiff_tpu.models.denoiser import LADenoiser as JaxDenoiser
    feature = wiring == "feature"
    kw = dict(nfeats=NFEATS, latent_dim=(7, D), ff_size=128, num_layers=3,
              num_heads=4, text_encoded_dim=TEXT, md_trans=False,
              diffusion_only=feature, position_embedding=pe)
    B = 3
    rng = np.random.RandomState(5)
    x = rng.randn(B, T if feature else 7, NFEATS if feature else D)
    x = x.astype(np.float32)
    t = np.array([3, 500, 999])
    text = rng.randn(B, 1, TEXT).astype(np.float32)
    fv = np.arange(T)[None] < LENGTHS[:, None]
    jden = JaxDenoiser(dropout=0.0, **kw)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(text), None)
    jkw = {"frame_valid": jnp.asarray(fv)} if feature else {}
    params = randomize(jden.init(jax.random.PRNGKey(0), *args,
                                 **jkw)["params"], 2)
    want = np.asarray(jden.apply({"params": params}, *args, **jkw))
    tden = TorchDenoiser(**kw)
    sd = flax_state_dict(params)
    assert set(sd) == set(tden.state_dict())
    assert ("query_pos.pe" in sd) == (pe == "learned")
    assert ("pose_embd.weight" in sd) == feature
    assert "encoder.input_blocks.0.self_attn.in_proj_weight" in sd
    tden.load_state_dict(sd, strict=True)
    got = tden(torch.from_numpy(x), torch.from_numpy(t),
               torch.from_numpy(text),
               frame_valid=torch.from_numpy(fv) if feature else None)
    assert got.shape == want.shape
    assert relerr(got.detach().numpy(), want) <= TOL
    if feature:
        assert not got[2, LENGTHS[2]:].any()
    with pytest.raises(AssertionError):
        tden.precompute_md_stack()


# -- generation, the stage-2 pass, the evaluation step ---------------------

def test_generate_matches_jax(systems, monkeypatch):
    """CFG 7.5 DDPM-3 on the 1000-step grid, lengths {64, 40, 17}; the
    JAX draws replayed.  Feature-space: (z, z) of [B, T, nfeats] with the
    padded frames zero; latent: the plain denoiser's latents decoded."""
    kind, jsys, params, tsys = systems
    B = len(LENGTHS)
    cond, uncond = _texts(B, 6)
    key = jax.random.PRNGKey(7)
    feats_j, z_j = jsys.generate(params, jnp.asarray(cond),
                                 jnp.asarray(uncond), jnp.asarray(LENGTHS),
                                 key, nframes=T)
    init, steps = _jax_draws(key, z_j.shape)
    draws = list(steps)  # the sampler's per-step draws, in order
    monkeypatch.setattr(torch, "randn", lambda *a, **k: draws.pop(0))
    feats_t, z_t = tsys.generate(
        torch.from_numpy(cond), torch.from_numpy(uncond),
        torch.from_numpy(LENGTHS.astype(np.int64)), nframes=T,
        init_latents=init)
    monkeypatch.undo()
    assert draws == []
    assert z_t.shape == z_j.shape and feats_t.shape == (B, T, NFEATS)
    assert relerr(z_t.numpy(), z_j) <= GEN_TOL
    assert relerr(feats_t.float().numpy(), feats_j) <= GEN_TOL
    assert not feats_t[2, LENGTHS[2]:].any()
    if kind == "no":
        assert feats_t is z_t


def _batch(B, seed):
    rng = np.random.RandomState(seed)
    return {"motion": (0.5 * rng.randn(B, T, NFEATS)).astype(np.float32),
            "length": LENGTHS[:B].copy(),
            "text_emb": rng.randn(B, 1, TEXT).astype(np.float32)}


def test_diffusion_forward_matches_jax(novae):
    """Feature-space diffusion in training mode at dropout 0 with the JAX
    pass's draws (noise, timesteps, caption drop): the loss within 1e-4
    and every denoiser gradient within 1e-3."""
    _, jsys, params, tsys = novae
    B = len(LENGTHS)
    batch = _batch(B, 8)
    uncond = np.zeros((1, 1, TEXT), np.float32)
    key = jax.random.PRNGKey(9)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(den):
        return jsys.diffusion_forward(den, params["vae"], jb, key,
                                      jnp.asarray(uncond))

    (want, (jlogs, _)), jgrads = jax.value_and_grad(loss, has_aux=True)(
        params["denoiser"])
    _, t_k, n_k, cfg_k, _ = jax.random.split(key, 5)
    draws = {"noise": jax.random.normal(n_k, (B, T, NFEATS), jnp.float32),
             "timesteps": jax.random.randint(t_k, (B,), 0, 1000),
             "cond_drop": jax.random.bernoulli(cfg_k, 0.1, (B, 1, 1))}
    tsys.zero_grad(set_to_none=True)
    total, (logs, aux) = tsys.diffusion_forward(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(uncond), train=True,
        **{k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()})
    total.backward()
    assert abs(float(total.detach()) - float(want)) <= TOL * abs(float(want))
    assert aux["latent_valid"] is None
    grads = flax_state_dict(jax.device_get(jgrads), "denoiser.")
    named = dict(tsys.named_parameters())
    assert set(grads) == set(named)
    for name, g in grads.items():
        assert relerr(named[name].grad.numpy(), g.numpy()) <= GRAD_TOL, name


def test_eval_step_matches_jax(novae, tmp_path, monkeypatch):
    """``eval_step`` stage diffusion against ``make_eval_step`` with the
    same evaluators (one ``finest.tar``) and the JAX draws: the sampled
    frames are the features, padded frames zero, no decode; stage vae
    raises by name."""
    from ladiff_torch.evaluation.t2m_eval import T2MEvaluator, eval_step
    from ladiff_tpu.evaluation.t2m_eval import T2MEvaluator as JaxEvaluator
    from ladiff_tpu.evaluation.t2m_eval import make_eval_step
    _, jsys, params, tsys = novae
    B = len(LENGTHS)
    ev = T2MEvaluator.random_init(NFEATS, torch.Generator().manual_seed(5),
                                  "cpu")
    path = str(tmp_path / "finest.tar")
    torch.save({"text_encoder": ev.text.state_dict(),
                "movement_encoder": ev.movement.state_dict(),
                "motion_encoder": ev.motion.state_dict()}, path)
    rng = np.random.RandomState(10)
    mean_eval = (0.1 * rng.randn(NFEATS)).astype(np.float32)
    std_eval = (0.8 + 0.4 * rng.rand(NFEATS)).astype(np.float32)
    batch = {"motion": _batch(B, 11)["motion"], "length": LENGTHS.copy(),
             "word_embs": rng.randn(B, 5, 300).astype(np.float32),
             "pos_ohot": rng.rand(B, 5, 15).astype(np.float32),
             "text_len": np.array([5, 3, 4])}
    cond, uncond = _texts(B, 12)
    key = jax.random.PRNGKey(13)
    step = make_eval_step(jsys, JaxEvaluator.from_checkpoint(path, NFEATS),
                          mean_eval, std_eval, stage="diffusion")
    want = jax.device_get(step(params, {k: jnp.asarray(v) for k, v in
                                        batch.items()},
                               jnp.asarray(cond), jnp.asarray(uncond), key))
    init, steps = _jax_draws(key, want["z"].shape)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["length"] = tb["length"].long()
    tev = T2MEvaluator.from_checkpoint(path, NFEATS, "cpu")
    draws = list(steps)  # the sampler's per-step draws, in order
    monkeypatch.setattr(torch, "randn", lambda *a, **k: draws.pop(0))
    got = eval_step(tsys, tev, tb, torch.from_numpy(cond), torch.from_numpy(uncond),
                    mean_eval=mean_eval, std_eval=std_eval,
                    init_latents=init)
    monkeypatch.undo()
    assert draws == []
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        # the generated motion's joints integrate its root rotation
        # velocity over the frames (``recover_from_ric``), which at random
        # weights amplifies the sampler's ~3e-6 about fifty-fold (1.4e-4)
        tol = JOINTS_TOL if k == "joints_rst" else TOL
        assert relerr(got[k].numpy(), want[k]) <= tol, k
    assert not got["z"][2, LENGTHS[2]:].any()
    with pytest.raises(NotImplementedError, match="no VAE"):
        eval_step(tsys, None, tb, None, None, "vae", mean_eval=mean_eval,
                  std_eval=std_eval)


# -- the published configuration and the entry points ----------------------

def _cfg(name, over=None):
    from ladiff_torch.config import assemble_config
    return assemble_config(os.path.join(REPO, "configs", name),
                           os.path.join(REPO, "configs", "assets.yaml"),
                           overrides=over)


def test_from_cfg_builds_the_novae_configuration():
    """``configs/config_novae_humanml3d.yaml`` unmodified: d 512, 9 plain
    layers, DDPM over 1000 steps, no ``vae`` submodule and no ``vae.*``
    key; the JAX package's parameters of the same configuration load
    through ``system_state_dict`` with ``strict=True``; the stages that
    need a VAE raise by name; the MD-only options refuse the plain
    wiring; the LA-VAE without ``LAD`` builds and encodes as the JAX
    package's."""
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    cfg = _cfg("config_novae_humanml3d.yaml")
    tsys = TorchSystem.from_cfg(cfg, nfeats=NFEATS, njoints=22, device="cpu")
    assert tsys.vae is None and tsys.vae_type == "no"
    assert not tsys.md_trans and not tsys.denoiser.md_trans
    assert tsys.denoiser.diffusion_only and tsys.latent_dim == (1, 512)
    assert (tsys.scheduler_kind, tsys.num_inference_timesteps) == ("ddpm",
                                                                   1000)
    sd = tsys.state_dict()
    assert not any(k.startswith("vae.") for k in sd)
    jsys = JaxSystem.from_cfg(cfg, nfeats=NFEATS, njoints=22)
    shapes = jax.eval_shape(jsys.init_params, jax.random.PRNGKey(0))
    assert shapes["vae"] == {}
    got = system_state_dict(randomize(shapes, 3))
    assert set(got) == set(sd)
    tsys.load_state_dict(got, strict=True)
    with pytest.raises(NotImplementedError, match="needs a VAE"):
        tsys.vae_forward({"motion": torch.zeros(1, T, NFEATS),
                          "length": torch.tensor([T])})
    with pytest.raises(ValueError, match="md_stack.*md_trans=False"):
        TorchSystem(md_stack=True, device="cpu", **_kw("ladiff"))
    # the LA-VAE without LAD under the plain wiring builds and encodes as
    # the JAX package's: every latent row valid, z not zeroed
    kw = {**_kw("ladiff"), "lad": False}
    jfix = JaxSystem(dropout=0.0, **kw)
    params = randomize(jax.eval_shape(jfix.init_params,
                                      jax.random.PRNGKey(0)), 5)
    fixed = TorchSystem(device="cpu", **kw)
    fixed.load_state_dict(system_state_dict(params), strict=True)
    feats = np.random.RandomState(6).randn(3, T, NFEATS).astype(np.float32)
    want = jfix.vae.apply({"params": params["vae"]}, jnp.asarray(feats),
                          jnp.asarray(LENGTHS), sample_mean=True,
                          method=jfix.vae.encode)
    got = fixed.vae.encode(torch.from_numpy(feats),
                           torch.from_numpy(LENGTHS).long(), sample_mean=True)
    assert bool(got[3].all()) and bool(got[0].abs().amin(2).gt(0).all())
    for g, w in zip(got[:3], want[:3]):
        assert relerr(g.detach().numpy(), np.asarray(w)) <= TOL
    with pytest.raises(ValueError, match="ladiff, actor or no"):
        TorchSystem.from_cfg(_cfg("config_novae_humanml3d.yaml", {
            "TRAIN": {"ABLATION": {"VAE_TYPE": "vq"}}}),
            nfeats=NFEATS, njoints=22, device="cpu")


def test_novae_training_resume_and_evaluation(tmp_path, caplog):
    """The novae configuration cut to 3 layers and d 64 on synthetic data:
    two ``run_training`` steps write a checkpoint without ``vae.*`` that
    loads strictly; a resume starts at its epoch; ``python -m
    ladiff_torch.test``'s ``main`` restores it and runs one replication;
    stages vae and vae_diffusion raise by name."""
    from ladiff_torch import test as entry
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.training.loop import run_training
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint)
    from test_torch_entry import _logger, _small_overrides, _text_encoder
    name = "config_novae_humanml3d.yaml"
    layers = {"params": {"num_layers": 3}}

    def cfg(**train):
        return _cfg(name, _small_overrides(
            tmp_path, NAME="novae", TRAIN={"END_EPOCH": 1, **train},
            model={"latent_dim": [1, 64], "motion_vae": layers,
                   "denoiser": layers,
                   "scheduler": {"num_inference_timesteps": 2}},
            TEST={"REPLICATION_TIMES": 1, "MM_NUM_SAMPLES": 2,
                  "MM_NUM_REPEATS": 2, "MM_NUM_TIMES": 1},
            LOGGER={"SACE_CHECKPOINT_EPOCH": 1}))

    c = cfg()
    dm = get_datasets(c)[0]
    ckpt = run_training(c, dm, _logger(c), text_encoder=_text_encoder,
                        max_steps_per_epoch=2, device="cpu")
    epoch, sd = load_checkpoint(latest_checkpoint(ckpt)[1])
    assert epoch == 1 and sd and all(k.startswith("denoiser.") for k in sd)
    LADiffSystem.from_cfg(c, nfeats=NFEATS, njoints=22,
                          device="cpu").load_state_dict(sd, strict=True)
    c2 = cfg(RESUME="yes", END_EPOCH=2)
    logger = _logger(c2)
    logger.setLevel(logging.INFO)
    logger.addHandler(caplog.handler)
    run_training(c2, dm, logger, text_encoder=_text_encoder,
                 max_steps_per_epoch=1, device="cpu")
    assert "resumed from epoch 1" in caplog.text
    assert latest_checkpoint(ckpt)[0] == 2
    for stage in ("vae", "vae_diffusion"):
        bad = cfg(STAGE=stage)
        with pytest.raises(NotImplementedError, match="no VAE"):
            run_training(bad, dm, _logger(bad), device="cpu")
    over = _small_overrides(
        tmp_path, NAME="novae_test", TEST={
            "CHECKPOINTS": ckpt, "REPLICATION_TIMES": 1, "MM_NUM_SAMPLES": 2,
            "MM_NUM_REPEATS": 2, "MM_NUM_TIMES": 1},
        model={"latent_dim": [1, 64], "motion_vae": layers,
               "denoiser": layers,
               "scheduler": {"num_inference_timesteps": 2}})
    summary = entry.main(["--cfg", os.path.join(REPO, "configs", name),
                          "--cpu", "--replication", "1"],
                         text_encoder=_text_encoder, overrides=over)
    assert {"APE_root", "AVE_root", "MultiModality"} <= set(summary)
    assert all(np.isfinite(m) for m, _ in summary.values())
