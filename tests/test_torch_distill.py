"""Progressive distillation (the ``distill`` stage) in the PyTorch port
against the JAX package on the CPU: the per-sample DDIM step; the facts
that ``tests/test_distill.py`` pins for the JAX package (the inverted DDIM
jump, two half-steps of a constant epsilon equal one step, the student
alone trains, a grid with an odd ratio is refused); ``distill_forward``'s
loss and the student's gradients against the JAX function on converted
weights, in the LA-VAE and the feature-space (novae) branches, with the
JAX pass's draws handed in; the training loop's stage: the teacher's
load from ``TRAIN.PRETRAINED`` (a checkpoint directory or a ``.ckpt``),
the student's own storage, the JAX package's refusals; and the student's
sampling at guidance 1.

Sizes: latent_dim (7, 32), 3 layers, 4 heads, ff 64, 64 frames, a
student grid of 2 steps (ratio 500).  Tolerances: the DDIM step 1e-6, the
loss 1e-4 norm-wise, each gradient tensor 1e-3, sampling 2e-3.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import flax_state_dict, system_state_dict
from test_torch_entry import _cfg, _logger, _small_overrides, _text_encoder
from test_torch_slice import randomize, relerr

NFEATS, T, D, TEXT, S = 263, 64, 32, 48, 2
TOL, GEN_TOL, GRAD_TOL = 1e-4, 2e-3, 1e-3
LENGTHS = np.array([64, 20, 40], np.int32)


def _kw(vae_type):
    kw = dict(nfeats=NFEATS, njoints=22, max_frames=T, ff_size=64,
              num_layers=3, num_heads=4, text_encoded_dim=TEXT,
              num_inference_timesteps=4, guidance_scale=7.5,
              vae_type=vae_type)
    if vae_type == "no":
        kw.update(latent_dim=(1, D), max_it=0, lad=False, md_trans=False)
    else:
        kw.update(latent_dim=(7, D), frame_per_latent=16)
    return kw


@functools.lru_cache(maxsize=None)
def _systems(vae_type="ladiff"):
    """JAX and port systems on the same randomized weights, and a student
    denoiser's weights of their own (seed 5)."""
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    kw = _kw(vae_type)
    jsys = JaxSystem(dropout=0.0, **kw)
    shapes = jax.eval_shape(jsys.init_params, jax.random.PRNGKey(0))
    params = randomize(shapes, 1)
    student = randomize(shapes["denoiser"], 5)
    tsys = TorchSystem(device="cpu", **kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    return jsys, params, student, tsys


@pytest.fixture(scope="module")
def vae_systems():
    return _systems("ladiff")


def _batch(seed, B=3):
    rng = np.random.RandomState(seed)
    return {"motion": (0.5 * rng.randn(B, T, NFEATS)).astype(np.float32),
            "length": LENGTHS[:B].copy(),
            "text_emb": rng.randn(B, 1, TEXT).astype(np.float32)}


def _torch_batch(batch):
    return {"motion": torch.from_numpy(batch["motion"]),
            "length": torch.from_numpy(batch["length"].astype(np.int64)),
            "text_emb": torch.from_numpy(batch["text_emb"])}


def _np(a):
    return torch.from_numpy(np.array(a))


def _student(tsys, student_params):
    import copy
    den = copy.deepcopy(tsys.denoiser)
    den.load_state_dict(flax_state_dict(student_params), strict=True)
    return den


# -- the per-sample DDIM step and the JAX tests' facts ------------------------

@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_per_sample_ddim_step_matches_jax(eta):
    """[B] timesteps, one per sample, with previous timesteps below 0
    (``final_alpha_cumprod``) among them, eta 0 and 0.5 with the noise
    handed in: within 1e-6 of the JAX step; a host-int step equals the
    tensor step with every sample at that timestep."""
    from ladiff_torch.diffusion.schedulers import make_schedule as tmake
    from ladiff_tpu.diffusion.schedulers import make_schedule as jmake
    rng = np.random.RandomState(1)
    x, eps, noise = (rng.randn(5, 7, D).astype(np.float32) for _ in range(3))
    t = np.array([999, 501, 41, 1, 1], np.int32)
    t_prev = np.array([499, 1, 21, -499, 0], np.int32)
    want = jmake().ddim_step(jnp.asarray(eps), jnp.asarray(t),
                             jnp.asarray(t_prev), jnp.asarray(x), eta=eta,
                             noise=jnp.asarray(noise))
    sched = tmake()
    got = sched.ddim_step(_np(eps), _np(t).long(), _np(t_prev).long(),
                          _np(x), eta=eta, noise=_np(noise))
    assert relerr(got.numpy(), np.asarray(want)) <= 1e-6
    one = sched.ddim_step(_np(eps), 501, 1, _np(x), eta=eta,
                          noise=_np(noise))
    same = sched.ddim_step(_np(eps), torch.full((5,), 501),
                           torch.full((5,), 1), _np(x), eta=eta,
                           noise=_np(noise))
    assert relerr(same.numpy(), one.numpy()) <= 1e-6


def test_ddim_solve_inverts_one_step_and_half_steps_compose():
    """``ddim_solve_eps_x0`` recovers the (x0, eps) of one DDIM jump; two
    half-steps of a constant epsilon land where one step lands, so the
    inverted two-step target recovers that epsilon (the JAX package's
    ``test_ddim_solve_inverts_one_step`` and
    ``test_two_half_steps_equal_one_for_constant_eps``)."""
    from ladiff_torch.diffusion.schedulers import (ddim_solve_eps_x0,
                                                   make_schedule)
    sched = make_schedule()
    rng = np.random.RandomState(2)
    x_t, eps = (_np(rng.randn(4, 7, D).astype(np.float32)) for _ in range(2))
    t = torch.tensor([801, 401, 201, 41])
    x_next = sched.ddim_step(eps, t, t - 40, x_t)
    x0, eps_rec = ddim_solve_eps_x0(sched, x_t, x_next, t, t - 40)
    a_t = sched.table(x_t.device)[t][:, None, None]
    assert torch.allclose(eps_rec, eps, rtol=2e-4, atol=2e-4)
    assert torch.allclose(x0, (x_t - (1 - a_t).sqrt() * eps) / a_t.sqrt(),
                          rtol=2e-4, atol=2e-4)
    one = sched.ddim_step(eps, t, t - 40, x_t)
    two = sched.ddim_step(eps, t - 20, t - 40,
                          sched.ddim_step(eps, t, t - 20, x_t))
    assert torch.allclose(two, one, rtol=1e-5, atol=1e-5)
    _, eps_two = ddim_solve_eps_x0(sched, x_t, two, t, t - 40)
    assert torch.allclose(eps_two, eps, rtol=2e-4, atol=2e-4)


def test_distill_forward_refuses_a_bad_grid(vae_systems):
    from ladiff_torch.training.distill import distill_forward
    _, _, _, tsys = vae_systems
    with pytest.raises(ValueError, match="student_steps"):
        # ratio 1000 // 200 = 5 is odd: no teacher grid of 2S steps
        distill_forward(tsys, tsys.denoiser, tsys.denoiser,
                        _torch_batch(_batch(0, 2)), torch.zeros(1, 1, TEXT),
                        student_steps=200)


# -- distill_forward against the JAX package ----------------------------------

@pytest.mark.parametrize("vae_type", ["ladiff", "no"])
def test_distill_forward_matches_jax(vae_type):
    """Training mode at dropout 0, teacher and student on weights of their
    own, the JAX pass's draws (grid positions, noise, encode noise): the
    loss and its terms within 1e-4, every student gradient within 1e-3,
    no gradient for the teacher or the VAE.  Key 3 puts one sample at the
    grid's last position (t = 1, the teacher's one-step target) and two at
    the first."""
    from ladiff_torch.training.distill import distill_forward
    from ladiff_tpu.training.distill import distill_forward as jax_distill
    jsys, params, student_params, tsys = _systems(vae_type)
    batch = _batch(7)
    B = len(LENGTHS)
    uncond = (0.1 * np.random.RandomState(8).randn(1, 1, TEXT)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(sp):
        return jax_distill(jsys, sp, params["denoiser"], params["vae"], jb,
                           key, jnp.asarray(uncond), S)

    (want, (wlogs, _)), gtree = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(student_params)
    enc, i_k, n_k, _ = jax.random.split(key, 4)
    i = _np(jax.random.randint(i_k, (B,), 0, S)).long()
    assert sorted(i.tolist()) == [0, 0, 1]
    shape = (B, T, NFEATS) if vae_type == "no" else (B, 5, D)
    draws = {"i": i, "noise": _np(jax.random.normal(n_k, shape,
                                                    jnp.float32))}
    if vae_type != "no":
        draws["eps"] = _np(jax.random.normal(enc, (B, 5, D), jnp.float32))
    student = _student(tsys, student_params)
    got, (logs, aux) = distill_forward(tsys, student, tsys.denoiser,
                                       _torch_batch(batch),
                                       torch.from_numpy(uncond), S, **draws)
    assert aux["t"].tolist() == ((S - 1 - i) * 500 + 1).tolist()
    assert relerr(got.detach().numpy(), np.asarray(want)) <= TOL
    for k in ("distill_x0", "raw_x0_mse"):
        assert relerr(logs[k].detach().numpy(), np.asarray(wlogs[k])) <= TOL
    got.backward()
    named = dict(student.named_parameters())
    for name, g in flax_state_dict(gtree).items():
        if named[name].grad is None:
            assert not g.any(), name
        else:
            assert relerr(named[name].grad.numpy(), g.numpy()) <= GRAD_TOL, \
                name
    assert all(p.grad is None for p in tsys.parameters())


def test_distill_steps_train_the_student_only(vae_systems):
    """Six ``distill_train_step``s at grid 25 from a student that starts as
    the teacher (the JAX package's ``test_distill_step_trains_student_
    only``): finite losses, the last below the first, the student moved,
    the teacher and the VAE bit for bit as they were."""
    import copy

    from ladiff_torch.training.trainer import (distill_train_step,
                                               make_optimizer)
    _, _, _, base = vae_systems
    tsys = copy.deepcopy(base)
    teacher = copy.deepcopy(tsys.denoiser).requires_grad_(False)
    before = {k: v.clone() for k, v in tsys.state_dict().items()}
    opt = make_optimizer(tsys.denoiser.parameters(), 1e-3)
    batch = _torch_batch(_batch(9))
    gen = torch.Generator().manual_seed(0)
    i = torch.tensor([3, 10, 17])
    losses = [float(distill_train_step(tsys, teacher, opt, batch,
                                       torch.zeros(1, 1, TEXT), 25, gen,
                                       i=i)["total"]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    after = tsys.state_dict()
    assert any(not torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("denoiser."))
    assert all(torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("vae."))
    tsd = teacher.state_dict()
    assert all(torch.equal(tsd[k[len("denoiser."):]], v)
               for k, v in before.items() if k.startswith("denoiser."))


def test_student_samples_at_guidance_1(vae_systems, monkeypatch):
    """A distilled student samples at guidance 1 over its own steps: one
    denoiser call on B rows a step (no doubled batch), the latents within
    2e-3 of the JAX sampler's from the same initial noise."""
    import dataclasses
    jsys, params, _, tsys = vae_systems
    jsys = dataclasses.replace(jsys, guidance_scale=1.0)
    monkeypatch.setattr(tsys, "guidance_scale", 1.0)
    B = len(LENGTHS)
    text = np.random.RandomState(3).randn(B, 1, TEXT).astype(np.float32)
    key = jax.random.PRNGKey(1)
    want = jax.jit(functools.partial(jsys.diffusion_reverse,
                                     num_inference_timesteps=S))(
        params["denoiser"], jnp.asarray(text), jnp.zeros_like(text),
        jnp.asarray(LENGTHS), key)
    rows = []
    hook = tsys.denoiser.register_forward_pre_hook(
        lambda m, a: rows.append(a[0].shape[0]))
    init = _np(jax.random.normal(jax.random.split(key)[0], (B, 5, D),
                                 jnp.float32))
    try:
        got = tsys.diffusion_reverse(
            torch.from_numpy(text), torch.zeros(B, 1, TEXT),
            torch.from_numpy(LENGTHS.astype(np.int64)),
            num_inference_timesteps=S, init_latents=init)
    finally:
        hook.remove()
    assert rows == [B] * S
    assert relerr(got.numpy(), np.asarray(want)) <= GEN_TOL


# -- the training loop's stage ------------------------------------------------

def _stage2_checkpoint(tmp_path):
    """A stage-2 checkpoint directory of the small configuration (random
    weights, one step)."""
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.training.loop import run_training
    cfg = _cfg("config_ladiff_humanml3d.yaml", **_small_overrides(
        tmp_path, NAME="teacher", TRAIN={"END_EPOCH": 1,
                                         "PRETRAINED_VAE": ""}))
    return run_training(cfg, get_datasets(cfg)[0], _logger(cfg),
                        text_encoder=_text_encoder, max_steps_per_epoch=1,
                        device="cpu")


@pytest.mark.parametrize("source", ["directory", "ckpt"])
def test_run_training_distill(tmp_path, monkeypatch, source):
    """Stage ``distill`` boots the teacher and the VAE from
    ``TRAIN.PRETRAINED`` (the directory's newest file, or a ``.ckpt``
    named directly, read by the reference's names with extra entries
    ignored); the student starts as the teacher and shares no storage with
    it; ``DISTILL_STEPS`` defaults to half the inference steps; the
    checkpoint holds the trained student and the teacher's VAE."""
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.training import loop
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint)
    teacher_dir = _stage2_checkpoint(tmp_path)
    epoch, teacher_sd = load_checkpoint(latest_checkpoint(teacher_dir)[1])
    src = teacher_dir
    if source == "ckpt":
        src = str(tmp_path / "reference.ckpt")
        torch.save({"state_dict": {**teacher_sd, "text_encoder.w":
                                   torch.zeros(2)}, "epoch": 7}, src)
    seen = []
    real = loop.distill_train_step

    def spy(system, teacher, optimizer, batch, uncond, steps, gen):
        seen.append(steps)
        ptrs = {p.data_ptr() for p in teacher.parameters()}
        assert not ptrs & {p.data_ptr() for p in system.parameters()}
        assert not any(p.requires_grad for p in teacher.parameters())
        assert all(torch.equal(v, teacher_sd["denoiser." + k])
                   for k, v in teacher.state_dict().items())
        return real(system, teacher, optimizer, batch, uncond, steps, gen)

    monkeypatch.setattr(loop, "distill_train_step", spy)
    cfg = _cfg("config_ladiff_humanml3d.yaml", **_small_overrides(
        tmp_path, NAME="student", TRAIN={"STAGE": "distill",
                                         "PRETRAINED": src, "END_EPOCH": 1},
        model={"scheduler": {"num_inference_timesteps": 10}}))
    ckpt_dir = loop.run_training(cfg, get_datasets(cfg)[0], _logger(cfg),
                                 text_encoder=_text_encoder,
                                 max_steps_per_epoch=2, device="cpu")
    assert seen == [5, 5]
    _, sd = load_checkpoint(latest_checkpoint(ckpt_dir)[1])
    assert set(sd) == set(teacher_sd)
    assert all(torch.equal(sd[k], v) for k, v in teacher_sd.items()
               if k.startswith("vae."))
    assert any(not torch.equal(sd[k], v) for k, v in teacher_sd.items()
               if k.startswith("denoiser."))


@pytest.mark.parametrize("over,match", [
    ({"TRAIN": {"STAGE": "distill", "PRETRAINED": ""}},
     "needs TRAIN.PRETRAINED"),
    ({"TRAIN": {"STAGE": "distill", "PRETRAINED": "x"},
      "model": {"condition": "action"}}, "text condition only"),
    ({"TRAIN": {"STAGE": "distill", "PRETRAINED": "nowhere"}},
     "no checkpoints")])
def test_run_training_distill_refusals(tmp_path, over, match):
    """The JAX package's refusals: no teacher checkpoint named, the action
    condition; and a teacher directory without a checkpoint."""
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.training.loop import run_training
    cfg = _cfg("config_ladiff_humanml3d.yaml",
               **_small_overrides(tmp_path, **over))
    with pytest.raises((ValueError, FileNotFoundError), match=match):
        run_training(cfg, get_datasets(cfg)[0], _logger(cfg),
                     text_encoder=_text_encoder, device="cpu")
