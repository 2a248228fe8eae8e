"""Autoregressive latent diffusion (the ARDIFF family) in the PyTorch port
against the JAX package on the CPU, on converted weights: the denoiser's
``enclat`` conditioning in both wirings; ``diffusion_reverse_ar`` with
"last" and "full" conditioning (MD wiring) and "last" (plain wiring), each
token's start noise of the JAX sampler replayed through a patched
``torch.randn``; ``generate``'s AR branch; ``diffusion_forward_ar``'s loss
and gradients with the JAX pass's draws handed in; ``from_cfg`` with
``ARDIFF: true``; a tiny ``run_training`` stage diffusion and
``demo.main`` with ``ARDIFF``.

Sizes: latent_dim (7, 32), 3 layers, 4 heads, ff 64, 196 frames, MAX_IT 5,
3 DDIM steps.  Tolerances: the denoiser and the loss 1e-4 norm-wise
(float32 on both sides, sums in another order), each gradient tensor
1e-3, sampling and ``generate`` 2e-3 (guided steps amplify the rounding,
as in ``tests/test_torch_slice.py``).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import flax_state_dict, system_state_dict
from test_torch_entry import _cfg, _logger, _small_overrides, _text_encoder
from test_torch_slice import randomize, relerr

NFEATS, T, D, M, STEPS, TEXT = 263, 196, 32, 5, 3, 48
TOL, GEN_TOL, GRAD_TOL = 1e-4, 2e-3, 1e-3
LENGTHS = np.array([196, 60, 48], np.int32)   # 5, 2 and 1 active tokens
SHORT = np.array([150, 60, 48], np.int32)     # 4 tokens sampled, not 5


@functools.lru_cache(maxsize=None)
def _systems(md_trans=True):
    """JAX and port AR systems ("last") on the same randomized weights."""
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    kw = dict(nfeats=NFEATS, njoints=22, max_frames=T, latent_dim=(7, D),
              ff_size=64, num_layers=3, num_heads=4, text_encoded_dim=TEXT,
              num_inference_timesteps=STEPS, guidance_uncondp=0.4,
              ardiff=True, md_trans=md_trans)
    mean = (0.1 * np.random.RandomState(3).randn(NFEATS)).astype(np.float32)
    std = (0.5 + np.random.RandomState(4).rand(NFEATS)).astype(np.float32)
    jsys = JaxSystem(dropout=0.0, mean=jnp.asarray(mean),
                     std=jnp.asarray(std), **kw)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), 1)
    tsys = TorchSystem(mean=mean, std=std, device="cpu", **kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    return jsys, params, tsys


@pytest.fixture(scope="module")
def md():
    return _systems(True)


def _texts(B, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, TEXT).astype(np.float32),
            (0.1 * rng.randn(B, 1, TEXT)).astype(np.float32))


def _token_draws(key, B):
    """Each token's start noise [B, 1, D] in the JAX sampler's split
    order."""
    draws = []
    for _ in range(M):
        key, init_key = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(
            jax.random.normal(init_key, (B, 1, D), jnp.float32))))
    return draws


def _replayed(monkeypatch, draws, fn):
    """``fn()`` with ``torch.randn`` handing out ``draws`` in order;
    returns its result and how many draws it took."""
    left = list(draws)
    monkeypatch.setattr(torch, "randn", lambda *a, **k: left.pop(0))
    try:
        return fn(), len(draws) - len(left)
    finally:
        monkeypatch.undo()


# -- the denoiser's enclat conditioning ---------------------------------------

@pytest.mark.parametrize("md_trans", [True, False])
@pytest.mark.parametrize("masks", ["enclat_valid", "both", "none"])
def test_enclat_denoiser_matches_jax(md_trans, masks):
    """``[sample; enclat]`` with the row mask ``[latent_valid or ones;
    enclat_valid or ones]`` (MD) or the key mask over ``[stream; time;
    text]`` where both masks exist (plain); the sample's rows come out.  A
    masked enclat row's content does not reach the output."""
    from ladiff_torch.models.denoiser import LADenoiser as TorchDenoiser
    from ladiff_tpu.models.denoiser import LADenoiser as JaxDenoiser
    kw = dict(nfeats=NFEATS, latent_dim=(7, D), ff_size=64, num_layers=3,
              num_heads=4, text_encoded_dim=TEXT, md_trans=md_trans)
    B, n_lat, n_cond = 3, 2, 4
    rng = np.random.RandomState(11)
    x = rng.randn(B, n_lat, D).astype(np.float32)
    enclat = rng.randn(B, n_cond, D).astype(np.float32)
    ts = np.array([3, 500, 999])
    text = rng.randn(B, 1, TEXT).astype(np.float32)
    ev = np.arange(n_cond)[None] < np.array([[0], [2], [4]])
    lv = np.arange(n_lat)[None] < np.array([[2], [1], [2]])
    ev_in = None if masks == "none" else ev
    lv_in = lv if masks == "both" else None
    jden = JaxDenoiser(dropout=0.0, **kw)
    jargs = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(text),
             None if lv_in is None else jnp.asarray(lv_in))
    jkw = {"enclat": jnp.asarray(enclat),
           "enclat_valid": None if ev_in is None else jnp.asarray(ev_in)}
    params = randomize(jax.eval_shape(
        lambda: jden.init(jax.random.PRNGKey(0), *jargs, **jkw))["params"],
        2)
    want = np.asarray(jden.apply({"params": params}, *jargs, **jkw))
    tden = TorchDenoiser(**kw)
    tden.load_state_dict(flax_state_dict(params), strict=True)
    tv = lambda a: None if a is None else torch.from_numpy(a)

    def run(enc):
        return tden(torch.from_numpy(x), torch.from_numpy(ts),
                    torch.from_numpy(text), tv(lv_in),
                    enclat=torch.from_numpy(enc),
                    enclat_valid=tv(ev_in)).detach()

    got = run(enclat)
    assert got.shape == (B, n_lat, D)
    assert relerr(got.numpy(), want) <= TOL
    if masks != "none" and (md_trans or masks == "both"):
        moved = enclat + 5.0 * ~ev[:, :, None]
        assert torch.allclose(run(moved.astype(np.float32)), got,
                              rtol=1e-5, atol=1e-5)


# -- sampling -----------------------------------------------------------------

@pytest.mark.parametrize("mode,md_trans,lengths", [
    ("last", True, SHORT), ("full", True, LENGTHS), ("last", False, LENGTHS)],
    ids=["last-md", "full-md", "last-plain"])
def test_reverse_ar_matches_jax(mode, md_trans, lengths, monkeypatch):
    """CFG 7.5 DDIM-3 token by token with each token's noise replayed: the
    port samples ceil(max(lengths) / 48) tokens (4 for {150, 60, 48}), the
    JAX scan all 5; the rows past each sample's count are zero on both."""
    jsys, params, tsys = _systems(md_trans)
    jsys = dataclasses.replace(jsys, motion_conditioning=mode)
    monkeypatch.setattr(tsys, "motion_conditioning", mode)
    B = len(lengths)
    cond, uncond = _texts(B, 6)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(jsys.diffusion_reverse_ar)(
        params["denoiser"], jnp.asarray(cond), jnp.asarray(uncond),
        jnp.asarray(lengths), key))
    got, used = _replayed(monkeypatch, _token_draws(key, B), lambda: (
        tsys.diffusion_reverse_ar(torch.from_numpy(cond),
                                  torch.from_numpy(uncond),
                                  torch.from_numpy(lengths.astype(np.int64)))))
    assert used == -(-int(lengths.max()) // 48)
    assert got.shape == want.shape == (B, M, D)
    assert relerr(got.numpy(), want) <= GEN_TOL
    active = -(-lengths // 48)
    for b, n in enumerate(active):
        assert not got[b, n:].any() and got[b, :n].abs().min() > 0


def test_generate_ar_matches_jax(md, monkeypatch):
    """``generate`` takes the AR sampler and decodes: features and latents
    against the JAX package's; the same generator gives the same motion;
    ``init_latents`` rows are the tokens' initial noise (the same draws
    handed in give the same latents)."""
    jsys, params, tsys = md
    B = len(LENGTHS)
    cond, uncond = _texts(B, 8)
    key = jax.random.PRNGKey(9)
    feats_j, z_j = jax.jit(functools.partial(jsys.generate, nframes=T))(
        params, jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(LENGTHS),
        key)
    args = (torch.from_numpy(cond), torch.from_numpy(uncond),
            torch.from_numpy(LENGTHS.astype(np.int64)))
    draws = _token_draws(key, B)
    (feats_t, z_t), used = _replayed(
        monkeypatch, draws, lambda: tsys.generate(*args, nframes=T))
    assert used == M
    assert relerr(z_t.numpy(), z_j) <= GEN_TOL
    assert relerr(feats_t.numpy(), feats_j) <= GEN_TOL
    assert feats_t.shape == (B, T, NFEATS) and not feats_t[1, 60:].any()
    run = lambda: tsys.generate(*args, generator=torch.Generator()
                                .manual_seed(3))[1]
    assert torch.equal(run(), run())
    assert torch.equal(tsys.generate(
        *args, nframes=T, init_latents=torch.cat(draws, 1))[1], z_t)


def test_eval_step_ar(md):
    """The evaluation step needs nothing of its own for an AR system: it
    samples through ``generate``, the batch's noise rows each token's
    initial noise."""
    from ladiff_torch.evaluation.t2m_eval import T2MEvaluator, eval_step
    _, _, tsys = md
    B = len(LENGTHS)
    rng = np.random.RandomState(14)
    cond, uncond = _texts(B, 15)
    batch = {"motion": torch.from_numpy(rng.randn(B, T, NFEATS).astype(
                 np.float32)),
             "length": torch.from_numpy(LENGTHS.astype(np.int64)),
             "word_embs": torch.from_numpy(rng.randn(B, 6, 300).astype(
                 np.float32)),
             "pos_ohot": torch.zeros(B, 6, 15), "text_len": torch.tensor(
                 [6, 4, 5])}
    noise = torch.from_numpy(rng.randn(B, M, D).astype(np.float32))
    ev = T2MEvaluator.random_init(NFEATS, torch.Generator().manual_seed(1),
                                  "cpu")
    out = eval_step(tsys, ev, batch, torch.from_numpy(cond),
                    torch.from_numpy(uncond), "diffusion",
                    mean_eval=np.zeros(NFEATS, np.float32),
                    std_eval=np.ones(NFEATS, np.float32), init_latents=noise)
    _, z = tsys.generate(torch.from_numpy(cond), torch.from_numpy(uncond),
                         batch["length"], nframes=T, init_latents=noise)
    assert torch.equal(out["z"], z)
    assert out["lat_rm"].shape == out["lat_m"].shape == (B, 512)


# -- training -----------------------------------------------------------------

def _ar_draws(key, B, n_active):
    """What ``diffusion_forward_ar`` of the JAX package draws from
    ``key``, as the port's optional tensors."""
    enc, t_k, n_k, cfg_k, _, idx_k, coin_k = jax.random.split(key, 7)
    u = np.asarray(jax.random.uniform(idx_k, (B,)))
    idx = 1 + np.floor(u * np.maximum(n_active - 1, 1)).astype(np.int64)
    idx = np.minimum(idx, np.maximum(n_active - 1, 0))
    np_ = lambda a: torch.from_numpy(np.array(a))
    return {"eps": np_(jax.random.normal(enc, (B, M, D), jnp.float32)),
            "noise": np_(jax.random.normal(n_k, (B, 1, D), jnp.float32)),
            "timesteps": np_(jax.random.randint(t_k, (B,), 0, 1000)).long(),
            "cond_drop": np_(jax.random.bernoulli(cfg_k, 0.4, (B, 1, 1))),
            "latent_idx": torch.from_numpy(idx),
            "coin": np_(jax.random.uniform(coin_k, ()) < 1.0 / 3.0)}


@functools.lru_cache(maxsize=None)
def _jax_forward_ar_grad():
    """The JAX AR pass's loss and denoiser gradients, compiled once for
    the cases below."""
    jsys = _systems(True)[0]
    return jax.jit(jax.value_and_grad(
        lambda den, vae, batch, key, uncond: jsys.diffusion_forward_ar(
            den, vae, batch, key, uncond), has_aux=True))


@pytest.mark.parametrize("seed", [1, 3], ids=["indexed", "coin"])
def test_diffusion_forward_ar_matches_jax(md, seed):
    """Training mode at dropout 0 with the JAX pass's draws: the loss
    within 1e-4 and every denoiser gradient within 1e-3, no VAE gradient.
    Key 1 trains tokens past the first (the coin says no), key 3 token 0
    for every sample (the coin says yes)."""
    jsys, params, tsys = md
    lengths = np.array([196, 150, 48, 100], np.int32)
    B = len(lengths)
    rng = np.random.RandomState(12)
    batch = {"motion": (0.5 * rng.randn(B, T, NFEATS)).astype(np.float32),
             "length": lengths,
             "text_emb": rng.randn(B, 1, TEXT).astype(np.float32)}
    uncond = (0.1 * rng.randn(1, 1, TEXT)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, (jlogs, _)), gtree = _jax_forward_ar_grad()(
        params["denoiser"], params["vae"], jb, key, jnp.asarray(uncond))
    draws = _ar_draws(key, B, -(-lengths // 48))
    tb = {"motion": torch.from_numpy(batch["motion"]),
          "length": torch.from_numpy(lengths.astype(np.int64)),
          "text_emb": torch.from_numpy(batch["text_emb"])}
    got, (logs, aux) = tsys.diffusion_forward_ar(tb, torch.from_numpy(uncond),
                                                 **draws)
    idx = aux["latent_idx"].tolist()
    assert (max(idx) == 0) == bool(draws["coin"])
    assert idx[2] == 0  # one active token
    assert relerr(got.detach().numpy(), np.asarray(want)) <= TOL
    assert set(logs) == set(jlogs)
    tsys.zero_grad(set_to_none=True)
    got.backward()
    named = dict(tsys.named_parameters())
    for name, g in flax_state_dict(gtree, "denoiser.").items():
        if named[name].grad is None:
            assert not g.any(), name
        else:
            assert relerr(named[name].grad.numpy(), g.numpy()) <= GRAD_TOL, \
                name
    assert all(p.grad is None for n, p in named.items()
               if n.startswith("vae."))
    tsys.zero_grad(set_to_none=True)


def test_ar_train_step_draws_from_the_generator(md):
    """``diffusion_train_step`` takes the AR pass for an ``ardiff``
    system; without the optional tensors every draw comes from the
    generator (same seed, same loss)."""
    from ladiff_torch.training.trainer import (diffusion_train_step,
                                               make_optimizer)
    _, _, tsys = md
    state = {k: v.clone() for k, v in tsys.state_dict().items()}
    rng = np.random.RandomState(13)
    batch = {"motion": torch.from_numpy(
                 (0.5 * rng.randn(4, T, NFEATS)).astype(np.float32)),
             "length": torch.tensor([196, 150, 60, 100]),
             "text_emb": torch.from_numpy(
                 rng.randn(4, 1, TEXT).astype(np.float32))}
    uncond = torch.zeros(1, 1, TEXT)
    losses = []
    for _ in range(2):
        tsys.load_state_dict(state)
        opt = make_optimizer(tsys.denoiser.parameters(), 1e-3)
        losses.append(float(diffusion_train_step(
            tsys, opt, batch, uncond,
            torch.Generator().manual_seed(5))["total"]))
    moved = any(not torch.equal(v, state[k])
                for k, v in tsys.state_dict().items())
    tsys.load_state_dict(state)
    assert losses[0] == losses[1] and np.isfinite(losses[0]) and moved


# -- configuration and entry points -------------------------------------------

@pytest.mark.parametrize("mode", ["last", "full", "middle"])
def test_from_cfg_ardiff(tmp_path, mode):
    """``ARDIFF: true`` and ``model.motion_conditioning`` reach the port's
    system as the JAX package's ``from_cfg`` reads them; the converted JAX
    params load strictly; an unknown mode raises."""
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    cfg = _cfg("config_ladiff_humanml3d.yaml", **_small_overrides(
        tmp_path, ARDIFF=True, model={"motion_conditioning": mode}))
    tsys = LADiffSystem.from_cfg(cfg, nfeats=NFEATS, njoints=22,
                                 device="cpu")
    jsys = JaxSystem.from_cfg(cfg, nfeats=NFEATS, njoints=22)
    assert (tsys.ardiff, tsys.motion_conditioning) == (
        jsys.ardiff, jsys.motion_conditioning) == (True, mode)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), 3)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    cfg.model.motion_conditioning = "sideways"
    with pytest.raises(ValueError, match="motion_conditioning"):
        LADiffSystem.from_cfg(cfg, nfeats=NFEATS, njoints=22, device="cpu")


def test_run_training_ardiff_and_demo(tmp_path, monkeypatch):
    """A tiny stage-2 ``run_training`` with ``ARDIFF`` writes a checkpoint
    that loads strictly into an AR system; ``demo.main`` samples from it
    through ``diffusion_reverse_ar`` and writes finite joints."""
    from ladiff_torch import demo
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.training.loop import run_training
    from ladiff_torch.utils.checkpoint import latest_checkpoint, \
        load_checkpoint
    over = _small_overrides(tmp_path, ARDIFF=True, TRAIN={
        "END_EPOCH": 1, "PRETRAINED_VAE": ""})
    cfg = _cfg("config_ladiff_humanml3d.yaml", **over)
    ckpt_dir = run_training(cfg, get_datasets(cfg)[0], _logger(cfg),
                            text_encoder=_text_encoder,
                            max_steps_per_epoch=2, device="cpu")
    epoch, sd = load_checkpoint(latest_checkpoint(ckpt_dir)[1])
    system = LADiffSystem.from_cfg(cfg, nfeats=NFEATS, njoints=22,
                                   device="cpu")
    system.load_state_dict(sd, strict=True)
    assert epoch == 1 and system.ardiff

    calls = []
    real = LADiffSystem.diffusion_reverse_ar
    monkeypatch.setattr(LADiffSystem, "diffusion_reverse_ar",
                        lambda self, *a, **k: calls.append(1) or real(
                            self, *a, **k))
    over = _small_overrides(
        tmp_path, ARDIFF=True, TEST={"CHECKPOINTS": ckpt_dir},
        model={"scheduler": {"num_inference_timesteps": 2}})
    out = demo.main(["--cfg", os.path.join(os.path.dirname(__file__), "..",
                                           "configs",
                                           "config_ladiff_humanml3d.yaml"),
                     "--cpu", "--out_dir", str(tmp_path / "samples")],
                    text_encoder=_text_encoder, overrides=over)
    assert calls == [1]
    for i, (n, _) in enumerate(demo.DEFAULT_EXAMPLES):
        joints = np.load(os.path.join(out, f"sample_{i:03d}.npy"))
        assert joints.shape == (n, 22, 3) and np.isfinite(joints).all()
