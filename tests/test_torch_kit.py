"""The KIT-ML family (251 features, 21 MMM joints) in the PyTorch port
against the JAX package on the CPU: ``from_cfg`` on both published KIT
configurations with a strict load of the converted JAX params; the KIT
synthetic data and its datamodule's batches and joints; ``generate`` and
``feats2joints`` at 21 joints; ``vae_forward`` (stage 1) and
``diffusion_forward`` (stage 2) losses and gradients at 251 features with
the JAX passes' draws handed in; ``TemosMetrics(jointstype="kit")``.

Sizes: latent_dim (7, 32), 3 layers, 4 heads, ff 64, 64 frames, 2 DDIM
steps.  Tolerances: losses and joints 1e-4 norm-wise (float32 on both
sides), each gradient tensor 1e-3, ``generate`` 2e-3 (guided steps
amplify the rounding), the metrics 1e-10 (the same numpy code).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import flax_state_dict, system_state_dict
from test_torch_entry import _cfg
from test_torch_metrics import joints, same_dict
from test_torch_slice import randomize, relerr

NFEATS, NJOINTS, T, D, TEXT, STEPS = 251, 21, 64, 32, 48, 2
TOL, GEN_TOL, GRAD_TOL = 1e-4, 2e-3, 1e-3
LENGTHS = np.array([64, 40, 24], np.int32)


@functools.lru_cache(maxsize=None)
def _systems():
    """JAX and port KIT systems on the same randomized weights."""
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    kw = dict(nfeats=NFEATS, njoints=NJOINTS, max_frames=T,
              latent_dim=(7, D), ff_size=64, num_layers=3, num_heads=4,
              text_encoded_dim=TEXT, num_inference_timesteps=STEPS,
              frame_per_latent=16, guidance_uncondp=0.4)
    rng = np.random.RandomState(3)
    mean = (0.1 * rng.randn(NFEATS)).astype(np.float32)
    std = (0.05 + 0.1 * np.abs(rng.randn(NFEATS))).astype(np.float32)
    jsys = JaxSystem(dropout=0.0, mean=jnp.asarray(mean),
                     std=jnp.asarray(std), **kw)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), 1)
    tsys = TorchSystem(mean=mean, std=std, device="cpu", **kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    return jsys, params, tsys


@pytest.fixture(scope="module")
def kit():
    return _systems()


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"motion": (0.5 * rng.randn(len(LENGTHS), T, NFEATS)).astype(
                np.float32),
            "length": LENGTHS,
            "text_emb": rng.randn(len(LENGTHS), 1, TEXT).astype(np.float32)}


def _torch_batch(batch):
    return {"motion": torch.from_numpy(batch["motion"]),
            "length": torch.from_numpy(batch["length"].astype(np.int64)),
            "text_emb": torch.from_numpy(batch["text_emb"])}


def _np(a):
    return torch.from_numpy(np.array(a))


def _grads_match(tsys, gtree, prefix):
    """Every gradient of the JAX tree within 1e-3 of the port's parameter
    of the same name; the other tree has none."""
    named = dict(tsys.named_parameters())
    want = flax_state_dict(gtree, prefix)
    assert set(want) == {n for n in named if n.startswith(prefix)}
    for name, g in want.items():
        got = named[name].grad
        if got is None:
            assert not g.any(), name
        else:
            assert relerr(got.numpy(), g.numpy()) <= GRAD_TOL, name
    assert all(p.grad is None for n, p in named.items()
               if not n.startswith(prefix))


# -- configurations ---------------------------------------------------------

@pytest.mark.parametrize("name", ["config_vae_kit.yaml",
                                  "config_ladiff_kit.yaml"])
def test_from_cfg_kit(name):
    """Both published KIT configurations, unmodified, build the port's
    system at full width as the JAX package's ``from_cfg`` reads them; the
    converted JAX params load strictly.  The stage-1 configuration names
    the plain denoiser, which its stage never runs: the port keeps the
    MD-trans one there (``from_cfg``), so its VAE loads strictly alone."""
    from ladiff_torch.utils.checkpoint import subtree
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    cfg = _cfg(name)
    tsys = LADiffSystem.from_cfg(cfg, nfeats=NFEATS, njoints=NJOINTS,
                                 device="cpu")
    jsys = JaxSystem.from_cfg(cfg, nfeats=NFEATS, njoints=NJOINTS)
    for key in ("nfeats", "njoints", "max_frames", "latent_dim", "max_it",
                "frame_per_latent", "guidance_scale", "guidance_uncondp",
                "num_inference_timesteps", "ardiff", "motion_conditioning"):
        assert getattr(tsys, key) == getattr(jsys, key), key
    assert (tsys.vae.dvae, tsys.vae.percentage_noised) == (
        jsys.dvae, jsys.percentage_noised)
    assert tsys.weights.__dict__ == jsys.weights.__dict__
    params = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                          jax.eval_shape(jsys.init_params,
                                         jax.random.PRNGKey(0)))
    sd = system_state_dict(params)
    if name == "config_vae_kit.yaml":
        assert tsys.md_trans and not jsys.md_trans
        tsys.vae.load_state_dict(subtree(sd, "vae."), strict=True)
    else:
        assert tsys.md_trans and jsys.md_trans
        tsys.load_state_dict(sd, strict=True)
    assert tsys.vae.skel_embedding.in_features == NFEATS


# -- data ---------------------------------------------------------------------

def test_kit_data_and_joints(tmp_path):
    """The KIT synthetic dataset (251 features) is the JAX package's file
    for file; the KIT datamodule's first batch and its joints [.., 21, 3]
    are the JAX datamodule's."""
    from ladiff_torch.data.datamodule import T2MDataModule
    from ladiff_torch.data.synthetic import generate_synthetic_dataset
    from ladiff_torch.data.word_vectorizer import HashWordVectorizer
    from ladiff_tpu.data.datamodule import T2MDataModule as JDM
    from ladiff_tpu.data.synthetic import generate_synthetic_dataset as jgen
    from ladiff_tpu.data.word_vectorizer import HashWordVectorizer as JHW
    root = generate_synthetic_dataset(str(tmp_path / "t"), n_clips=16,
                                      nfeats=NFEATS, seed=0)
    jroot = jgen(str(tmp_path / "j"), n_clips=16, nfeats=NFEATS, seed=0)
    for rel in ("Mean.npy", "Std.npy", "new_joint_vecs/000000.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(root, rel)),
                                      np.load(os.path.join(jroot, rel)))
    dm = T2MDataModule("kit", root, HashWordVectorizer(), batch_size=4)
    jdm = JDM("kit", jroot, JHW(), batch_size=4)
    assert (dm.nfeats, dm.njoints, dm.min_motion_length) == (
        jdm.nfeats, jdm.njoints, jdm.min_motion_length) == (NFEATS,
                                                            NJOINTS, 24)
    batch, jbatch = next(iter(dm.loader("train"))), next(iter(
        jdm.loader("train")))
    np.testing.assert_array_equal(batch["motion"], jbatch["motion"])
    np.testing.assert_array_equal(batch["length"], jbatch["length"])
    assert list(batch["text"]) == list(jbatch["text"])
    got = dm.feats2joints(torch.from_numpy(batch["motion"]))
    want = np.asarray(jdm.feats2joints(jnp.asarray(jbatch["motion"])))
    assert got.shape[-2:] == (NJOINTS, 3) and torch.isfinite(got).all()
    assert relerr(got.numpy(), want) <= TOL


def test_temos_metrics_kit_match_jax():
    """APE / AVE with the MMM joints (``jointstype="kit"``, metres: factor
    1000) against the JAX metric."""
    from ladiff_torch.metrics import temos
    from ladiff_tpu.metrics import temos as jtemos
    pr, gt = joints(21, J=NJOINTS)
    lengths = [50, 31, 12]
    got = temos.TemosMetrics(NJOINTS, "kit")
    want = jtemos.TemosMetrics(NJOINTS, "kit")
    assert got.factor == want.factor == 1000.0
    for obj in (got, want):
        obj.update(pr, gt, lengths)
        obj.update(pr[:2] * 1.1, gt[:2], lengths[:2])
    same_dict(got.compute(), want.compute())


# -- generation and training ----------------------------------------------

def test_generate_kit_matches_jax(kit):
    """CFG 7.5 DDIM-2 and the decode at 251 features, the JAX initial
    noise handed in; the joints [B, T, 21, 3] of both; padded frames
    zero."""
    jsys, params, tsys = kit
    B = len(LENGTHS)
    rng = np.random.RandomState(7)
    cond = rng.randn(B, 1, TEXT).astype(np.float32)
    uncond = (0.1 * rng.randn(B, 1, TEXT)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    feats_j, z_j = jax.jit(functools.partial(jsys.generate, nframes=T))(
        params, jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(LENGTHS),
        key)
    joints_j = np.asarray(jsys.feats2joints(feats_j))
    init = _np(jax.random.normal(jax.random.split(key)[0], (B, 5, D),
                                 jnp.float32))
    feats_t, z_t = tsys.generate(torch.from_numpy(cond),
                                 torch.from_numpy(uncond),
                                 torch.from_numpy(LENGTHS.astype(np.int64)),
                                 nframes=T, init_latents=init)
    joints_t = tsys.feats2joints(feats_t)
    assert feats_t.shape == (B, T, NFEATS)
    assert joints_t.shape == (B, T, NJOINTS, 3)
    assert relerr(z_t.numpy(), z_j) <= GEN_TOL
    assert relerr(feats_t.numpy(), feats_j) <= GEN_TOL
    assert relerr(joints_t.numpy(), joints_j) <= GEN_TOL
    assert not feats_t[2, LENGTHS[2]:].any()


def test_vae_forward_kit_matches_jax(kit):
    """Stage 1 in training mode at dropout 0 with the JAX pass's latent
    noise: the loss and its terms within 1e-4 and every VAE gradient
    within 1e-3."""
    jsys, params, tsys = kit
    batch = _batch(8)
    key = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "text_emb"}

    def loss(p):
        return jsys.vae_forward(p, jb, key)

    (want, (wlogs, _)), gtree = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params["vae"])
    eps = _np(jax.random.normal(jax.random.split(key, 3)[0],
                                (len(LENGTHS), 5, D), jnp.float32))
    got, (logs, aux) = tsys.vae_forward(_torch_batch(batch), eps=eps)
    assert aux["joints_rst"].shape[-2:] == (NJOINTS, 3)
    assert relerr(got.detach().numpy(), np.asarray(want)) <= TOL
    for k in ("recons_feature", "recons_joints", "kl_motion"):
        assert relerr(logs[k].detach().numpy(), np.asarray(wlogs[k])) <= TOL
    tsys.zero_grad(set_to_none=True)
    got.backward()
    _grads_match(tsys, gtree, "vae.")
    tsys.zero_grad(set_to_none=True)


def test_diffusion_forward_kit_matches_jax(kit):
    """Stage 2 in training mode at dropout 0 with the JAX pass's draws
    (encode noise, noise, timesteps, caption drop): the loss within 1e-4
    and every denoiser gradient within 1e-3, none for the frozen VAE."""
    jsys, params, tsys = kit
    batch = _batch(9)
    B = len(LENGTHS)
    uncond = (0.1 * np.random.RandomState(10).randn(1, 1, TEXT)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(den):
        return jsys.diffusion_forward(den, params["vae"], jb, key,
                                      jnp.asarray(uncond))

    (want, _), gtree = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params["denoiser"])
    enc, t_k, n_k, cfg_k, _ = jax.random.split(key, 5)
    draws = {"eps": _np(jax.random.normal(enc, (B, 5, D), jnp.float32)),
             "noise": _np(jax.random.normal(n_k, (B, 5, D), jnp.float32)),
             "timesteps": _np(jax.random.randint(t_k, (B,), 0, 1000)).long(),
             "cond_drop": _np(jax.random.bernoulli(cfg_k, 0.4, (B, 1, 1)))}
    got, _ = tsys.diffusion_forward(_torch_batch(batch),
                                    torch.from_numpy(uncond), **draws)
    assert relerr(got.detach().numpy(), np.asarray(want)) <= TOL
    tsys.zero_grad(set_to_none=True)
    got.backward()
    _grads_match(tsys, gtree, "denoiser.")
    tsys.zero_grad(set_to_none=True)
