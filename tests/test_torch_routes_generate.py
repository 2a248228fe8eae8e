"""``generate`` on generation's other denoiser routes in the PyTorch port
against the JAX package on the CPU, at the size of test_torch_slice.py: the
whole-stack route (``md_stack=True``), full-context text [B, 9, 768] and
head width 256 (the per-block routes of the MD layers and the VAE decoder);
which kernel wrappers each route calls, and the default route's K1; the
refusal of shapes kernel 11 does not take; and the CLIP encoder's
full-context (last hidden state) mode.

Tolerance 2e-3 for ``generate`` (see test_torch_slice.py), 1e-4 for the
CLIP encoder (see test_torch_modules.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_md_routes import calls, layer_calls  # noqa: F401 (fixtures)
from test_torch_modules import relerr

TOL = 1e-4


# -- CLIP: the full-context (last hidden state) mode -----------------------

def test_clip_encoder_full_context_matches_jax(monkeypatch):
    """``last_hidden_state``: [B, 77, width] hidden states, no bucketing,
    the same as the JAX encoder from the same weights (a narrow tower)."""
    from ladiff_torch.convert import clip_state_dict
    from ladiff_torch.models import clip_text as tc
    from ladiff_tpu.models import clip_text as jc
    small = dict(width=64, num_layers=2, heads=2, projection_dim=64)
    monkeypatch.setattr(jc, "CLIPTextTower",
                        functools.partial(jc.CLIPTextTower, **small))
    monkeypatch.setattr(tc, "CLIPTextTower",
                        functools.partial(tc.CLIPTextTower, **small))
    je = jc.ClipTextEncoder(last_hidden_state=True)
    te = tc.ClipTextEncoder(last_hidden_state=True, device="cpu")
    te.tower.load_state_dict(clip_state_dict(
        jax.tree.map(np.asarray, je.params)), strict=True)
    texts = ["a person walks forward", "someone jumps twice and sits down"]
    want = np.asarray(je(texts))
    got = te(texts)
    assert got.shape == (2, 77, 64) == want.shape
    assert relerr(got, want) <= TOL


# -- generation on the other routes ----------------------------------------

@pytest.fixture(scope="module")
def systems():
    from test_torch_slice import _systems
    return _systems()


def _generate(tsys, cond, uncond, init):
    from test_torch_slice import FRAMES, LENGTHS
    return tsys.generate(torch.from_numpy(cond), torch.from_numpy(uncond),
                         torch.from_numpy(LENGTHS.astype(np.int64)),
                         nframes=FRAMES, init_latents=torch.tensor(init))


@pytest.mark.parametrize("route", ["md_stack", "full_context"])
def test_generate_routes_match_jax(systems, calls, monkeypatch, route):
    """``generate`` on the stack route (``md_stack=True``) and with
    full-context text [B, 9, 768] against JAX ``generate`` with the same
    weights and noise (the JAX package computes both with its layer loop
    on the CPU); each route's kernel wrappers, and no MD prep for text of
    more than one token."""
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from test_torch_slice import FRAMES, LENGTHS, STEPS
    jsys, params, tsys = systems
    B, n = len(LENGTHS), 1 if route == "md_stack" else 9
    rng = np.random.RandomState(62)
    cond = rng.randn(B, n, 768).astype(np.float32)
    uncond = (rng.randn(B, n, 768) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(12)
    feats_j, z_j = jsys.generate(params, jnp.asarray(cond),
                                 jnp.asarray(uncond), jnp.asarray(LENGTHS),
                                 key, nframes=FRAMES)
    init = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                        z_j.shape, jnp.float32))
    if route == "md_stack":
        system = TorchSystem(md_stack=True, mean=tsys.mean.numpy(),
                             std=tsys.std.numpy(), device="cpu",
                             **_slice_kw())
        system.load_state_dict(tsys.state_dict(), strict=True)
    else:
        system = tsys
    preps = []
    orig = system.denoiser.precompute_md_prep
    monkeypatch.setattr(system.denoiser, "precompute_md_prep",
                        lambda *a, **k: preps.append(1) or orig(*a, **k))
    feats_t, z_t = _generate(system, cond, uncond, init)
    assert relerr(z_t.numpy(), z_j) <= 2e-3
    assert relerr(feats_t.numpy(), feats_j) <= 2e-3
    layers = len(system.denoiser.encoder.ordered_blocks())
    if route == "md_stack":
        assert calls == {"fused_md_stack": STEPS} and preps == [1]
    else:
        assert calls == {"fused_stylized_ffn": STEPS * layers}
        assert preps == []


def test_generate_head_width_256_matches_jax(calls, layer_calls):
    """One text token at head width 256 (H 1), which neither K1 nor K2
    takes: every MD layer per block (kernel 5's tail, kernel 7, kernel 6)
    and every decoder layer per block (plain attention, kernel 5), against
    JAX ``generate`` with the same weights and noise."""
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    from ladiff_torch.convert import system_state_dict
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from test_torch_slice import FRAMES, LENGTHS, STEPS, randomize
    kw = dict(_slice_kw(), latent_dim=(7, 256), num_heads=1)
    jsys = JaxSystem(dropout=0.0, **kw)
    params = randomize(jsys.init_params(jax.random.PRNGKey(0)), 2)
    tsys = TorchSystem(device="cpu", **kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    B = len(LENGTHS)
    rng = np.random.RandomState(65)
    cond = rng.randn(B, 1, 768).astype(np.float32)
    uncond = (rng.randn(B, 1, 768) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(14)
    feats_j, z_j = jsys.generate(params, jnp.asarray(cond),
                                 jnp.asarray(uncond), jnp.asarray(LENGTHS),
                                 key, nframes=FRAMES)
    init = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                        z_j.shape, jnp.float32))
    feats_t, z_t = _generate(tsys, cond, uncond, init)
    assert relerr(z_t.numpy(), z_j) <= 2e-3
    assert relerr(feats_t.numpy(), feats_j) <= 2e-3
    md = STEPS * len(tsys.denoiser.encoder.ordered_blocks())
    assert calls == {"fused_broadcast_stylize": md, "fused_stylized_ffn": md}
    assert layer_calls == {
        "fused_postnorm_ffn": md + len(tsys.vae.decoder.ordered_blocks())}


def _slice_kw():
    from test_torch_slice import (D, FF, FRAMES, GUIDANCE, HEADS, LAYERS,
                                  NFEATS, NJOINTS, STEPS)
    return dict(nfeats=NFEATS, njoints=NJOINTS, max_frames=FRAMES,
                latent_dim=(7, D), ff_size=FF, num_layers=LAYERS,
                num_heads=HEADS, guidance_scale=GUIDANCE,
                num_inference_timesteps=STEPS)


def test_default_route_takes_k1(systems, calls):
    """Pooled text on the default system: every MD layer of every step is
    one call of K1's wrapper, and no other route's wrapper is called."""
    from test_torch_slice import LENGTHS, STEPS
    _, _, tsys = systems
    B = len(LENGTHS)
    rng = np.random.RandomState(63)
    cond = rng.randn(B, 1, 768).astype(np.float32)
    init = rng.randn(B, 5, tsys.latent_dim[-1]).astype(np.float32)
    _generate(tsys, cond, cond * 0.1, init)
    layers = len(tsys.denoiser.encoder.ordered_blocks())
    assert calls == {"fused_md_layer": STEPS * layers}


def test_md_stack_refuses_shapes_kernel_11_does_not_take():
    """At construction, naming the shape (head width 256 here), and at
    sampling time for text of more than one token: never a silent
    per-layer route."""
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    kw = dict(_slice_kw(), latent_dim=(7, 256), num_heads=1)
    with pytest.raises(ValueError, match="md_stack.*D=256 H=1"):
        TorchSystem(md_stack=True, device="cpu", **kw)
    TorchSystem(device="cpu", **kw)  # the per-block route takes it
    system = TorchSystem(md_stack=True, device="cpu", **_slice_kw())
    text = torch.zeros(2, 9, 768)
    with pytest.raises(ValueError, match="one text token"):
        system.diffusion_reverse(text, text, torch.tensor([40, 196]))


@pytest.mark.parametrize("kind,eta", [("ddpm", 0.0), ("ddim", 0.5)])
def test_sampler_options_of_the_system_match_jax(systems, monkeypatch, kind,
                                                 eta):
    """``LADiffSystem(eta=, scheduler_kind=)`` and ``diffusion_reverse(
    return_trajectory=True)`` against the JAX system's, the JAX sampler's
    own draws (its initial noise, then each step's) fed to the port in
    their order."""
    import dataclasses
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from test_torch_slice import LENGTHS, STEPS
    jsys, params, tsys = systems
    jsys = dataclasses.replace(jsys, scheduler_kind=kind, eta=eta)
    B = len(LENGTHS)
    rng = np.random.RandomState(64)
    cond = rng.randn(B, 1, 768).astype(np.float32)
    uncond = (rng.randn(B, 1, 768) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(13)
    z_j, traj_j = jsys.diffusion_reverse(
        params["denoiser"], jnp.asarray(cond), jnp.asarray(uncond),
        jnp.asarray(LENGTHS), key, return_trajectory=True)
    init_key, noise_key = jax.random.split(key)
    draws = []
    for _ in range(STEPS):
        noise_key, step_key = jax.random.split(noise_key)
        draws.append(torch.from_numpy(np.asarray(
            jax.random.normal(step_key, z_j.shape, jnp.float32))))
    system = TorchSystem(scheduler_kind=kind, eta=eta,
                         mean=tsys.mean.numpy(), std=tsys.std.numpy(),
                         device="cpu", **_slice_kw())
    system.load_state_dict(tsys.state_dict(), strict=True)
    monkeypatch.setattr(torch, "randn", lambda *a, **k: draws.pop(0))
    z_t, traj_t = system.diffusion_reverse(
        torch.from_numpy(cond), torch.from_numpy(uncond),
        torch.from_numpy(LENGTHS.astype(np.int64)),
        init_latents=torch.from_numpy(np.asarray(
            jax.random.normal(init_key, z_j.shape, jnp.float32))),
        return_trajectory=True)
    assert draws == []
    assert traj_t.shape == (STEPS, *z_j.shape)
    assert relerr(z_t.numpy(), z_j) <= 2e-3
    assert relerr(traj_t.numpy(), traj_j) <= 2e-3
