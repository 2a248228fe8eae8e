"""The port's MotionCLIP against the JAX package on the CPU, on converted
weights: the motion encoder and decoder with their frame masks (padded
frames zero), ``MotionClip`` and ``clip_alignment``, gradients through the
autoencoder against ``jax.grad``; ``MotionClipTextEncoder`` (ViT-B/32 text
geometry) with the hash tokenizer and an HF-named checkpoint written to
``tmp_path`` and loaded by both packages, pooled and last hidden state, and
a checkpoint without a text projection (the identity, as the JAX loader
gives it); ``generate`` of a small LADiff system at ``text_encoded_dim``
512 on the tower's features.

Sizes: the autoencoder at latent 32, 2 layers, 4 heads, 24 frames; the
text tower at its real geometry (width 512, 12 layers); the LADiff system
at d 64, 3 layers, DDIM-3.  Tolerances (PERF.md section 2): forwards and
gradients 1e-4 norm-wise, ``generate`` 2e-3.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import motionclip_state_dict, system_state_dict
from ladiff_torch.models.motionclip import (MotionClip,
                                            MotionClipMotionDecoder,
                                            MotionClipMotionEncoder,
                                            MotionClipTextEncoder)
from ladiff_tpu.models import motionclip as ref
from torch_alt_helpers import (TOL, jitted, loaded, noise_tree, relerr,
                               shapes, t)

NF, D, LAYERS, HEADS, FF, MAXLEN = 12, 32, 2, 4, 64, 24
LENGTHS = np.array([24, 9, 3], np.int32)
CAPTIONS = ["a person walks forward and turns left",
            "someone jumps twice", "a man waves his right hand slowly"]
GEN_TOL = 2e-3


def _feats(seed=0):
    return np.random.RandomState(seed).randn(
        len(LENGTHS), MAXLEN, NF).astype(np.float32)


@pytest.fixture(scope="module")
def autoencoder():
    """The JAX ``MotionClip`` (dropout 0.1, deterministic), its noise
    params, and the port's on the same weights."""
    jm = ref.MotionClip(nfeats=NF, latent_dim=D, num_layers=LAYERS,
                        num_heads=HEADS, ff_size=FF, max_len=MAXLEN)
    feats = _feats()
    variables = noise_tree(shapes(jm, feats, LENGTHS), 0)
    tm = loaded(MotionClip(NF, D, LAYERS, HEADS, FF, 0.1, MAXLEN,
                           device="cpu"),
                motionclip_state_dict(variables["params"]))
    return jm, variables, tm


def test_autoencoder_matches_jax(autoencoder):
    """``MotionClip`` forward, and each tower alone on the same weights;
    padded frames are exactly zero."""
    jm, variables, tm = autoencoder
    feats = _feats()
    recon_j, z_j = jitted(jm)(variables, feats, LENGTHS)
    lengths = torch.from_numpy(LENGTHS.astype(np.int64))
    with torch.no_grad():
        recon_t, z_t = tm(t(feats), lengths)
        enc = loaded(MotionClipMotionEncoder(
            NF, D, LAYERS, HEADS, FF, max_len=MAXLEN, device="cpu"),
            motionclip_state_dict(variables["params"]["encoder"]))
        dec = loaded(MotionClipMotionDecoder(
            NF, D, LAYERS, HEADS, FF, max_len=MAXLEN, device="cpu"),
            motionclip_state_dict(variables["params"]["decoder"]))
        z_alone = enc(t(feats), lengths)
        recon_alone = dec(t(z_j), lengths, 16)
    assert relerr(z_t.numpy(), z_j) <= TOL
    assert relerr(recon_t.numpy(), recon_j) <= TOL
    assert relerr(z_alone.numpy(), z_j) <= TOL
    assert recon_alone.shape == (len(LENGTHS), 16, NF)
    # sample 2 (3 frames) attends to the same keys at either frame count
    assert relerr(recon_alone[2].numpy(), recon_t[2, :16].numpy()) <= TOL
    for i, n in enumerate(LENGTHS):
        assert not recon_t[i, n:].any()
        assert not recon_alone[i, min(n, 16):].any()


def test_encoder_masks_padded_frames(autoencoder):
    """The latent does not depend on what padded frames hold."""
    _, _, tm = autoencoder
    feats = _feats()
    other = feats.copy()
    other[1, LENGTHS[1]:] = 50.0
    lengths = torch.from_numpy(LENGTHS.astype(np.int64))
    with torch.no_grad():
        a = tm.encode(t(feats), lengths)
        b = tm.encode(t(other), lengths)
    assert relerr(b.numpy(), a.numpy()) <= 1e-6


def test_clip_alignment_matches_jax():
    rng = np.random.RandomState(2)
    zm, zt = rng.randn(4, 16), rng.randn(4, 16)
    got = MotionClip.clip_alignment(t(zm), t(zt)).numpy()
    want = np.asarray(ref.MotionClip.clip_alignment(jnp.asarray(zm),
                                                    jnp.asarray(zt)))
    assert relerr(got, want) <= 1e-6
    assert np.allclose(np.diag(MotionClip.clip_alignment(t(zm), t(zm))), 1.0,
                       atol=1e-6)


def test_autoencoder_gradients_match_jax(autoencoder):
    """d(loss)/d(params) of a weighted sum of the reconstruction and the
    latent, against ``jax.grad``; each parameter within 1e-4 of the
    gradients' overall scale (a key bias's gradient is zero up to
    rounding)."""
    jm, variables, tm = autoencoder
    feats = _feats()
    rng = np.random.RandomState(5)
    w_rec = rng.randn(len(LENGTHS), MAXLEN, NF).astype(np.float32)
    w_z = rng.randn(len(LENGTHS), D).astype(np.float32)

    def loss(params):
        recon, z = jm.apply({"params": params}, feats, LENGTHS)
        return jnp.sum(recon * w_rec) + jnp.sum(z * w_z)

    grads = motionclip_state_dict(jax.jit(jax.grad(loss))(
        variables["params"]))
    tm.zero_grad()
    recon, z = tm(t(feats), torch.from_numpy(LENGTHS.astype(np.int64)))
    ((recon * t(w_rec)).sum() + (z * t(w_z)).sum()).backward()
    scale = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
    for name, p in tm.named_parameters():
        diff = np.linalg.norm(p.grad.numpy() - grads[name].numpy())
        assert diff <= TOL * max(np.linalg.norm(grads[name].numpy()),
                                 1e-3 * scale), name


@pytest.fixture(scope="module")
def text_towers(tmp_path_factory):
    """A port tower (seeded random) saved HF-named to a checkpoint folder
    without a vocab.json (so both packages take the hash tokenizer), and
    each package's encoder loaded from it."""
    path = tmp_path_factory.mktemp("motionclip_ckpt")
    port = MotionClipTextEncoder(device="cpu", seed=3)
    torch.save(port.tower.state_dict(), path / "pytorch_model.bin")
    return (path, MotionClipTextEncoder(str(path), device="cpu"),
            ref.MotionClipTextEncoder(str(path)))


def test_text_encoder_matches_jax(text_towers):
    """Pooled [B, 1, 512]: the port at its 16-token bucket, the JAX class at
    77 tokens; the same hash ids."""
    path, port, jenc = text_towers
    assert type(port.tokenizer).__name__ == "HashTokenizer"
    np.testing.assert_array_equal(port.tokenizer(CAPTIONS),
                                  jenc.tokenizer(CAPTIONS))
    got = port(CAPTIONS)
    want = np.asarray(jenc(CAPTIONS))
    assert got.shape == want.shape == (3, 1, 512)
    assert relerr(got.numpy(), want) <= TOL


def test_text_encoder_hidden_state_and_identity_projection(text_towers,
                                                           tmp_path):
    """``last_hidden_state`` [B, 77, 512] against the JAX class; a
    checkpoint without ``text_projection.weight`` loads the identity
    projection, so the pooled feature is the EOT row of the hidden state."""
    path, port, _ = text_towers
    hidden = MotionClipTextEncoder(str(path), last_hidden_state=True,
                                   device="cpu")
    jenc = ref.MotionClipTextEncoder(str(path), last_hidden_state=True)
    got = hidden(CAPTIONS)
    assert got.shape == (3, 77, 512)
    assert relerr(got.numpy(), np.asarray(jenc(CAPTIONS))) <= TOL
    state = {k: v for k, v in port.tower.state_dict().items()
             if k != "text_projection.weight"}
    torch.save(state, tmp_path / "pytorch_model.bin")
    ident = MotionClipTextEncoder(str(tmp_path), device="cpu")
    assert torch.equal(ident.tower.text_projection.weight, torch.eye(512))
    eot = np.asarray(ident.tokenizer(CAPTIONS)).argmax(-1)
    pooled = ident(CAPTIONS)[:, 0]
    assert relerr(pooled.numpy(),
                  got[torch.arange(3), torch.from_numpy(eot)].numpy()) <= 1e-6


def test_generate_with_motionclip_text_matches_jax(text_towers):
    """A small LADiff system at ``text_encoded_dim`` 512 conditioned on the
    tower's pooled features (each package on its own tower's), CFG 7.5
    DDIM-3, the initial latents passed in."""
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    _, port, jenc = text_towers
    kw = dict(nfeats=263, njoints=22, max_frames=64, latent_dim=(7, 64),
              ff_size=128, num_layers=3, num_heads=4, text_encoded_dim=512,
              guidance_scale=7.5, num_inference_timesteps=3)
    jsys = JaxSystem(dropout=0.0, **kw)
    key = jax.random.PRNGKey(11)
    params = noise_tree(jax.eval_shape(jsys.init_params, key), 1)
    tsys = TorchSystem(device="cpu", **kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    tsys.eval()
    lengths = np.array([64, 40, 17], np.int32)
    cond_j, uncond_j = jenc(CAPTIONS), jenc([""] * 3)
    feats_j, z_j = jax.jit(functools.partial(jsys.generate, nframes=64))(
        params, cond_j, uncond_j, jnp.asarray(lengths), key)
    init = jax.random.normal(jax.random.split(key)[0], (3, 5, 64),
                             jnp.float32)
    with torch.no_grad():
        feats_t, z_t = tsys.generate(
            port(CAPTIONS), port([""] * 3),
            torch.from_numpy(lengths.astype(np.int64)), nframes=64,
            init_latents=t(init))
    assert feats_t.shape == (3, 64, 263)
    assert relerr(z_t.numpy(), z_j) <= GEN_TOL
    assert relerr(feats_t.numpy(), feats_j) <= GEN_TOL
