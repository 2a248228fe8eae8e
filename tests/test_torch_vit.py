"""The port's MAED Vision Transformer against the JAX package on the CPU,
on converted weights (NCHW images in the port, NHWC in the JAX package):
each ``st_mode`` over 2 clips of 3 frames, ``qkv_bias`` off and on with the
pre-logits layer, ``DropPath`` with the JAX draw replayed, ``HybridEmbed``
on a small conv backbone, the factories' geometry (built on the meta
device), and the JAX package's ``convert_torch_vit`` applied to the port's
``state_dict()`` gives back the JAX params bit for bit, which ties the
port's names to timm's.

Sizes: 16 x 16 images, patch 8, width 32, 2 blocks, 4 heads, 5 classes.
Tolerance 1e-4 norm-wise (PERF.md section 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from ladiff_torch.convert import vit_state_dict
from ladiff_torch.models import vision_transformer as port
from ladiff_tpu.models import vision_transformer as ref
from torch_alt_helpers import (TOL, flat_tree, loaded, noise_tree,
                               relerr, shapes, t)

SEQLEN, CLIPS = 3, 2
SMALL = dict(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4,
             num_classes=5, max_seqlen=4)


def _images(seed=0):
    """NHWC numpy images for the JAX package."""
    return np.random.RandomState(seed).randn(
        CLIPS * SEQLEN, 16, 16, 3).astype(np.float32)


def _pair(seed, images, **kw):
    jm = ref.VisionTransformer(**kw)
    params = noise_tree(shapes(jm, images, SEQLEN), seed)["params"]
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, SEQLEN))(
        params, images)
    return jm, params, want


@pytest.mark.parametrize("st_mode", ref._ST_MODES)
def test_st_modes_match_jax(st_mode):
    """Logits of each mode (qkv without bias, norm eps 1e-5); the reference
    converter on the port's state dict."""
    images = _images()
    _, params, want = _pair(1, images, st_mode=st_mode, **SMALL)
    tm = loaded(port.VisionTransformer(st_mode=st_mode, device="cpu",
                                       **SMALL), vit_state_dict(params))
    with torch.no_grad():
        got = tm(t(images).permute(0, 3, 1, 2), SEQLEN)
    assert got.shape == (CLIPS * SEQLEN, 5)
    assert relerr(got.numpy(), want) <= TOL
    assert "blocks.0.attn.qkv.bias" not in tm.state_dict()
    assert ("temp_embed" in tm.state_dict()) == (
        st_mode in port.TEMP_EMBED_MODES)
    back = ref.convert_torch_vit(tm.state_dict(), depth=2, patch_size=8)
    got_tree, want_tree = flat_tree(back), flat_tree(params)
    assert set(got_tree) == set(want_tree)
    for k in want_tree:
        np.testing.assert_array_equal(got_tree[k], want_tree[k], err_msg=k)


def test_qkv_bias_and_pre_logits_match_jax():
    """``qkv_bias``, a 16-wide tanh pre-logits layer and norm eps 1e-6,
    logits and ``forward_features``."""
    images = _images(2)
    kw = dict(SMALL, qkv_bias=True, representation_size=16, norm_eps=1e-6,
              st_mode="parallel")
    jm, params, want = _pair(3, images, **kw)
    feats_j = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, SEQLEN, method=jm.forward_features))(params, images)
    tm = loaded(port.VisionTransformer(device="cpu", **kw),
                vit_state_dict(params))
    x = t(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        got, feats = tm(x, SEQLEN), tm.forward_features(x, SEQLEN)
    assert feats.shape == (CLIPS * SEQLEN, 16)
    assert relerr(got.numpy(), want) <= TOL
    assert relerr(feats.numpy(), feats_j) <= TOL
    assert tm.blocks[0].norm1.eps == 1e-6


def test_drop_path_replays_the_jax_draw(monkeypatch):
    """Training-mode ``DropPath`` at rate 0.5: the JAX Bernoulli draw (the
    per-sample mask of ones it keeps) given to the port as its uniform
    draw."""
    x = np.random.RandomState(4).randn(16, 3, 5).astype(np.float32)
    key = jax.random.PRNGKey(5)
    dp = ref.DropPath(0.5)
    want = np.asarray(dp.apply({}, jnp.asarray(x), deterministic=False,
                               rngs={"dropout": key}))
    keep = np.asarray(dp.apply({}, jnp.ones((16, 1, 1)), deterministic=False,
                               rngs={"dropout": key})) > 0
    assert 0 < keep.sum() < 16
    monkeypatch.setattr(port.torch, "rand", lambda *a, **k: torch.from_numpy(
        np.where(keep, 0.0, 1.0).astype(np.float32)))
    got = port.DropPath(0.5).train()(t(x))
    assert relerr(got.numpy(), want) <= 1e-7
    assert torch.equal(port.DropPath(0.5).eval()(t(x)), t(x))


class _JaxBackbone(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return [fnn.Conv(8, (2, 2), strides=(2, 2), padding="VALID",
                         name="conv")(x)]


def test_hybrid_embed_matches_jax():
    """A stride-2 conv backbone (8 channels, 8 x 8 map; it returns a list,
    the last map is used) under the hybrid input stage."""
    images = _images(6)
    kw = dict(SMALL, hybrid_feature_size=(8, 8))
    jm = ref.VisionTransformer(hybrid_backbone=_JaxBackbone(), **kw)
    params = noise_tree(shapes(jm, images, SEQLEN), 7)["params"]
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, SEQLEN))(
        params, images)
    backbone = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 2, 2))
    tm = port.VisionTransformer(hybrid_backbone=backbone,
                                hybrid_feature_dim=8, device="cpu", **kw)
    conv = params["hybrid_backbone"]["conv"]
    state = vit_state_dict(params)
    state["patch_embed.backbone.0.weight"] = t(
        np.transpose(conv["kernel"], (3, 2, 0, 1)))
    state["patch_embed.backbone.0.bias"] = t(conv["bias"])
    loaded(tm, state)
    with torch.no_grad():
        got = tm(t(images).permute(0, 3, 1, 2), SEQLEN)
    assert tm.patch_embed.num_patches == 64
    assert relerr(got.numpy(), want) <= TOL


FACTORIES = ["vit_small_patch16_224", "vit_base_patch16_224",
             "vit_base_patch16_384", "vit_base_patch32_384",
             "vit_large_patch16_224", "vit_large_patch16_384",
             "vit_large_patch32_384", "vit_huge_patch16_224",
             "vit_huge_patch32_384"]


@pytest.mark.parametrize("name", FACTORIES)
def test_factory_geometry_matches_jax(name):
    """Each factory's width, depth, heads, MLP width, qkv bias, norm eps,
    image and patch size (the port built on the meta device, allocating
    nothing)."""
    j = getattr(ref, name)()
    with torch.device("meta"):
        m = getattr(port, name)(device="meta")
    blk = m.blocks[0]
    assert len(m.blocks) == j.depth
    assert m.embed_dim == j.embed_dim
    assert blk.attn.num_heads == j.num_heads
    assert blk.mlp.fc1.out_features == int(j.embed_dim * j.mlp_ratio)
    assert (blk.attn.qkv.bias is not None) == j.qkv_bias
    assert blk.norm1.eps == m.norm.eps == j.norm_eps
    assert m.patch_embed.proj.kernel_size == (j.patch_size, j.patch_size)
    assert m.patch_embed.img_size == j.img_size
    assert m.pos_embed.shape[1] == (j.img_size // j.patch_size) ** 2 + 1
