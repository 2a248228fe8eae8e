"""The demo's other tasks and options in the PyTorch port against the JAX
package on the CPU: the decoder's cross-attention weights
(``LAVae.decode(return_cross_weights=True)``, the per-block route); the
root ``demo.py``'s ``_generate_once`` for ``random_latent`` (with
``--latentwise_gen fw`` and ``bw``) and ``reconstruction``, the JAX draws
handed to the port; and ``ladiff_torch.demo.main`` for each task and
option, its files and attention maps included, at a small size.

Sizes: d 128, 2 heads, 3 layers, MAX_IT 3, 64 frames.  Tolerance 1e-4
norm-wise for the features, weights and joints (float32 on both sides, no
sampler in these paths).
"""
import importlib.util
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.config import ConfigNode
from ladiff_torch.convert import system_state_dict
from test_torch_md_routes import layer_calls  # noqa: F401 (fixture)
from test_torch_slice import randomize, relerr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFEATS, T, D, M, TOL = 263, 64, 128, 3, 1e-4
LENGTHS = np.array([64, 40, 9], np.int32)


@pytest.fixture(scope="module")
def systems():
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    kw = dict(nfeats=NFEATS, njoints=22, max_frames=T, latent_dim=(7, D),
              ff_size=256, num_layers=3, num_heads=2, max_it=M,
              frame_per_latent=24)
    mean = (0.1 * np.random.RandomState(3).randn(NFEATS)).astype(np.float32)
    std = (0.5 + np.random.RandomState(4).rand(NFEATS)).astype(np.float32)
    jsys = JaxSystem(dropout=0.0, mean=jnp.asarray(mean),
                     std=jnp.asarray(std), **kw)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), 1)
    tsys = TorchSystem(mean=mean, std=std, device="cpu", **kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    return jsys, params, tsys


def test_decode_with_weights_matches_jax(systems, layer_calls):
    """Each decoder layer's head-averaged cross-attention weights [B, T,
    MAX_IT] and the features against the JAX decode's; a masked latent's
    weight is 0; asking for weights runs the layers per block (kernel 10's
    and kernel 5's wrappers, not K2's), not asking runs K2's."""
    jsys, params, tsys = systems
    z = np.random.RandomState(5).randn(3, M, D).astype(np.float32)
    feats_j, weights_j = jsys.vae.apply(
        {"params": params["vae"]}, jnp.asarray(z), jnp.asarray(LENGTHS),
        nframes=T, return_cross_weights=True, method=jsys.vae.decode)
    lengths = torch.from_numpy(LENGTHS.astype(np.int64))
    with torch.no_grad():
        feats_t, weights_t = tsys.vae.decode(torch.from_numpy(z), lengths, T,
                                             return_cross_weights=True)
    assert layer_calls == {"fused_masked_attention": 3,
                           "fused_postnorm_ffn": 3}
    assert len(weights_t) == len(weights_j) == 3
    assert relerr(feats_t.numpy(), feats_j) <= TOL
    for wt, wj in zip(weights_t, weights_j):
        assert wt.shape == (3, T, M)
        assert relerr(wt.numpy(), wj) <= TOL
        assert not wt[2, :, 1:].any()  # 9 frames: one active latent of 3
        torch.testing.assert_close(wt.sum(-1), torch.ones(3, T))
    layer_calls.clear()
    with torch.no_grad():
        plain = tsys.vae.decode(torch.from_numpy(z), lengths, T)
    assert layer_calls == {"fused_decoder_layer": 3}
    assert torch.equal(plain, feats_t)


def _jax_demo():
    """The root ``demo.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "ladiff_tpu_demo_entry", os.path.join(REPO, "demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("task,latentwise", [
    ("random_latent", "fw"), ("random_latent", "bw"),
    ("reconstruction", None)])
def test_generate_once_matches_jax(systems, tmp_path, monkeypatch, task,
                                   latentwise):
    """``_generate_once``: z ~ N(0, I) masked per length, or the encoded
    clip; with ``latentwise`` each sample MAX_IT times under progressive
    latent masks; decoded and taken to joints, against the JAX demo's with
    its draw handed to the port."""
    from ladiff_torch import demo
    jsys, params, tsys = systems
    example = str(tmp_path / "clip.txt")
    np.save(str(tmp_path / "clip.npy"), (0.5 * np.random.RandomState(6).randn(
        50, NFEATS)).astype(np.float32))
    cfg = ConfigNode({"DEMO": {"EXAMPLE": example, "PLOT_ATT_MAP": False},
                      "FOLDER_EXP": str(tmp_path)})
    texts = ["a", "b", "c"]
    pairs = list(zip(LENGTHS.tolist(), texts))
    rng = jax.random.PRNGKey(8)
    logger = logging.getLogger("demo_test")
    joints_j, texts_j, lengths_j = _jax_demo()._generate_once(
        cfg, jsys, params, rng, None, None, texts, jnp.asarray(LENGTHS),
        pairs, task, latentwise, logger)
    shape = (1, M, D) if task == "reconstruction" else (3, M, D)
    draw = torch.from_numpy(np.array(jax.random.normal(rng, shape)))
    monkeypatch.setattr(torch, "randn", lambda *a, **k: draw)
    joints_t, texts_t, lengths_t = demo._generate_once(
        cfg, tsys, None, None, None, texts,
        torch.from_numpy(LENGTHS.astype(np.int64)), task, latentwise, logger)
    n = (1 if task == "reconstruction" else 3) * (M if latentwise else 1)
    assert joints_t.shape == (n, T, 22, 3) == np.shape(joints_j)
    assert texts_t == texts_j and len(texts_t) == n
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
    assert relerr(joints_t, joints_j) <= TOL


def _demo(tmp_path, *args, cfg="config_ladiff_humanml3d.yaml", **over):
    from ladiff_torch import demo
    from test_torch_entry import _small_overrides, _text_encoder
    over.setdefault("model", {"scheduler": {"num_inference_timesteps": 2}})
    o = _small_overrides(tmp_path, **over)
    return demo.main(["--cfg", os.path.join(REPO, "configs", cfg), "--cpu",
                      *args], text_encoder=_text_encoder, overrides=o)


def _files(out, n, length=None):
    for i in range(n):
        joints = np.load(os.path.join(out, f"sample_{i:03d}.npy"))
        assert joints.shape[1:] == (22, 3) and np.isfinite(joints).all()
        if length is not None:
            assert len(joints) == length
        assert os.path.exists(os.path.join(out, f"sample_{i:03d}.txt"))
    assert not os.path.exists(os.path.join(out, f"sample_{n:03d}.npy"))


def test_demo_main_runs_every_task_and_option(tmp_path):
    """``python -m ladiff_torch.demo`` on the CPU: ``random_latent`` with
    ``--plot_att_map`` (one PNG per decoder layer), ``reconstruction`` of
    the clip beside the example, ``--latentwise_gen fw`` on
    ``text_motion`` and ``bw`` on ``random_latent`` (MAX_IT samples per
    line), the latentwise refusal with ``--replication``, and the novae
    configuration's ``text_motion`` (no VAE: the sampled frames are the
    features; the decoding options refuse it)."""
    from ladiff_torch import demo
    n = len(demo.DEFAULT_EXAMPLES)
    out = _demo(tmp_path, "--task", "random_latent", "--plot_att_map",
                "--out_dir", str(tmp_path / "att"), NAME="att")
    _files(out, n)
    att = os.path.join(str(tmp_path), "experiments", "ladiff", "att",
                       "att_maps")
    assert sorted(os.listdir(att)) == [f"block_{i}.png" for i in range(3)]

    with open(tmp_path / "clip.txt", "w") as f:
        f.write("120 a person walks\n")
    np.save(str(tmp_path / "clip.npy"), np.zeros((120, NFEATS), np.float32))
    out = _demo(tmp_path, "--task", "reconstruction", "--example",
                str(tmp_path / "clip.txt"), "--out_dir",
                str(tmp_path / "recon"))
    _files(out, 1, length=120)
    assert open(os.path.join(out, "sample_000.txt")).read() == \
        "reconstruction\n"

    for task, mode in (("text_motion", "fw"), ("random_latent", "bw")):
        out = _demo(tmp_path, "--task", task, "--latentwise_gen", mode,
                    "--out_dir", str(tmp_path / f"lw_{mode}"))
        _files(out, 5 * n)
        texts = [open(os.path.join(out, f"sample_{i:03d}.txt")).read()
                 for i in range(5 * n)]
        assert texts == [t + "\n" for _, t in demo.DEFAULT_EXAMPLES
                         for _ in range(5)]
    with pytest.raises(SystemExit, match="latentwise"):
        _demo(tmp_path, "--latentwise_gen", "fw", "--replication", "2")

    layers = {"params": {"num_layers": 3}}
    novae = dict(cfg="config_novae_humanml3d.yaml",
                 model={"latent_dim": [1, 64], "motion_vae": layers,
                        "denoiser": layers,
                        "scheduler": {"num_inference_timesteps": 2}})
    out = _demo(tmp_path, "--out_dir", str(tmp_path / "novae"), **novae)
    for i, (length, _) in enumerate(demo.DEFAULT_EXAMPLES):
        joints = np.load(os.path.join(out, f"sample_{i:03d}.npy"))
        assert joints.shape == (length, 22, 3) and np.isfinite(joints).all()
    with pytest.raises(NotImplementedError, match="has no VAE"):
        _demo(tmp_path, "--task", "random_latent", **novae)
