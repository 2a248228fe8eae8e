"""The PyTorch port's generation slice against the JAX package, end to end,
on the CPU: the same converted weights and the same initial noise through
``LADiffSystem.generate``; plus the weight converter, import hygiene and
the device default."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
from ladiff_torch.convert import system_state_dict
from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem

# Under pytest-xdist every worker process collects every test module, so
# this runs in each worker before its first test: torch's intra-op threads
# are capped at the machine's cores over the workers.  Left at every core
# per worker, N workers' OpenMP teams oversubscribe the CPU, and the port's
# test files ran four to five times as long as with the cap.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

D, HEADS, FF, LAYERS, NFEATS, NJOINTS, FRAMES = 128, 2, 256, 3, 263, 22, 196
STEPS, GUIDANCE = 5, 7.5
LENGTHS = np.array([16, 100, 196], np.int32)


def relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def randomize(tree, seed):
    """Non-trivial numpy params of the tree's shapes (the zero-init
    projections would otherwise hide whole segments)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = str(path[-1].key)
        shape = np.shape(a)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name in ("bias", "in_proj_bias"):
            return (0.05 * rng.randn(*shape)).astype(np.float32)
        if name == "pe":
            return rng.rand(*shape).astype(np.float32)
        fan_in = shape[0] if len(shape) == 2 else 1
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _systems():
    kw = dict(nfeats=NFEATS, njoints=NJOINTS, max_frames=FRAMES,
              latent_dim=(7, D), ff_size=FF, num_layers=LAYERS,
              num_heads=HEADS, guidance_scale=GUIDANCE,
              num_inference_timesteps=STEPS)
    mean = np.random.RandomState(3).randn(NFEATS).astype(np.float32) * 0.1
    std = np.abs(np.random.RandomState(4).randn(NFEATS)).astype(
        np.float32) + 0.5
    jsys = JaxSystem(dropout=0.0, mean=jnp.asarray(mean),
                     std=jnp.asarray(std), **kw)
    params = randomize(jsys.init_params(jax.random.PRNGKey(0)), 1)
    tsys = TorchSystem(mean=mean, std=std, device="cpu", **kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    return jsys, params, tsys


def test_converter_loads_strict_and_names_match_reference():
    _, params, tsys = _systems()
    sd = system_state_dict(params)
    assert set(sd) == set(tsys.state_dict())
    for key in ("denoiser.encoder.input_blocks.0.sa_block.self_attn."
                "in_proj_weight",
                "denoiser.encoder.middle_block.ca_block.proj_out."
                "emb_layers.1.weight",
                "denoiser.emb_proj.1.weight", "denoiser.query_pos.pe",
                "vae.decoder.output_blocks.0.multihead_attn.in_proj_weight",
                "vae.global_motion_token"):
        assert key in sd, key
    assert sd["denoiser.query_pos.pe"].shape == (500, 1, D)
    assert sd["vae.decoder.middle_block.self_attn.in_proj_weight"].shape \
        == (3 * D, D)


def test_generate_matches_jax():
    """B = 3 with lengths {16, 100, 196}, CFG 7.5 DDIM-5, float32 on both
    sides.  Tolerance 2e-3 norm-wise: both packages compute the same math
    in float32, but sums run in another order, and 5 guided steps (each
    amplifying the eps difference by the guidance scale) plus 3+3 layers
    of products accumulate ~1e-6 rounding into ~1e-5..1e-4; 2e-3 leaves
    room for BLAS differences and still catches any wrong mask or term."""
    jsys, params, tsys = _systems()
    B = len(LENGTHS)
    rng = np.random.RandomState(7)
    cond = rng.randn(B, 1, 768).astype(np.float32)
    uncond = rng.randn(B, 1, 768).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(11)
    feats_j, z_j = jsys.generate(params, jnp.asarray(cond),
                                 jnp.asarray(uncond), jnp.asarray(LENGTHS),
                                 key, nframes=FRAMES)
    joints_j = jsys.feats2joints(feats_j)
    init = jax.random.normal(jax.random.split(key)[0], (B, 5, D),
                             jnp.float32)
    feats_t, z_t = tsys.generate(torch.from_numpy(cond),
                                 torch.from_numpy(uncond),
                                 torch.from_numpy(LENGTHS.astype(np.int64)),
                                 nframes=FRAMES,
                                 init_latents=torch.tensor(
                                     np.asarray(init)))
    joints_t = tsys.feats2joints(feats_t)
    assert feats_t.shape == (B, FRAMES, NFEATS)
    assert joints_t.shape == (B, FRAMES, NJOINTS, 3)
    assert np.isfinite(feats_t.numpy()).all()
    assert relerr(z_t.numpy(), z_j) <= 2e-3
    assert relerr(feats_t.numpy(), feats_j) <= 2e-3
    assert relerr(joints_t.numpy(), joints_j) <= 2e-3
    # padded frames are exactly zero
    assert not feats_t[0, LENGTHS[0]:].any()


def test_port_imports_no_jax():
    """Every module of the port imports without jax, flax or ladiff_tpu."""
    code = (
        "import pkgutil, importlib, sys, ladiff_torch\n"
        "for m in pkgutil.walk_packages(ladiff_torch.__path__, "
        "'ladiff_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ladiff_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('ladiff_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 20


def test_entry_points_default_to_the_gpu():
    """Without ``device`` the entry points ask for CUDA; with no GPU they
    raise instead of running on the CPU."""
    from ladiff_torch.models.clip_text import ClipTextEncoder
    from ladiff_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchSystem(nfeats=NFEATS, njoints=NJOINTS, latent_dim=(7, D),
                    ff_size=FF, num_layers=LAYERS, num_heads=HEADS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClipTextEncoder()


def test_dtype_defaults_to_the_kernels_type():
    """bfloat16 on CUDA, the kernels' only type, and float32 on the CPU;
    float32 on CUDA is the plain routes' type (the published
    configurations'); another type on CUDA raises, naming it, before any
    launch."""
    from ladiff_torch.utils.device import resolve_dtype

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_dtype(cuda) == torch.bfloat16
    assert resolve_dtype(cuda, torch.bfloat16) == torch.bfloat16
    assert resolve_dtype(cpu) == torch.float32
    assert resolve_dtype(cpu, torch.bfloat16) == torch.bfloat16
    assert resolve_dtype(cuda, torch.float32) == torch.float32
    with pytest.raises(TypeError, match="torch.float16"):
        resolve_dtype(cuda, torch.float16)
    system = TorchSystem(nfeats=NFEATS, njoints=NJOINTS, latent_dim=(7, D),
                         ff_size=FF, num_layers=LAYERS, num_heads=HEADS,
                         device="cpu")
    assert system.vae.final_layer.weight.dtype == torch.float32
