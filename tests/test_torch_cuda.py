"""The port's CUDA kernels K1..K4 against their plain PyTorch versions, on
an NVIDIA GPU (marked ``cuda``; skipped where there is none).  Imports no
JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda [--noconftest]

(``--noconftest`` where JAX is not installed: tests/conftest.py sets JAX up.)

Inputs are bf16 with mixed lengths; the plain version runs in float32 on
the same inputs.  Tolerance 2e-2 norm-wise: bf16 operands (2^-9 rounding)
through a layer's ~6 chained products, LayerNorms and softmaxes.
"""
import math

import numpy as np
import pytest
import torch

TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.dim() >= 2:
                r = r / math.sqrt(p.shape[-1])
            elif "norm" in name and name.endswith("weight"):
                r = 1.0 + 0.1 * r
            else:
                r = 0.05 * r
            p.copy_(r)
    return module


def _relerr(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _mask(lengths, n, dev):
    lengths = torch.as_tensor(lengths)
    return (torch.arange(n)[None] < lengths[:, None]).float().to(dev)


def _f32(p):
    return {k: v.float() for k, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shared_rows", [True, False])
@torch.no_grad()
def test_md_layer_kernel(dev, shared_rows):
    from ladiff_torch.ops.md_layer import fused_md_layer, md_layer_plain
    from ladiff_torch.ops.stylization import MDTransformerLayer
    D, H, T, E, B = 256, 4, 5, 2, 37  # B: a partial last sample block
    layer = _randomize(MDTransformerLayer(D, D, 1024, H), 1).to(dev,
                                                                torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    bf = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    rows = 1 if shared_rows else B
    kvalid = _mask(np.random.RandomState(3).randint(1, T + 1, B), T, dev)
    args = (bf(B * T, D), bf(B * E, D), kvalid.reshape(-1).contiguous(),
            bf(B, D), 0.3 * bf(rows, 2 * D), 0.3 * bf(rows, 2 * D))
    p = layer.kernel_params()
    got = fused_md_layer(*args, p, T=T, E=E, H=H)
    want = md_layer_plain(*[a.float() for a in args], _f32(p), T=T, E=E, H=H)
    assert _relerr(got, want) <= TOL


@pytest.mark.cuda
@torch.no_grad()
def test_decoder_layer_kernel(dev):
    from ladiff_torch.ops.decoder_layer import (decoder_layer_plain,
                                                fused_decoder_layer)
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    D, H, T, L = 256, 4, 196, 5
    lengths = np.array([196, 16, 100, 47, 150])
    B = len(lengths)
    layer = _randomize(TransformerDecoderLayer(D, H, 1024, "gelu"), 4).to(
        dev, torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    bf = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    args = (bf(B * T, D), _mask(lengths, T, dev).reshape(-1).contiguous(),
            bf(B, L, D), _mask(-(-lengths // 48), L, dev))
    p = layer.kernel_params()
    got = fused_decoder_layer(*args, p, T=T, H=H)
    want = decoder_layer_plain(*[a.float() for a in args], _f32(p), T=T, H=H)
    assert _relerr(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [16, 32, 77])
@torch.no_grad()
def test_clip_layer_kernels(dev, seq):
    from ladiff_torch.models.clip_text import CLIPTextLayer
    from ladiff_torch.ops.clip_layer import (fused_ln_qkv, fused_proj_mlp,
                                             ln_qkv_plain, proj_mlp_plain)
    W, B = 768, 5
    layer = _randomize(CLIPTextLayer(W, 12), 6).to(dev, torch.bfloat16)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(B * seq, W, generator=g).to(dev, torch.bfloat16)
    att = torch.randn(B * seq, W, generator=g).to(dev, torch.bfloat16)
    pq, pm = layer.qkv_params(), layer.mlp_params()
    for got, want in zip(fused_ln_qkv(x, pq, scale=0.125),
                         ln_qkv_plain(x.float(), _f32(pq), scale=0.125)):
        assert _relerr(got, want) <= TOL
    assert _relerr(fused_proj_mlp(att, x, pm),
                   proj_mlp_plain(att.float(), x.float(), _f32(pm))) <= TOL


@pytest.mark.cuda
def test_kernels_refuse_float32(dev):
    """A CUDA tensor of another type raises; it never takes the plain
    path."""
    from ladiff_torch.ops.clip_layer import fused_proj_mlp
    from ladiff_torch.models.clip_text import CLIPTextLayer
    layer = CLIPTextLayer(128, 2).to(dev)
    x = torch.randn(8, 128, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_proj_mlp(x, x, layer.mlp_params())


@pytest.mark.cuda
def test_default_system_generates_on_the_gpu(dev):
    """The entry point's defaults (device "cuda", bfloat16) run together:
    generation goes through K1 and K2 and gives finite features with the
    padded frames zero."""
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.ops import cuda_common as cc
    system = LADiffSystem(nfeats=263, njoints=22)
    assert system.device.type == "cuda"
    assert system.vae.final_layer.weight.dtype == torch.bfloat16
    g = torch.Generator().manual_seed(8)
    text = torch.randn(2, 1, 768, generator=g)
    cc.reset_launch_counts()
    feats, z = system.generate(
        text, torch.zeros_like(text), torch.tensor([40, 196]),
        generator=torch.Generator(device=dev).manual_seed(0),
        num_inference_timesteps=3)
    counts = cc.launch_counts()
    assert counts["fused_md_layer"] == 3 * 9
    assert counts["fused_decoder_layer"] == 9
    assert feats.shape == (2, 196, 263) and z.shape == (2, 5, 256)
    assert bool(torch.isfinite(feats).all())
    assert not bool(feats[0, 40:].any())
    assert system.feats2joints(feats).shape == (2, 196, 22, 3)
