"""The port's dtype gate and the facts its attention tiles rely on, on the
CPU.

  * The dtype gate (``ops.cuda_common.kernel_route``): the kernels take
    bf16 only, so float32 compute on the card takes every module's plain
    route, decided before any launch, and bf16 takes the kernel routes.
    There is no card here, so the tests take every tensor for one on the
    card (``on_card`` patched) and count the calls of the kernel wrappers
    the modules make, as ``tests/test_torch_md_routes.py`` does.  The
    float32 plain route agrees with the wrapper route (each wrapper's plain
    version on a CPU tensor) within 1e-5.
  * ``md_stack`` raises at construction for float32 compute on the card;
    ``build_system`` hands float32 to ``from_cfg`` for the unmodified
    published stage-1 configuration and a ``cuda`` device, and no longer
    raises.
  * What the attention tiles of kernels 10 and 12 rely on, on the port's
    plain versions within 1e-6 and on the JAX package's
    ``masked_attention`` (and its Pallas kernel in interpret mode): (a) a
    key tile in which every key is masked changes nothing, forward or
    gradient, when the sample has a valid key; (b) a sample with no valid
    key attends uniformly over all its keys.  The dropout case uses fixed
    masks.
"""
import copy
import functools
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_modules import relerr, rnd, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACT_TOL = 1e-6   # the facts hold exactly up to float32 rounding
ROUTE_TOL = 1e-5  # the same float32 function through two routes
JAX_TOL = 1e-4    # float32 on both sides, sums in another order
D, H, FF = 64, 4, 128
TILE = 64  # the attention tiles' key tile


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


@pytest.fixture
def card(monkeypatch):
    """Every tensor is taken for one on the card by the route gates (the
    wrappers still dispatch on the real device: their plain versions)."""
    from ladiff_torch.ops import cuda_common
    monkeypatch.setattr(cuda_common, "on_card", lambda device: True)


@pytest.fixture
def calls(monkeypatch):
    """Counts the kernel wrappers' calls from the modules that pick routes."""
    from ladiff_torch.models import clip_text
    from ladiff_torch.ops import attention, stylization, transformer
    counts = {}
    for mod, names in (
            (transformer, ("train_encoder_layer", "train_decoder_layer",
                           "train_self_attention", "train_postnorm_ffn",
                           "fused_postnorm_ffn", "fused_decoder_layer")),
            (attention, ("fused_masked_attention",)),
            (stylization, ("fused_md_layer", "fused_md_stack",
                           "fused_stylized_ffn", "fused_broadcast_stylize")),
            (clip_text, ("fused_ln_qkv", "fused_proj_mlp"))):
        for name in names:
            def wrapped(*a, _fn=getattr(mod, name), _name=name, **k):
                counts[_name] = counts.get(_name, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, wrapped)
    return counts


def test_kernel_compute_gate():
    """bf16 takes the kernels anywhere; float32 only off the card, where
    every wrapper is its plain version."""
    from ladiff_torch.ops.cuda_common import kernel_compute, kernel_route
    assert kernel_compute(torch.bfloat16, "cuda")
    assert not kernel_compute(torch.float32, "cuda")
    assert not kernel_compute(torch.float32, torch.device("cuda", 0))
    assert kernel_compute(torch.float32, "cpu")
    assert kernel_compute(torch.bfloat16, "cpu")
    assert kernel_route(torch.zeros(2))


def _layers(seed):
    from ladiff_torch.ops.transformer import (TransformerDecoderLayer,
                                              TransformerEncoderLayer)
    torch.manual_seed(seed)
    return (TransformerEncoderLayer(D, H, FF, "gelu", whole_layer=True),
            TransformerEncoderLayer(D, H, FF, "gelu"),
            TransformerDecoderLayer(D, H, FF, "gelu", whole_layer=True),
            TransformerDecoderLayer(D, H, FF, "gelu"))


# (layer index, mode) -> the wrappers a bf16 call makes
_BF16_CALLS = {
    (0, "eval"): {"fused_masked_attention": 1, "fused_postnorm_ffn": 1},
    (0, "train"): {"train_encoder_layer": 1},
    (1, "train"): {"train_self_attention": 1, "train_postnorm_ffn": 1},
    (2, "eval"): {"fused_decoder_layer": 1},
    (2, "train"): {"train_decoder_layer": 1},
    (3, "train"): {"train_self_attention": 1, "train_postnorm_ffn": 1},
}


@pytest.mark.parametrize("case", sorted(_BF16_CALLS))
def test_transformer_layers_route_by_dtype(card, calls, monkeypatch, case):
    """Encoder and decoder layers, inference and training (whole-layer and
    split): float32 on the card calls no wrapper and agrees with the
    wrapper route; bf16 calls the kernels' wrappers."""
    from ladiff_torch.ops import cuda_common
    index, mode = case
    layer = _layers(3)[index].train(mode == "train")
    rng = np.random.RandomState(4)
    S, L = 64, 3
    x, mem = t(rnd(rng, 2, S, D, scale=0.5)), t(rnd(rng, 2, L, D))
    kv = t(np.arange(S)[None] < np.array([[S], [20]]))
    mv = t(np.arange(L)[None] < np.array([[L], [1]]))
    args = (x, mem, kv, mv) if index >= 2 else (x, kv)
    with torch.set_grad_enabled(mode == "train"):
        got = layer(*args)
        assert calls == {}
        copy.deepcopy(layer).to(torch.bfloat16)(
            *[a.to(torch.bfloat16) if a.is_floating_point() else a
              for a in args])
        assert calls == _BF16_CALLS[case]
        calls.clear()
        # the same float32 function through the wrappers (plain on a CPU
        # tensor)
        monkeypatch.setattr(cuda_common, "on_card", lambda device: False)
        want = layer(*args)
    assert calls == _BF16_CALLS[case]
    assert relerr(got.detach(), want.detach().numpy()) <= ROUTE_TOL


@pytest.mark.parametrize("heads", [4, 1])
def test_md_layer_routes_by_dtype(card, calls, monkeypatch, heads):
    """The MD layer at inference: float32 runs the plain per-block route;
    bf16 runs K1 (4 heads) or, at head width 256 which K1 refuses, kernel
    5's tail, kernel 7 and kernel 6 per block."""
    from ladiff_torch.ops import cuda_common
    from ladiff_torch.ops.stylization import MDTransformerLayer
    d = 256 if heads == 1 else D
    torch.manual_seed(5)
    # at width 256 an FFN width kernel 6 takes: a multiple of D
    layer = MDTransformerLayer(d, d, FF if heads == 4 else d, heads).eval()
    rng = np.random.RandomState(6)
    x, xf, emb = (t(rnd(rng, *s)) for s in ((2, 5, d), (2, 1, d), (2, d)))
    lv = t(np.arange(5)[None] < np.array([[5], [2]]))
    with torch.no_grad():
        got = layer(x, xf, emb, lv)
        assert calls == {}
        want_calls = ({"fused_md_layer": 1} if heads == 4 else
                      {"fused_postnorm_ffn": 1, "fused_broadcast_stylize": 1,
                       "fused_stylized_ffn": 1})
        copy.deepcopy(layer).to(torch.bfloat16)(
            *(a.to(torch.bfloat16) for a in (x, xf, emb)), lv)
        assert calls == want_calls
        monkeypatch.setattr(cuda_common, "on_card", lambda device: False)
        want = layer(x, xf, emb, lv)
    assert relerr(got, want.numpy()) <= ROUTE_TOL


def test_clip_layer_routes_by_dtype(card, calls):
    """A CLIP layer: float32 runs K3's and K4's plain versions, bf16 their
    wrappers."""
    from ladiff_torch.models.clip_text import CLIPTextLayer
    torch.manual_seed(7)
    layer = CLIPTextLayer(D, H)
    x = torch.randn(2, 8, D)
    causal = torch.ones(8, 8, dtype=torch.bool).tril()
    with torch.no_grad():
        layer(x, causal)
        assert calls == {}
        layer.to(torch.bfloat16)(x.to(torch.bfloat16), causal)
    assert calls == {"fused_ln_qkv": 1, "fused_proj_mlp": 1}


def test_md_stack_refuses_float32_on_the_card():
    """``md_stack`` (kernel 11, bf16 only) raises at construction for
    float32 compute on the card, before any device is touched."""
    from ladiff_torch.models.ladiff import LADiffSystem
    with pytest.raises(ValueError, match="md_stack"):
        LADiffSystem(nfeats=263, njoints=22, latent_dim=(1, D), ff_size=FF,
                     num_layers=3, num_heads=H, md_stack=True,
                     device="cuda", dtype=torch.float32)


def test_build_system_takes_the_published_config_in_float32(monkeypatch):
    """The unmodified ``config_vae_humanml3d.yaml`` (``MIXED_PRECISION``
    false) on a ``cuda`` device: float32 compute and parameters handed to
    ``from_cfg``, no refusal."""
    from ladiff_torch.config import assemble_config
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.training import loop
    cfg = assemble_config(
        os.path.join(REPO, "configs", "config_vae_humanml3d.yaml"),
        os.path.join(REPO, "configs", "assets.yaml"))
    assert not cfg.TRAIN.MIXED_PRECISION
    seen = {}
    monkeypatch.setattr(loop, "resolve_device", torch.device)
    monkeypatch.setattr(LADiffSystem, "from_cfg",
                        classmethod(lambda cls, c, **kw: seen.update(kw)))
    dm = types.SimpleNamespace(nfeats=263, njoints=22, mean=None, std=None)
    loop.build_system(cfg, dm, device="cuda")
    assert seen["device"] == torch.device("cuda")
    assert seen["dtype"] == torch.float32
    assert seen["param_dtype"] == torch.float32


# -- what the attention tiles rely on ----------------------------------------

S = 80  # two key tiles: keys 0..63 and 64..79


def _valid():
    """Sample 0: the encoder stream's layout, valid keys not a prefix (2 of
    the 10 distribution tokens at 0, 1 and 5, 6, then 11 frames), so the
    second key tile is wholly masked; sample 1: no valid key."""
    v = np.zeros((2, S), bool)
    v[0, [0, 1, 5, 6]] = True
    v[0, 10:21] = True
    return v


def _fixed_pm(rng, B, heads, rate=0.1):
    keep = rng.rand(B, heads, S, S) >= rate
    return (keep / (1.0 - rate)).astype(np.float32)


def test_masked_tile_and_no_valid_key_masked_attention(interpret):
    """(a) and (b) on ``masked_attention_plain``, the JAX package's
    ``masked_attention`` and its Pallas kernel (interpret mode): dropping
    the masked key tile leaves sample 0's output and its q, k, v gradients
    unchanged, and the tile's keys get zero gradients; sample 1 attends
    uniformly."""
    from ladiff_torch.ops.attention_kernel import masked_attention_plain
    from ladiff_tpu.ops.attention import masked_attention as jax_attention
    from ladiff_tpu.ops.pallas_attention import pallas_masked_attention
    rng = np.random.RandomState(8)
    q, k, v = (rnd(rng, 2, S, D) for _ in range(3))
    valid = _valid()
    jargs = tuple(map(jnp.asarray, (q, k, v, valid)))
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    got = masked_attention_plain(tq, tk, tv, t(valid), num_heads=H)
    for want in (jax_attention(*jargs, num_heads=H),
                 pallas_masked_attention(*jargs, num_heads=H)):
        want = np.asarray(want)
        assert relerr(got.detach(), want) <= JAX_TOL
        # (b) in the JAX functions: the mean of the sample's values
        mean = v[1].reshape(S, H, -1).mean(0).reshape(1, D)
        assert relerr(torch.tensor(want[1]),
                      np.broadcast_to(mean, (S, D))) <= FACT_TOL
    # (a): the first tile alone gives sample 0 the same output and
    # gradients; the masked tile's keys get none
    dout = t(rnd(rng, 2, S, D))
    dq, dk, dv = torch.autograd.grad(got, (tq, tk, tv), dout,
                                     retain_graph=True)
    sq, sk, sv = (t(a[:1, :TILE]).requires_grad_(True) for a in (q, k, v))
    alone = masked_attention_plain(sq, sk, sv, t(valid[:1, :TILE]),
                                   num_heads=H)
    assert relerr(got[:1, :TILE].detach(), alone.detach().numpy()) \
        <= FACT_TOL
    # gradients: dout on the first tile's rows only
    dout0 = torch.zeros_like(dout)
    dout0[0, :TILE] = dout[0, :TILE]
    g0 = torch.autograd.grad(got, (tq, tk, tv), dout0)
    ga = torch.autograd.grad(alone, (sq, sk, sv), dout[:1, :TILE])
    for full, part in zip(g0, ga):
        assert relerr(full[:1, :TILE], part.numpy()) <= FACT_TOL
    assert float(g0[1][0, TILE:].abs().max()) == 0.0
    assert float(g0[2][0, TILE:].abs().max()) == 0.0
    assert float(dk[0, TILE:].abs().max()) == 0.0
    assert float(dv[0, TILE:].abs().max()) == 0.0
    # (b) on the port's plain version
    mean = t(v[1]).reshape(S, H, -1).mean(0).reshape(1, D)
    assert relerr(got[1].detach(), mean.expand(S, D).numpy()) <= FACT_TOL
    assert dq.shape == tq.shape


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_masked_tile_and_no_valid_key_train_attention(rate):
    """(a) and (b) on ``train_self_attention``'s plain forward and backward,
    with fixed masks at rate 0.1: sample 0 over the first key tile alone
    gives the same output rows and gradients when the rows past it carry
    no upstream gradient; sample 1, with no valid key, attends uniformly
    (before the probability dropout)."""
    from ladiff_torch.ops.train_attention import (
        train_self_attention_bwd_plain, train_self_attention_plain)
    rng = np.random.RandomState(9)
    p = {"in_w": t(rnd(rng, 3 * D, D, scale=D ** -0.5)),
         "in_b": t(rnd(rng, 3 * D, scale=0.05)),
         "out_w": t(rnd(rng, D, D, scale=D ** -0.5)),
         "out_b": t(rnd(rng, D, scale=0.05))}
    valid = _valid()
    x = t(rnd(rng, 2 * S, D))
    kv = t(valid.reshape(2 * S).astype(np.float32))
    pm = rm = None
    if rate:
        pm = t(_fixed_pm(rng, 2, H, rate))
        rm = t((rng.rand(2 * S, D) >= rate) / (1.0 - rate)).float()
    out = train_self_attention_plain(x, kv, p, (pm, rm), H=H, S=S)
    # sample 0 over its first key tile alone (one sample of TILE rows)
    x0, kv0 = x[:TILE], kv[:TILE]
    pm0 = None if pm is None else pm[:1, :, :TILE, :TILE].contiguous()
    rm0 = None if rm is None else rm[:TILE]
    alone = train_self_attention_plain(x0, kv0, p, (pm0, rm0), H=H, S=TILE)
    assert relerr(out[:TILE], alone.numpy()) <= FACT_TOL
    dout = torch.zeros(2 * S, D)
    dout[:TILE] = t(rnd(rng, TILE, D))
    dx, g = train_self_attention_bwd_plain(x, kv, dout, p, (pm, rm), H=H,
                                           S=S)
    # no upstream gradient past the tile nor in sample 1: their rows get
    # none through the attention either (the masked keys' p is 0)
    dx0, g0 = train_self_attention_bwd_plain(x0, kv0, dout[:TILE], p,
                                             (pm0, rm0), H=H, S=TILE)
    assert relerr(dx[:TILE], dx0.numpy()) <= FACT_TOL
    assert float((dx[TILE:S]).abs().max()) == 0.0
    for name in g:
        assert relerr(g[name], g0[name].numpy()) <= FACT_TOL, name
    # (b): with no dropout the output is x + mean(v) Wout^T + bout
    if rate == 0.0:
        v1 = torch.nn.functional.linear(x[S:], p["in_w"][2 * D:],
                                        p["in_b"][2 * D:])
        want = x[S:] + torch.nn.functional.linear(
            v1.mean(0, keepdim=True).expand(S, D), p["out_w"], p["out_b"])
        assert relerr(out[S:], want.numpy()) <= FACT_TOL
