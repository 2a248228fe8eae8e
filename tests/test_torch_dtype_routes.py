"""The port's dtype gate and the facts its attention tiles rely on, on the
CPU.

  * The dtype gate (``ops.cuda_common.kernel_route(x, kernel)``), per
    kernel: K1, K2, kernels 5, 6, 7, 10 and 11 and the training kernels 8,
    9, 12 and 13 take bf16 and float32, K3 and K4 bf16 only, so float32
    compute on the card runs those eleven where bf16 runs them (eval mode
    and training) and the plain route of CLIP, decided before any launch.
    There is no card here, so the tests take every tensor for one on the
    card (``on_card`` patched) and count the calls of the kernel wrappers
    the modules make, as ``tests/test_torch_md_routes.py`` does. The
    float32 route agrees with the wrapper route (each wrapper's plain
    version on a CPU tensor) within 1e-5.
  * Each published configuration (``from_cfg`` at its published widths,
    batch 2): the wrapper calls of a float32 eval forward on the card's
    routes equal the package's float32 launch tables
    (``ladiff_torch.launch_tables``), which are the bf16 route's calls of
    the kernels that take float32 (the float32 gates take every shape the
    bf16 gates take); the float32 route agrees with the plain route within
    1e-5.  A published training pass calls the training kernels' wrappers
    as the stage-1 and stage-2 tables say.  Generation's other routes
    (the whole stack, full-context text, one text token at head width 256)
    call the wrappers in float32 as their tables say.
  * ``md_stack`` builds for float32 compute on the card and generates
    through kernel 11 once a step, as the plain route and the JAX
    package's ``generate`` do; ``build_system`` hands float32 to
    ``from_cfg`` for the unmodified published stage-1 configuration and a
    ``cuda`` device, and no longer raises.
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


# every kernel wrapper a module's route gate names, and those that take
# float32 (with the training kernels' backwards, by their registered names)
_GATED = ("fused_md_layer", "fused_decoder_layer", "fused_postnorm_ffn",
          "fused_masked_attention", "fused_ln_qkv", "fused_proj_mlp",
          "fused_md_stack", "fused_stylized_ffn", "fused_broadcast_stylize",
          "train_self_attention", "train_postnorm_ffn", "train_encoder_layer",
          "train_decoder_layer")
_FLOAT32 = ("fused_broadcast_stylize", "fused_decoder_layer",
            "fused_masked_attention", "fused_md_layer", "fused_md_stack",
            "fused_postnorm_ffn", "fused_stylized_ffn", "train_decoder_layer",
            "train_decoder_layer_bwd", "train_encoder_layer",
            "train_encoder_layer_bwd", "train_postnorm_ffn",
            "train_postnorm_ffn_bwd", "train_self_attention",
            "train_self_attention_bwd")


@pytest.mark.parametrize("kernel", _GATED)
def test_kernel_compute_gate(kernel):
    """bf16 takes every kernel anywhere; float32 takes K1, K2, kernels 5,
    6, 7, 10 and 11 and the training kernels 8, 9, 12 and 13 on the card
    and every kernel off it, where each wrapper is its plain version; no
    kernel inside ``plain_routes()``."""
    from ladiff_torch.launch_tables import FLOAT32_KERNELS
    from ladiff_torch.ops.cuda_common import (kernel_compute, kernel_route,
                                              plain_routes)
    assert FLOAT32_KERNELS == _FLOAT32
    assert kernel_compute(torch.bfloat16, "cuda", kernel)
    assert kernel_compute(torch.float32, "cuda", kernel) == (
        kernel in _FLOAT32)
    assert kernel_compute(torch.float32, torch.device("cuda", 0),
                          kernel) == (kernel in _FLOAT32)
    assert kernel_compute(torch.float32, "cpu", kernel)
    assert kernel_compute(torch.bfloat16, "cpu", kernel)
    assert kernel_route(torch.zeros(2), kernel)
    with plain_routes():
        assert not kernel_route(torch.zeros(2), kernel)


def _layers(seed):
    from ladiff_torch.ops.transformer import (TransformerDecoderLayer,
                                              TransformerEncoderLayer)
    torch.manual_seed(seed)
    return (TransformerEncoderLayer(D, H, FF, "gelu", whole_layer=True),
            TransformerEncoderLayer(D, H, FF, "gelu"),
            TransformerDecoderLayer(D, H, FF, "gelu", whole_layer=True),
            TransformerDecoderLayer(D, H, FF, "gelu"))


# (layer index, mode) -> the wrappers a bf16 call makes, and a float32 call
# on the card: the same, the inference kernels in eval mode and the
# training kernels in training
_ENCODE = {"fused_masked_attention": 1, "fused_postnorm_ffn": 1}
_SPLIT = {"train_self_attention": 1, "train_postnorm_ffn": 1}
_CALLS = {
    (0, "eval"): (_ENCODE, _ENCODE),
    (1, "eval"): (_ENCODE, _ENCODE),
    (0, "train"): ({"train_encoder_layer": 1}, {"train_encoder_layer": 1}),
    (1, "train"): (_SPLIT, _SPLIT),
    (2, "eval"): ({"fused_decoder_layer": 1}, {"fused_decoder_layer": 1}),
    (3, "eval"): ({"fused_decoder_layer": 1}, {"fused_decoder_layer": 1}),
    (2, "train"): ({"train_decoder_layer": 1}, {"train_decoder_layer": 1}),
    (3, "train"): (_SPLIT, _SPLIT),
}


@pytest.mark.parametrize("case", sorted(_CALLS))
def test_transformer_layers_route_by_dtype(card, calls, monkeypatch, case):
    """Encoder and decoder layers, inference and training (whole-layer and
    split): float32 on the card calls kernel 10 and kernel 5 (encoder) or
    K2 (decoder) in eval mode and kernels 12 and 13, or 8 and 9, in
    training, as bf16 does, and agrees with the wrapper route."""
    from ladiff_torch.launch_tables import float32_launches
    from ladiff_torch.ops import cuda_common
    index, mode = case
    bf16_calls, f32_calls = _CALLS[case]
    assert float32_launches(bf16_calls) == f32_calls
    layer = _layers(3)[index].train(mode == "train")
    rng = np.random.RandomState(4)
    S, L = 64, 3
    x, mem = t(rnd(rng, 2, S, D, scale=0.5)), t(rnd(rng, 2, L, D))
    kv = t(np.arange(S)[None] < np.array([[S], [20]]))
    mv = t(np.arange(L)[None] < np.array([[L], [1]]))
    args = (x, mem, kv, mv) if index >= 2 else (x, kv)
    with torch.set_grad_enabled(mode == "train"):
        got = layer(*args)
        assert calls == f32_calls
        calls.clear()
        copy.deepcopy(layer).to(torch.bfloat16)(
            *[a.to(torch.bfloat16) if a.is_floating_point() else a
              for a in args])
        assert calls == bf16_calls
        calls.clear()
        # the same float32 function through the wrappers (plain on a CPU
        # tensor)
        monkeypatch.setattr(cuda_common, "on_card", lambda device: False)
        want = layer(*args)
    assert calls == bf16_calls
    assert relerr(got.detach(), want.detach().numpy()) <= ROUTE_TOL


@pytest.mark.parametrize("heads", [4, 1])
def test_md_layer_routes_by_dtype(card, calls, monkeypatch, heads):
    """The MD layer at inference: float32 and bf16 run K1 (4 heads); at head
    width 256, which K1 refuses, both run kernel 5's tail, kernel 7 and
    kernel 6 per block."""
    from ladiff_torch.launch_tables import float32_launches
    from ladiff_torch.ops import cuda_common
    from ladiff_torch.ops.stylization import MDTransformerLayer
    d = 256 if heads == 1 else D
    torch.manual_seed(5)
    # at width 256 an FFN width kernel 6 takes: a multiple of D
    layer = MDTransformerLayer(d, d, FF if heads == 4 else d, heads).eval()
    rng = np.random.RandomState(6)
    x, xf, emb = (t(rnd(rng, *s)) for s in ((2, 5, d), (2, 1, d), (2, d)))
    lv = t(np.arange(5)[None] < np.array([[5], [2]]))
    want_calls = ({"fused_md_layer": 1} if heads == 4 else
                  {"fused_postnorm_ffn": 1, "fused_broadcast_stylize": 1,
                   "fused_stylized_ffn": 1})
    f32_calls = ({"fused_md_layer": 1} if heads == 4 else
                 {"fused_postnorm_ffn": 1, "fused_broadcast_stylize": 1,
                  "fused_stylized_ffn": 1})
    assert float32_launches(want_calls) == f32_calls
    with torch.no_grad():
        got = layer(x, xf, emb, lv)
        assert calls == f32_calls
        calls.clear()
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


def _randomize(module, seed):
    """Every parameter random (the zero-init projections too): weights ~
    N(0, 1/fan_in), LayerNorm weights ~ 1 + N(0, 0.1), other vectors ~
    N(0, 0.05)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.dim() >= 2:
                r = r / np.sqrt(p.shape[-1])
            elif "norm" in name and name.endswith("weight"):
                r = 1.0 + 0.1 * r
            else:
                r = 0.05 * r
            p.copy_(r)
    return module


# published configuration -> (nfeats, njoints, dataset overrides, lengths)
_PUBLISHED = {
    "config_ladiff_humanml3d.yaml": (263, 22, {}, [196, 60]),
    "config_ladiff_kit.yaml": (251, 21, {}, [196, 60]),
    "config_novae_humanml3d.yaml": (263, 22, {}, [196, 60]),
    "config_ladiff_humanact12.yaml": (150, 25, {"NCLASSES": 12}, [60, 40]),
    "config_ladiff_uestc.yaml": (150, 25, {"NCLASSES": 40}, [60, 40]),
}
# (denoiser layers, VAE decoder layers) as published
_LAYERS = {"config_ladiff_humanml3d.yaml": (9, 9),
           "config_ladiff_kit.yaml": (9, 9),
           "config_novae_humanml3d.yaml": (9, None),
           "config_ladiff_humanact12.yaml": (15, 6),
           "config_ladiff_uestc.yaml": (9, 9)}
STEPS = 2  # DDIM (DDPM for novae) steps of the generation


def _depth(module, kind):
    """The layers of ``module`` that are ``kind`` ("encoder", "decoder" or
    "md")."""
    from ladiff_torch.ops.stylization import MDTransformerLayer
    from ladiff_torch.ops.transformer import (TransformerDecoderLayer,
                                              TransformerEncoderLayer)
    cls = {"encoder": TransformerEncoderLayer,
           "decoder": TransformerDecoderLayer, "md": MDTransformerLayer}[kind]
    # an MD layer's sa_block is an encoder layer of its own
    md = [m.sa_block for m in module.modules()
          if isinstance(m, MDTransformerLayer)]
    return sum(isinstance(m, cls) and not any(m is b for b in md)
               for m in module.modules())


@pytest.mark.parametrize("name", sorted(_PUBLISHED))
def test_published_configs_float32_launch_tables(card, calls, monkeypatch,
                                                 name):
    """A published configuration at its published widths, batch 2: a
    float32 generation (and, with an LA-VAE, an eval-mode encode) on the
    card's routes calls the wrappers exactly as the package's float32
    tables say, which are the bf16 routes' calls (K1, K2, kernels 5 and 10
    on these routes); it agrees with the plain routes within 1e-5."""
    from ladiff_torch import launch_tables as lt
    from ladiff_torch.config import assemble_config
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.ops import cuda_common
    nfeats, njoints, dataset, lengths = _PUBLISHED[name]
    cfg = assemble_config(os.path.join(REPO, "configs", name),
                          os.path.join(REPO, "configs", "assets.yaml"),
                          {"DATASET": dataset} if dataset else None)
    assert not cfg.TRAIN.MIXED_PRECISION
    system = _randomize(LADiffSystem.from_cfg(
        cfg, nfeats=nfeats, njoints=njoints, device="cpu",
        dtype=torch.float32), 11).eval()
    lengths = torch.tensor(lengths)
    B = len(lengths)
    rng = np.random.RandomState(12)
    if system.condition == "action":
        cond = system.denoiser.embed_action(torch.tensor([1, 3]))
        uncond = torch.zeros_like(cond)
        table = lt.action_generation(
            STEPS, _depth(system.denoiser, "encoder"),
            _depth(system.vae, "decoder"))
    else:
        cond, uncond = (t(rnd(rng, B, 1, 768)) for _ in range(2))
        if system.vae is None:
            table = {k: n * STEPS for k, n in lt.novae_step(
                _depth(system.denoiser, "encoder")).items()}
        else:
            table = lt.generation(STEPS, _depth(system.denoiser, "md"),
                                  _depth(system.vae, "decoder"))
    feats = t(rnd(rng, B, int(max(lengths)), nfeats))
    with_encode = system.vae is not None and system.condition != "action"

    def run():
        calls.clear()
        with torch.no_grad():
            out, _ = system.generate(
                cond, uncond, lengths, num_inference_timesteps=STEPS,
                generator=torch.Generator().manual_seed(13))
            got = {"generate": (out, dict(calls))}
            if with_encode:
                calls.clear()
                z = system.vae.encode(feats, lengths, sample_mean=True)[0]
                got["encode"] = (z, dict(calls))
        return got

    f32 = run()  # float32 on the card's routes
    with cuda_common.plain_routes():
        plain = run()
    monkeypatch.setattr(cuda_common, "on_card", lambda device: False)
    bf16_routes = run()  # every kernel route: the bf16 gates' choices
    assert f32["generate"][1] == table
    assert _LAYERS[name] == (_depth(system.denoiser, "md")
                             or _depth(system.denoiser, "encoder"),
                             system.vae and _depth(system.vae, "decoder"))
    assert plain["generate"][1] == {}
    if with_encode:
        n = _depth(system.vae.encoder, "encoder")
        assert f32["encode"][1] == lt.encode(n)
        # stage 2's frozen encode
        assert f32["encode"][1] == {k: v for k, v in lt.stage2_step(
            n).items() if not k.startswith("train_")}
    for key, (out, counts) in f32.items():
        assert counts == lt.float32_launches(bf16_routes[key][1]), key
        assert relerr(out, plain[key][0].numpy()) <= ROUTE_TOL, key
        assert bool(torch.isfinite(out).all())


def test_published_training_passes_float32_launch_tables(card, calls):
    """The published HumanML3D configuration at its widths, batch 2, on the
    card's float32 routes: a validation pass (no gradient) calls kernels 10
    and 5 in each encoder layer and K2 in each decoder layer; the stage-1
    pass with a gradient calls kernels 8 and 9 in each of the 9 + 9 layers
    (``launch_tables.STAGE1_STEP``, whose backwards the autograd Functions
    call); the stage-2 pass calls the frozen encode's kernels 10 and 5 and
    kernel 9 in each MD layer (``stage2_step``).  The calls are those of
    the forward wrappers; each backward follows its forward."""
    from ladiff_torch import launch_tables as lt
    from ladiff_torch.config import assemble_config
    from ladiff_torch.models.ladiff import LADiffSystem
    cfg = assemble_config(
        os.path.join(REPO, "configs", "config_ladiff_humanml3d.yaml"),
        os.path.join(REPO, "configs", "assets.yaml"),
        {"model": {"droupout": 0.0}})
    system = _randomize(LADiffSystem.from_cfg(
        cfg, nfeats=263, njoints=22, device="cpu", dtype=torch.float32), 14)
    rng = np.random.RandomState(15)
    batch = {"motion": t(rnd(rng, 2, 196, 263)),
             "length": torch.tensor([196, 70]),
             "text_emb": t(rnd(rng, 2, 1, 768))}
    g = lambda: torch.Generator().manual_seed(16)
    calls.clear()
    with torch.no_grad():
        system.vae_forward(batch, train=False, generator=g())
    assert calls == lt.float32_launches({**lt.encode(), **lt.decode()})
    calls.clear()
    system.vae_forward(batch, train=True, generator=g())[0].backward()
    forward = lambda table: {k: n for k, n in table.items()
                             if not k.endswith("_bwd")}
    assert lt.STAGE1_STEP == lt.stage1_step()
    assert calls == forward(lt.STAGE1_STEP)
    calls.clear()
    system.diffusion_forward(batch, t(rnd(rng, 1, 1, 768)), train=True,
                             generator=g())[0].backward()
    assert calls == forward(lt.stage2_step())
    # the joint stage: both stages' launches, 10 guided sampling steps of
    # K1 and the decode with gradients through kernels 8 and 9
    calls.clear()
    system.vae_diffusion_forward(batch, t(rnd(rng, 1, 1, 768)), train=True,
                                 generator=g())[0].backward()
    assert calls == forward(lt.joint_step())


@pytest.mark.parametrize("whole", ["0", "1"])
def test_published_action_stage1_float32_launch_table(card, calls, whole):
    """The published HumanAct12 configuration at its widths, batch 2 at
    60 frames, on the card's float32 routes: the ActorVae's stage-1 pass
    with a gradient calls kernels 8 and 9 in each of its 6 + 6 layers, or
    kernels 12 and 13 on the whole-layer route
    (``launch_tables.action_stage1_step``)."""
    from ladiff_torch import launch_tables as lt
    from ladiff_torch.config import assemble_config
    from ladiff_torch.models.ladiff import LADiffSystem
    cfg = assemble_config(
        os.path.join(REPO, "configs", "config_ladiff_humanact12.yaml"),
        os.path.join(REPO, "configs", "assets.yaml"),
        {"DATASET": {"NCLASSES": 12}, "model": {"droupout": 0.0}})
    assert not cfg.TRAIN.MIXED_PRECISION
    system = _randomize(LADiffSystem.from_cfg(
        cfg, nfeats=150, njoints=25, device="cpu", dtype=torch.float32,
        train_whole_layer=whole), 17)
    rng = np.random.RandomState(18)
    lengths = np.array([60, 41])
    mask = np.arange(60)[None] < lengths[:, None]
    batch = {"motion": t(rnd(rng, 2, 60, 150) * mask[:, :, None]),
             "length": torch.tensor(lengths), "action": torch.tensor(
                 [[3], [7]]), "mask": torch.tensor(mask)}
    calls.clear()
    system.vae_forward(batch, train=True,
                       generator=torch.Generator().manual_seed(19))[
        0].backward()
    table = lt.action_stage1_step(whole=whole == "1")
    assert calls == {k: n for k, n in table.items()
                     if not k.endswith("_bwd")}


def _generate(system, cond, uncond, init):
    from test_torch_slice import FRAMES, LENGTHS
    with torch.no_grad():
        return system.generate(
            torch.from_numpy(cond), torch.from_numpy(uncond),
            torch.from_numpy(LENGTHS.astype(np.int64)), nframes=FRAMES,
            init_latents=torch.tensor(init))


def test_md_stack_generates_in_float32_on_the_card(card, calls):
    """``md_stack`` (kernel 11) builds for float32 compute on the card and
    generates through it once a DDIM step (``launch_tables
    .stack_generation``, with the decode's K2), within 1e-5 of the plain
    route and within 2e-3 of the JAX package's ``generate`` (whose
    ``md_stack_enabled`` is false off the TPU: its per-layer path, the same
    math; see test_torch_slice.py)."""
    import jax
    from ladiff_torch import launch_tables as lt
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.ops import cuda_common
    from test_torch_routes_generate import _slice_kw
    from test_torch_slice import FRAMES, LENGTHS, STEPS, _systems
    jsys, params, tsys = _systems()
    system = LADiffSystem(md_stack=True, mean=tsys.mean.numpy(),
                          std=tsys.std.numpy(), device="cpu",
                          dtype=torch.float32, **_slice_kw())
    system.load_state_dict(tsys.state_dict(), strict=True)
    B = len(LENGTHS)
    rng = np.random.RandomState(66)
    cond = rng.randn(B, 1, 768).astype(np.float32)
    uncond = (rng.randn(B, 1, 768) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(16)
    feats_j, z_j = jsys.generate(params, jnp.asarray(cond),
                                 jnp.asarray(uncond), jnp.asarray(LENGTHS),
                                 key, nframes=FRAMES)
    init = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                        z_j.shape, jnp.float32))
    feats, z = _generate(system, cond, uncond, init)
    assert calls == lt.stack_generation(STEPS, _depth(system.vae,
                                                      "decoder"))
    calls.clear()
    with cuda_common.plain_routes():
        feats_p, z_p = _generate(system, cond, uncond, init)
    assert calls == {}
    assert relerr(z, z_p.numpy()) <= ROUTE_TOL
    assert relerr(feats, feats_p.numpy()) <= ROUTE_TOL
    assert relerr(z, z_j) <= 2e-3
    assert relerr(feats, feats_j) <= 2e-3


@pytest.mark.parametrize("route", ["md_stack", "full_context",
                                   "one_token_h1"])
def test_generation_routes_float32_launch_tables(card, calls, monkeypatch,
                                                 route):
    """Generation's other routes in float32 on the card's routes (batch 3,
    DDIM-5): the whole stack, full-context text [B, 9, 768] and one text
    token at head width 256 call the wrappers as ``launch_tables``'
    ``stack_generation``, ``full_context_generation`` and
    ``one_token_h1_generation`` say, which are the bf16 routes' calls; each
    agrees with the plain route within 1e-5."""
    from ladiff_torch import launch_tables as lt
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.ops import cuda_common
    from test_torch_routes_generate import _slice_kw
    from test_torch_slice import LENGTHS, STEPS
    kw = dict(_slice_kw(), md_stack=route == "md_stack")
    if route == "one_token_h1":
        kw.update(latent_dim=(7, 256), num_heads=1)
    system = _randomize(LADiffSystem(device="cpu", dtype=torch.float32,
                                     **kw), 20).eval()
    B, n = len(LENGTHS), 9 if route == "full_context" else 1
    rng = np.random.RandomState(21)
    cond = rng.randn(B, n, 768).astype(np.float32)
    uncond = (rng.randn(B, n, 768) * 0.1).astype(np.float32)
    init = rng.randn(B, system.n_latents, kw["latent_dim"][1]).astype(
        np.float32)
    dec = _depth(system.vae, "decoder")
    table = (lt.stack_generation(STEPS, dec) if route == "md_stack" else
             {"full_context": lt.full_context_generation,
              "one_token_h1": lt.one_token_h1_generation}[route](
                 STEPS, _depth(system.denoiser, "md"), dec))
    feats, _ = _generate(system, cond, uncond, init)
    assert calls == table
    calls.clear()
    with cuda_common.plain_routes():
        plain, _ = _generate(system, cond, uncond, init)
    assert calls == {}
    monkeypatch.setattr(cuda_common, "on_card", lambda device: False)
    _generate(system, cond, uncond, init)  # every kernel route: bf16's
    assert table == lt.float32_launches(calls)
    assert relerr(feats, plain.numpy()) <= ROUTE_TOL
    assert bool(torch.isfinite(feats).all())


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
