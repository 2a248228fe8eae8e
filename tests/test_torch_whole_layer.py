"""The whole-layer training kernels of the PyTorch port (kernel 12: a
post-norm encoder layer, kernel 13: a post-norm decoder layer) and the
training routes' shape gates, against the JAX package on the CPU.

  * the plain versions (forward and every gradient, the memory's too)
    against ``train_encoder_layer`` / ``train_decoder_layer`` run in
    interpret mode at rate 0: B 2, 36 tokens, d 128, 2 heads, ff 128, 3
    memory rows with mixed validity;
  * the hand-derived backwards against ``torch.autograd`` in float64;
  * on CPU tensors a rate > 0 call draws its masks from the generator;
  * the route: ``vae_forward`` with ``train_whole_layer`` "1", "enc" and
    "dec" against the split route and the JAX ``vae_forward`` on the same
    weights and draws, the wrappers' calls counted;
  * the gates of kernels 8, 5 and 9: encoder and decoder layers at head
    width 128 and at d 512 / ff 2048 take the plain parts and match the
    JAX layers, in training and in eval mode under a required gradient.

Tolerance 1e-4 norm-wise (float32 on both sides, the order of sums and the
erf implementations differ); the float64 comparison of formulas 1e-10.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ladiff_torch.convert import flax_state_dict
from test_torch_modules import port, randomize, relerr, rnd, t
from test_torch_train import (_eps_of, _jax_batch, _key_mask, _systems,
                              _torch_batch, _with_grad)

TOL = 1e-4
D, H, FF, L = 128, 2, 128, 3
B, S = 2, 36


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _layer_weights(seed, decoder):
    """Random parameters of kernel 12 (13) by the port's names, torch
    layouts."""
    from ladiff_torch.ops.train_decoder_layer import DEC_PARAM_ORDER
    from ladiff_torch.ops.train_layer import ENC_PARAM_ORDER
    rng = np.random.RandomState(seed)
    p = {}
    for k in DEC_PARAM_ORDER if decoder else ENC_PARAM_ORDER:
        if k.endswith("in_w"):
            p[k] = rnd(rng, 3 * D, D, scale=D ** -0.5)
        elif k.endswith("out_w"):
            p[k] = rnd(rng, D, D, scale=D ** -0.5)
        elif k == "w1":
            p[k] = rnd(rng, FF, D, scale=D ** -0.5)
        elif k == "w2":
            p[k] = rnd(rng, D, FF, scale=FF ** -0.5)
        elif k.startswith("ln") and k.endswith("_w"):
            p[k] = 1 + rnd(rng, D, scale=0.1)
        else:
            n = {"in_b": 3 * D, "b1": FF}.get(k.replace("sa_", "").replace(
                "ca_", ""), D)
            p[k] = rnd(rng, n, scale=0.1)
    return {k: t(v) for k, v in p.items()}


def _jax_args(p, decoder):
    """The JAX kernel's parameter arguments in its order, [in, out]
    kernels, from the port's dict."""
    j = {k: jnp.asarray(v.numpy().T if v.dim() == 2 else v.numpy())
         for k, v in p.items()}
    if not decoder:
        return tuple(j[k] for k in ("in_w", "in_b", "out_w", "out_b", "w1",
                                    "b1", "w2", "b2", "ln1_w", "ln1_b",
                                    "ln2_w", "ln2_b"))
    return (tuple(j[k] for k in (
        "sa_in_w", "sa_in_b", "sa_out_w", "sa_out_b", "ca_in_w", "ca_in_b",
        "ca_out_w", "ca_out_b", "w1", "b1", "w2", "b2")),
        tuple(j[k] for k in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "ln3_w",
                             "ln3_b")))


def _inputs(seed, n=B):
    """n samples (at most 3): frame lengths 24, 36, 5; 1, 3 and 2 valid
    memory rows."""
    rng = np.random.RandomState(seed)
    x = rnd(rng, n * S, D, scale=0.5)
    kv = _key_mask([S * 2 // 3, S, 5][:n], S).astype(np.float32).reshape(
        n * S)
    mem = rnd(rng, n, L, D, scale=0.5)
    mv = _key_mask([1, L, 2][:n], L).astype(np.float32)
    return x, kv, mem, mv


def _grad_of(name, jax_grad, p):
    g = np.asarray(jax_grad)
    return g.T if p[name].dim() == 2 else g


# -- kernels 12 and 13 against the Pallas kernels ----------------------------

@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_train_encoder_layer_matches_pallas_rate0(interpret, activation):
    """Forward and all thirteen gradients (x and the twelve parameters) of
    sum(out^2) against ``jax.grad`` of the Pallas kernel."""
    from ladiff_torch.ops.train_layer import (train_encoder_layer,
                                              train_encoder_layer_plain)
    from ladiff_tpu.ops.pallas_train_layer import \
        train_encoder_layer as jax_kernel
    x, kv, _, _ = _inputs(70)
    p = _layer_weights(71, decoder=False)
    jkv, seed = jnp.asarray(kv.reshape(-1, 1)), jnp.int32(5)

    def fn(x_, *a):
        return jax_kernel(x_, jkv, *a, seed, H, S, 0.0, activation)

    args = (jnp.asarray(x),) + _jax_args(p, False)
    want = fn(*args)
    gwant = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                     argnums=tuple(range(13)))(*args)
    assert relerr(train_encoder_layer_plain(t(x), t(kv), p, H=H, S=S,
                                            activation=activation),
                  want) <= TOL
    xt, pt = t(x).requires_grad_(), _with_grad(p)
    out = train_encoder_layer(xt, t(kv), pt, H=H, S=S, activation=activation)
    assert relerr(out, want) <= TOL
    (out ** 2).sum().backward()
    assert relerr(xt.grad, gwant[0]) <= TOL
    names = ("in_w", "in_b", "out_w", "out_b", "w1", "b1", "w2", "b2",
             "ln1_w", "ln1_b", "ln2_w", "ln2_b")
    for name, g in zip(names, gwant[1:]):
        assert relerr(pt[name].grad, _grad_of(name, g, p)) <= TOL, name


def _train_decoder_case(n):
    """Kernel 13's forward and all twenty gradients (x, the memory, the
    eighteen parameters) of sum(out^2) at n samples against ``jax.grad``
    of the Pallas kernel."""
    from ladiff_torch.ops.train_decoder_layer import (
        train_decoder_layer, train_decoder_layer_plain)
    from ladiff_tpu.ops.pallas_train_decoder_layer import \
        train_decoder_layer as jax_kernel
    x, kv, mem, mv = _inputs(72, n)
    p = _layer_weights(73, decoder=True)
    jkv, jmv, seed = jnp.asarray(kv.reshape(-1, 1)), jnp.asarray(mv), \
        jnp.int32(6)
    mats, lns = _jax_args(p, True)

    def fn(x_, m_, *a):
        return jax_kernel(x_, jkv, m_, jmv, *a[:12], tuple(a[12:]), seed, H,
                          S, L, 0.0, "gelu")

    args = (jnp.asarray(x), jnp.asarray(mem)) + mats + lns
    want = fn(*args)
    gwant = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                     argnums=tuple(range(20)))(*args)
    assert relerr(train_decoder_layer_plain(t(x), t(kv), t(mem), t(mv), p,
                                            H=H, S=S), want) <= TOL
    xt, mt, pt = t(x).requires_grad_(), t(mem).requires_grad_(), \
        _with_grad(p)
    out = train_decoder_layer(xt, t(kv), mt, t(mv), pt, H=H, S=S)
    assert relerr(out, want) <= TOL
    (out ** 2).sum().backward()
    assert relerr(xt.grad, gwant[0]) <= TOL
    assert relerr(mt.grad, gwant[1]) <= TOL
    names = ("sa_in_w", "sa_in_b", "sa_out_w", "sa_out_b", "ca_in_w",
             "ca_in_b", "ca_out_w", "ca_out_b", "w1", "b1", "w2", "b2",
             "ln1_w", "ln1_b", "ln2_w", "ln2_b", "ln3_w", "ln3_b")
    for name, g in zip(names, gwant[2:]):
        assert relerr(pt[name].grad, _grad_of(name, g, p)) <= TOL, name


def test_train_decoder_layer_matches_pallas_rate0(interpret):
    """Kernel 13 at B 2 against the Pallas kernel; one sample sees 1 of
    its 3 memory rows."""
    _train_decoder_case(B)


def test_train_decoder_layer_matches_pallas_rate0_three_samples(interpret):
    """The same at B 3 (108 rows: the CUDA backward's second 64-row block
    holds rows of two samples and ends partial), the third sample with 5
    valid frames and 2 memory rows."""
    _train_decoder_case(3)


@pytest.mark.parametrize("S_,want", [(32, 3), (40, 3), (63, 2), (64, 2),
                                     (196, 2)])
def test_kv_slots(S_, want):
    """The memory gradient's partial sums per 64-row block: 1 + ceil(63 /
    S) samples, and no block of a batch holds rows of more (every start
    of a block over 50 samples)."""
    from ladiff_torch.ops.train_decoder_layer import kv_slots
    assert kv_slots(S_) == want
    most = max((r0 + 63) // S_ - r0 // S_ + 1
               for r0 in range(0, 50 * S_, 64))
    assert most <= want


# -- the hand-derived backwards against autograd ----------------------------

def _masks(rng, shapes, rate):
    if rate == 0.0:
        return None
    return tuple(t((rng.rand(*s) >= rate).astype(np.float64) / (1 - rate))
                 for s in shapes)


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("kernel", ["encoder", "decoder"])
def test_whole_layer_backward_matches_autograd(kernel, rate):
    """Float64, so that what is compared is the formulas: 1e-10."""
    from ladiff_torch.ops import train_decoder_layer as tdl
    from ladiff_torch.ops import train_layer as tel
    rng = np.random.RandomState(74)
    x, kv, mem, mv = (t(a).double() for a in _inputs(75))
    M = B * S
    dout = t(rng.randn(M, D))
    dec = kernel == "decoder"
    p = {k: v.double() for k, v in _layer_weights(76, dec).items()}
    if dec:
        masks = _masks(rng, [(B, H, S, S), (M, D), (B, H, S, L), (M, D),
                             (M, FF), (M, D)], rate)
        fwd = lambda x_, m_, p_: tdl.train_decoder_layer_plain(
            x_, kv, m_, mv, p_, masks, H=H, S=S)
        dx, dmem, grads = tdl.train_decoder_layer_bwd_plain(
            x, kv, mem, mv, dout, p, masks, H=H, S=S)
    else:
        masks = _masks(rng, [(B, H, S, S), (M, D), (M, FF), (M, D)], rate)
        fwd = lambda x_, m_, p_: tel.train_encoder_layer_plain(
            x_, kv, p_, masks, H=H, S=S)
        dx, grads = tel.train_encoder_layer_bwd_plain(x, kv, dout, p, masks,
                                                      H=H, S=S)
    xt, mt, pt = x.clone().requires_grad_(), mem.clone().requires_grad_(), \
        _with_grad(p)
    names = list(pt)
    want = torch.autograd.grad(fwd(xt, mt, pt),
                               [xt, mt] + [pt[k] for k in names], dout,
                               allow_unused=True)
    assert relerr(dx, want[0].numpy()) <= 1e-10
    if dec:
        assert relerr(dmem, want[1].numpy()) <= 1e-10
    for name, g in zip(names, want[2:]):
        assert relerr(grads[name], g.numpy()) <= 1e-10, name


@pytest.mark.parametrize("kernel", ["encoder", "decoder"])
def test_whole_layer_functions_draw_their_masks_from_the_generator(kernel):
    """On CPU tensors a rate > 0 call draws its four (six) masks from the
    caller's generator in the kernel's order, and its backward uses them."""
    from ladiff_torch.ops import train_decoder_layer as tdl
    from ladiff_torch.ops import train_layer as tel
    from ladiff_torch.ops.cuda_common import dropout_mask
    x, kv, mem, mv = (t(a) for a in _inputs(77))
    M, rate = B * S, 0.3
    dec = kernel == "decoder"
    p = _layer_weights(78, dec)
    gen = lambda: torch.Generator().manual_seed(5)
    if dec:
        shapes = [(B, H, S, S), (M, D), (B, H, S, L), (M, D), (M, FF), (M, D)]
        call = lambda x_, p_, g: tdl.train_decoder_layer(
            x_, kv, mem, mv, p_, H=H, S=S, rate=rate, generator=g)
        plain = lambda x_, p_, m: tdl.train_decoder_layer_plain(
            x_, kv, mem, mv, p_, m, H=H, S=S)
    else:
        shapes = [(B, H, S, S), (M, D), (M, FF), (M, D)]
        call = lambda x_, p_, g: tel.train_encoder_layer(
            x_, kv, p_, H=H, S=S, rate=rate, generator=g)
        plain = lambda x_, p_, m: tel.train_encoder_layer_plain(
            x_, kv, p_, m, H=H, S=S)
    g = gen()
    masks = tuple(dropout_mask(s, rate, x, g) for s in shapes)
    xa, pa = x.clone().requires_grad_(), _with_grad(p)
    xb, pb = x.clone().requires_grad_(), _with_grad(p)
    out = call(xa, pa, gen())
    want = plain(xb, pb, masks)
    assert torch.equal(out, want)
    assert not torch.equal(out, call(x, p, torch.Generator().manual_seed(6)))
    out.sum().backward()
    want.sum().backward()
    assert relerr(xa.grad, xb.grad.numpy()) <= 1e-5
    for k in pa:
        assert relerr(pa[k].grad, pb[k].grad.numpy()) <= 1e-5, k


# -- the route ------------------------------------------------------------

@pytest.fixture
def layer_calls(monkeypatch):
    """Counts the calls of the kernel wrappers that the encoder and decoder
    layers make (kernels 12, 13, 8, 9, 5, K2 and 10)."""
    from ladiff_torch.ops import attention, transformer
    counts = {}
    for mod, name in ((transformer, "train_encoder_layer"),
                      (transformer, "train_decoder_layer"),
                      (transformer, "train_self_attention"),
                      (transformer, "train_postnorm_ffn"),
                      (transformer, "fused_postnorm_ffn"),
                      (transformer, "fused_decoder_layer"),
                      (attention, "fused_masked_attention")):
        def wrapped(*a, _fn=getattr(mod, name), _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return counts


_ROUTE_CALLS = {
    "1": {"train_encoder_layer": 3, "train_decoder_layer": 3},
    "enc": {"train_encoder_layer": 3, "train_self_attention": 3,
            "train_postnorm_ffn": 3},
    "dec": {"train_decoder_layer": 3, "train_self_attention": 3,
            "train_postnorm_ffn": 3},
    "0": {"train_self_attention": 6, "train_postnorm_ffn": 6}}


@pytest.mark.parametrize("route", ["1", "enc", "dec"])
def test_whole_layer_route_matches_split_route_and_jax(layer_calls, route):
    """``vae_forward`` in training mode (dropout 0) on the whole-layer
    route: loss and every VAE gradient against the JAX package's
    ``vae_forward`` (1e-3 per tensor, 1e-4 over the whole vector, as the
    split route is held) and against the port's split route (1e-4 per
    tensor); 50 encoder tokens and 40 frames with 5 memory rows take the
    kernels' gates."""
    jsys, params, whole, batch = _systems(train_whole_layer=route)
    split = _systems()[2]
    key = jax.random.PRNGKey(5)
    (want, _), gtree = jax.value_and_grad(
        lambda p: jsys.vae_forward(p, _jax_batch(batch), key, train=True),
        has_aux=True)(params["vae"])
    gwant = flax_state_dict(gtree, "vae.")
    results = {}
    for name, system in (("whole", whole), ("split", split)):
        layer_calls.clear()
        total, _ = system.vae_forward(_torch_batch(batch), train=True,
                                      eps=_eps_of(key))
        total.backward()
        results[name] = (total, dict(system.named_parameters()),
                         dict(layer_calls))
    total, named, calls = results["whole"]
    assert calls == _ROUTE_CALLS[route]
    assert results["split"][2] == _ROUTE_CALLS["0"]
    assert relerr(total, want) <= TOL
    assert relerr(total, results["split"][0].detach().numpy()) <= TOL
    for name, g in gwant.items():
        assert relerr(named[name].grad, g.numpy()) <= 1e-3, name
        assert relerr(named[name].grad,
                      results["split"][1][name].grad.numpy()) <= TOL, name
    flat = lambda d: np.concatenate([d[n].reshape(-1) for n in sorted(gwant)])
    assert relerr(flat({n: named[n].grad.numpy() for n in gwant}),
                  flat({n: g.numpy() for n, g in gwant.items()})) <= TOL


def test_whole_layer_option_values():
    """"0" (the default) leaves both stacks split; an unknown value
    raises at construction."""
    from ladiff_torch.models.ladiff import LADiffSystem
    kw = dict(nfeats=12, njoints=22, latent_dim=(7, 64), ff_size=128,
              num_layers=3, num_heads=2, device="cpu")
    for value, enc, dec in (("0", False, False), ("1", True, True),
                            ("enc", True, False), ("dec", False, True)):
        vae = LADiffSystem(train_whole_layer=value, **kw).vae
        assert all(b.whole_layer == enc for b in vae.encoder.ordered_blocks())
        assert all(b.whole_layer == dec for b in vae.decoder.ordered_blocks())
    with pytest.raises(ValueError, match="train_whole_layer"):
        LADiffSystem(train_whole_layer="yes", **kw)


# -- the gates of kernels 8, 5 and 9 ----------------------------------------

def test_training_route_gates():
    """Kernel 8 takes head widths 16 to 64 over at least 32 tokens at D up
    to 256; kernels 5 and 9 D up to 256 and F up to 1024; kernels 12 and 13
    both, kernel 13 up to 8 memory rows."""
    from ladiff_torch.ops.postnorm_ffn import postnorm_ffn_supported
    from ladiff_torch.ops.train_attention import train_attention_supported
    from ladiff_torch.ops.train_decoder_layer import \
        train_decoder_layer_supported
    from ladiff_torch.ops.train_layer import train_encoder_layer_supported
    assert train_attention_supported(206, 256, 4)
    assert train_attention_supported(196, 128, 2)
    assert not train_attention_supported(206, 256, 2)   # head width 128
    assert not train_attention_supported(206, 512, 8)   # D 512
    assert not train_attention_supported(7, 256, 4)     # 7 tokens
    assert postnorm_ffn_supported(256, 1024, "gelu")
    assert postnorm_ffn_supported(256, 128, "relu")
    assert not postnorm_ffn_supported(512, 1024, "gelu")
    assert not postnorm_ffn_supported(256, 2048, "gelu")
    assert not postnorm_ffn_supported(256, 1024, "silu")
    assert train_encoder_layer_supported(206, 256, 4, 1024, "gelu")
    assert not train_encoder_layer_supported(206, 256, 4, 2048, "gelu")
    assert train_decoder_layer_supported(196, 5, 256, 4, 1024, "gelu")
    assert not train_decoder_layer_supported(196, 9, 256, 4, 1024, "gelu")
    assert not train_decoder_layer_supported(20, 5, 256, 4, 1024, "gelu")


# (D, H, F) and the wrappers each layer then calls on its training route
_GATE_CASES = {"head_width_128": (256, 2, 256),
               "d512_ff2048": (512, 8, 2048)}


@pytest.mark.parametrize("mode", ["train", "eval_with_grad"])
@pytest.mark.parametrize("case", sorted(_GATE_CASES))
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_gated_layers_take_the_plain_parts(layer_calls, kind, case, mode):
    """A shape kernel 8 (and, at d 512 / ff 2048, kernels 5 and 9) does not
    take runs the plain parts: output, the input's (and the memory's) and
    every parameter's gradient against the JAX layer within 1e-4, in
    training mode (dropout 0) and in eval mode with a gradient required,
    and the only kernel wrapper called is kernel 9's where it takes the
    tail (over 70 tokens the plain attention under a gradient is not kernel
    10, which has no backward)."""
    from ladiff_torch.ops import transformer as tt
    from ladiff_tpu.ops import transformer as jt
    d, h, f = _GATE_CASES[case]
    rng = np.random.RandomState(80)
    T, Lm = 70, 5  # from 64 tokens on, inference self-attention is kernel 10
    x, mem = rnd(rng, 2, T, d, scale=0.5), rnd(rng, 2, Lm, d)
    kv, mv = _key_mask([41, T], T), _key_mask([2, Lm], Lm)
    train = mode == "train"
    if kind == "encoder":
        jl = jt.TransformerEncoderLayer(d, h, f, 0.0, "gelu")
        p = randomize(jl.init(jax.random.PRNGKey(0),
                              jnp.asarray(x))["params"], 81)
        jfn = lambda p_, x_, m_: jl.apply({"params": p_}, x_,
                                          jnp.asarray(kv),
                                          deterministic=not train)
        tl = port(tt.TransformerEncoderLayer(d, h, f, "gelu",
                                             whole_layer=True), p)
        tfn = lambda x_, m_: tl(x_, t(kv))
    else:
        jl = jt.TransformerDecoderLayer(d, h, f, 0.0, "gelu")
        p = randomize(jl.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(mem))["params"], 82)
        jfn = lambda p_, x_, m_: jl.apply({"params": p_}, x_, m_,
                                          jnp.asarray(kv), jnp.asarray(mv),
                                          deterministic=not train)
        tl = port(tt.TransformerDecoderLayer(d, h, f, "gelu",
                                             whole_layer=True), p)
        tfn = lambda x_, m_: tl(x_, m_, t(kv), t(mv))
    tl.train(train)
    args = (p, jnp.asarray(x), jnp.asarray(mem))
    want = jfn(*args)
    gp, gx, gm = jax.grad(lambda *a: jnp.sum(jfn(*a) ** 2),
                          argnums=(0, 1, 2))(*args)
    xt, mt = t(x).requires_grad_(), t(mem).requires_grad_()
    got = tfn(xt, mt)
    assert layer_calls == ({"train_postnorm_ffn": 1} if f <= 1024 else {})
    assert relerr(got, want) <= TOL
    (got ** 2).sum().backward()
    assert relerr(xt.grad, gx) <= TOL
    if kind == "decoder":
        assert relerr(mt.grad, gm) <= TOL
    named = dict(tl.named_parameters())
    for name, g in flax_state_dict(gp, "").items():
        assert relerr(named[name].grad, g.numpy()) <= TOL, name
