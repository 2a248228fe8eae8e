"""The PyTorch port's stage-1 (LA-VAE) training slice against the JAX
package on the CPU: the plain versions of the inference FFN tail and of the
two training kernels (forward and every gradient) against the Pallas kernels
in interpret mode, the hand-derived backwards against ``torch.autograd``,
the layers in training mode, ``LAVae.encode`` / ``add_noise``, the losses,
``vae_forward`` with its gradients name by name, and AdamW steps against
``optax.adamw``.

Small sizes: d 128, 2 heads, ff 256, 3 layers, 24-40 frames, token counts
that are no multiple of 8.  Both sides compute in float32 from the same
numpy-seeded inputs and the same (converted) weights; noise is passed in.

Tolerance 1e-4 norm-wise unless stated: what differs is the order of sums
and the erf / exp implementations (the Pallas kernels use a polynomial erf,
1.5e-7), ~1e-6 per layer.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from ladiff_torch.convert import flax_state_dict, system_state_dict
from test_torch_modules import port, randomize, relerr, rnd, t

TOL = 1e-4
D, H, FF, LAYERS, NFEATS = 128, 2, 256, 3, 263


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _ffn_weights(seed):
    """JAX-layout FFN-tail weights ([in, out] kernels) and the port's dict
    (torch layouts)."""
    rng = np.random.RandomState(seed)
    j = {"w1": rnd(rng, D, FF, scale=D ** -0.5), "b1": rnd(rng, FF, scale=0.1),
         "w2": rnd(rng, FF, D, scale=FF ** -0.5), "b2": rnd(rng, D, scale=0.1),
         "ln1_w": 1 + rnd(rng, D, scale=0.1), "ln1_b": rnd(rng, D, scale=0.1),
         "ln2_w": 1 + rnd(rng, D, scale=0.1), "ln2_b": rnd(rng, D, scale=0.1)}
    p = {k: t(v.T.copy() if v.ndim == 2 else v) for k, v in j.items()}
    return j, p


def _ffn_jax_args(x, j):
    return tuple(jnp.asarray(a) for a in (
        x, j["w1"], j["b1"], j["w2"], j["b2"], j["ln1_w"], j["ln1_b"],
        j["ln2_w"], j["ln2_b"]))


# torch name and whether the JAX gradient is the transpose, in the JAX
# function's argument order after x
_FFN_GRADS = (("w1", True), ("b1", False), ("w2", True), ("b2", False),
              ("ln1_w", False), ("ln1_b", False), ("ln2_w", False),
              ("ln2_b", False))


def _attn_weights(seed):
    rng = np.random.RandomState(seed)
    j = {"in_w": rnd(rng, D, 3 * D, scale=D ** -0.5),
         "in_b": rnd(rng, 3 * D, scale=0.1),
         "out_w": rnd(rng, D, D, scale=D ** -0.5),
         "out_b": rnd(rng, D, scale=0.1)}
    p = {k: t(v.T.copy() if v.ndim == 2 else v) for k, v in j.items()}
    return j, p


def _key_mask(lengths, S):
    return (np.arange(S)[None, :] < np.asarray(lengths)[:, None])


def _with_grad(p):
    return {k: v.clone().requires_grad_() for k, v in p.items()}


# -- kernel 5 ----------------------------------------------------------------

@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_postnorm_ffn_plain_matches_pallas(interpret, activation):
    from ladiff_torch.ops.postnorm_ffn import (fused_postnorm_ffn,
                                               postnorm_ffn_plain)
    from ladiff_tpu.ops.pallas_postnorm_ffn import \
        fused_postnorm_ffn as jax_kernel
    x = rnd(np.random.RandomState(40), 45, D, scale=0.7)
    j, p = _ffn_weights(41)
    want = jax_kernel(*_ffn_jax_args(x, j), activation=activation)
    got = postnorm_ffn_plain(t(x), p, activation=activation)
    assert relerr(got, want) <= TOL
    # on a CPU tensor the wrapper is its plain version
    assert torch.equal(fused_postnorm_ffn(t(x), p, activation=activation),
                       got)


def test_inference_kernels_refuse_a_required_gradient():
    """The check that guards kernel 5 and K2 on CUDA tensors: with autograd
    recording and an input or weight that requires a gradient it raises;
    under ``no_grad`` or without such a tensor it passes."""
    from ladiff_torch.ops.cuda_common import require_no_grad
    w = torch.zeros(3, requires_grad=True)
    x = torch.zeros(3)
    with pytest.raises(RuntimeError, match="inference kernel"):
        require_no_grad("fused_postnorm_ffn", [x, w])
    with pytest.raises(RuntimeError, match="fused_decoder_layer"):
        require_no_grad("fused_decoder_layer", [x * w])
    with torch.no_grad():
        require_no_grad("fused_postnorm_ffn", [x, w])
    require_no_grad("fused_postnorm_ffn", [x, w.detach()])


# -- kernel 9 ----------------------------------------------------------------

@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_train_ffn_matches_pallas_rate0(interpret, activation):
    """Forward and all nine gradients (x and the eight parameters) of
    sum(out^2) against ``jax.grad`` of the Pallas pair."""
    from ladiff_torch.ops.train_ffn import (train_postnorm_ffn,
                                            train_postnorm_ffn_plain)
    from ladiff_tpu.ops.pallas_train_ffn import \
        train_postnorm_ffn as jax_kernel
    x = rnd(np.random.RandomState(42), 45, D, scale=0.5)
    j, p = _ffn_weights(43)
    args = _ffn_jax_args(x, j)
    seed = jnp.int32(7)
    want = jax_kernel(*args, seed, activation, 0.0)
    gwant = jax.grad(
        lambda *a: jnp.sum(jax_kernel(*a, seed, activation, 0.0) ** 2),
        argnums=tuple(range(9)))(*args)
    assert relerr(train_postnorm_ffn_plain(t(x), p, activation=activation),
                  want) <= TOL
    xt, pt = t(x).requires_grad_(), _with_grad(p)
    out = train_postnorm_ffn(xt, pt, activation=activation)
    assert relerr(out, want) <= TOL
    (out ** 2).sum().backward()
    assert relerr(xt.grad, gwant[0]) <= TOL
    for (name, transposed), g in zip(_FFN_GRADS, gwant[1:]):
        g = np.asarray(g).T if transposed else np.asarray(g)
        assert relerr(pt[name].grad, g) <= TOL, name


# -- kernel 8 ----------------------------------------------------------------

def test_train_attention_matches_pallas_rate0(interpret):
    """Forward and all five gradients with a key mask, S = 13 (no multiple
    of 8), against the Pallas pair."""
    from ladiff_torch.ops.train_attention import (train_self_attention,
                                                  train_self_attention_plain)
    from ladiff_tpu.ops.pallas_train_attention import \
        train_self_attention as jax_kernel
    B, S = 3, 13
    M = B * S
    x = rnd(np.random.RandomState(44), M, D, scale=0.5)
    kv = _key_mask([9, 13, 4], S).astype(np.float32).reshape(M)
    j, p = _attn_weights(45)
    seed = jnp.int32(3)
    jkv = jnp.asarray(kv.reshape(M, 1))
    jargs = tuple(jnp.asarray(a) for a in (x, j["in_w"], j["in_b"],
                                           j["out_w"], j["out_b"]))

    def fn(x_, wqkv, bqkv, wout, bout):
        return jax_kernel(x_, jkv, wqkv, bqkv, wout, bout, seed, H, S, 0.0)

    want = fn(*jargs)
    gwant = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                     argnums=(0, 1, 2, 3, 4))(*jargs)
    assert relerr(train_self_attention_plain(t(x), t(kv), p, H=H, S=S),
                  want) <= TOL
    xt, pt = t(x).requires_grad_(), _with_grad(p)
    out = train_self_attention(xt, t(kv), pt, H=H, S=S)
    assert relerr(out, want) <= TOL
    (out ** 2).sum().backward()
    assert relerr(xt.grad, gwant[0]) <= TOL
    for name, g in zip(("in_w", "in_b", "out_w", "out_b"), gwant[1:]):
        g = np.asarray(g).T if name.endswith("_w") else np.asarray(g)
        assert relerr(pt[name].grad, g) <= TOL, name


# -- the hand-derived backwards against autograd ------------------------------

def _masks(rng, shapes, rate):
    if rate == 0.0:
        return None
    return tuple(t((rng.rand(*s) >= rate).astype(np.float64) / (1 - rate))
                 for s in shapes)


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("kernel", ["ffn", "attention"])
def test_plain_backward_matches_autograd(kernel, rate):
    """Float64, so that what is compared is the formulas: 1e-10."""
    from ladiff_torch.ops import train_attention as ta
    from ladiff_torch.ops import train_ffn as tf
    rng = np.random.RandomState(46)
    B, S = 3, 13
    M = B * S
    x = t(rng.randn(M, D) * 0.5)
    dout = t(rng.randn(M, D))
    if kernel == "ffn":
        p = {k: v.double() for k, v in _ffn_weights(47)[1].items()}
        masks = _masks(rng, [(M, FF), (M, D)], rate)
        fwd = lambda x_, p_: tf.train_postnorm_ffn_plain(x_, p_, masks)
        dx, grads = tf.train_postnorm_ffn_bwd_plain(x, dout, p, masks)
    else:
        p = {k: v.double() for k, v in _attn_weights(48)[1].items()}
        kv = t(_key_mask([9, 13, 4], S).astype(np.float64).reshape(M))
        masks = _masks(rng, [(B, H, S, S), (M, D)], rate)
        fwd = lambda x_, p_: ta.train_self_attention_plain(x_, kv, p_, masks,
                                                           H=H, S=S)
        dx, grads = ta.train_self_attention_bwd_plain(x, kv, dout, p, masks,
                                                      H=H, S=S)
    xt, pt = x.clone().requires_grad_(), _with_grad(p)
    names = list(pt)
    want = torch.autograd.grad(fwd(xt, pt), [xt] + [pt[k] for k in names],
                               dout)
    assert relerr(dx, want[0].numpy()) <= 1e-10
    for name, g in zip(names, want[1:]):
        assert relerr(grads[name], g.numpy()) <= 1e-10, name


@pytest.mark.parametrize("kernel", ["ffn", "attention"])
def test_training_functions_draw_their_masks_from_the_generator(kernel):
    """On CPU tensors a rate > 0 call draws both masks from the caller's
    generator, in the kernels' order, and its backward uses the same
    masks."""
    from ladiff_torch.ops import train_attention as ta
    from ladiff_torch.ops import train_ffn as tf
    from ladiff_torch.ops.cuda_common import dropout_mask
    rng = np.random.RandomState(49)
    B, S, rate = 2, 11, 0.3
    M = B * S
    x = t(rnd(rng, M, D, scale=0.5))
    gen = lambda: torch.Generator().manual_seed(5)
    if kernel == "ffn":
        p = _ffn_weights(50)[1]
        shapes = [(M, FF), (M, D)]
        call = lambda x_, p_, g: tf.train_postnorm_ffn(x_, p_, rate=rate,
                                                       generator=g)
        plain = lambda x_, p_, m: tf.train_postnorm_ffn_plain(x_, p_, m)
    else:
        p = _attn_weights(51)[1]
        kv = torch.ones(M)
        shapes = [(B, H, S, S), (M, D)]
        call = lambda x_, p_, g: ta.train_self_attention(
            x_, kv, p_, H=H, S=S, rate=rate, generator=g)
        plain = lambda x_, p_, m: ta.train_self_attention_plain(
            x_, kv, p_, m, H=H, S=S)
    g = gen()
    masks = tuple(dropout_mask(s, rate, x, g) for s in shapes)
    assert 0.5 < float((masks[0] > 0).float().mean()) < 0.9
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


# -- layers in training mode --------------------------------------------------

@pytest.mark.parametrize("S", [35, 12])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layer_training_mode_matches_jax(kind, S):
    """Dropout 0, ``deterministic=False`` on the JAX side: outputs and the
    input gradient.  35 tokens take the training attention kernel's path
    (its plain version on the CPU), 12 tokens (below ``MIN_TOKENS``) the
    plain attention module."""
    from ladiff_torch.ops import transformer as tt
    from ladiff_tpu.ops import transformer as jt
    rng = np.random.RandomState(52)
    B, L = 2, 5
    x, mem = rnd(rng, B, S, D, scale=0.5), rnd(rng, B, L, D)
    kv, mv = _key_mask([S * 3 // 5, S], S), _key_mask([2, 5], L)
    if kind == "encoder":
        jl = jt.TransformerEncoderLayer(D, H, FF, 0.0, "gelu")
        p = randomize(jax.eval_shape(jl.init, jax.random.PRNGKey(0),
                                     jnp.asarray(x))["params"], 53)
        jfn = lambda x_: jl.apply({"params": p}, x_, jnp.asarray(kv),
                                  deterministic=False)
        tl = port(tt.TransformerEncoderLayer(D, H, FF, "gelu"), p).train()
        tfn = lambda x_: tl(x_, t(kv))
    else:
        jl = jt.TransformerDecoderLayer(D, H, FF, 0.0, "gelu")
        p = randomize(jax.eval_shape(jl.init, jax.random.PRNGKey(0),
                                     jnp.asarray(x), jnp.asarray(mem))[
                                         "params"], 54)
        jfn = lambda x_: jl.apply({"params": p}, x_, jnp.asarray(mem),
                                  jnp.asarray(kv), jnp.asarray(mv),
                                  deterministic=False)
        tl = port(tt.TransformerDecoderLayer(D, H, FF, "gelu"), p).train()
        tfn = lambda x_: tl(x_, t(mem), t(kv), t(mv))
    want = jfn(jnp.asarray(x))
    gwant = jax.grad(lambda x_: jnp.sum(jfn(x_) ** 2))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = tfn(xt)
    assert relerr(got, want) <= TOL
    (got ** 2).sum().backward()
    assert relerr(xt.grad, gwant) <= TOL
    # the same weights give the same output at inference
    with torch.no_grad():
        assert relerr(tl.eval()(*([t(x), t(kv)] if kind == "encoder" else
                                  [t(x), t(mem), t(kv), t(mv)])), want) <= TOL


def test_dropout_adds_no_parameter_or_buffer():
    from ladiff_torch.models.vae import LAVae
    plain = LAVae(NFEATS, (7, D), FF, LAYERS, H)
    drop = LAVae(NFEATS, (7, D), FF, LAYERS, H, dropout=0.1, dvae=True,
                 percentage_noised=0.1)
    assert set(plain.state_dict()) == set(drop.state_dict())
    drop.load_state_dict(plain.state_dict(), strict=True)


# -- models/vae ---------------------------------------------------------------

def _vae_pair(seed, **jax_kw):
    from ladiff_torch.models.vae import LAVae as TV
    from ladiff_tpu.models.vae import LAVae as JV
    jv = JV(nfeats=NFEATS, latent_dim=(7, D), ff_size=FF, num_layers=LAYERS,
            num_heads=H, dropout=0.0, **jax_kw)
    p = randomize(jax.eval_shape(jv.init, jax.random.PRNGKey(0),
                                 jnp.zeros((2, 30, NFEATS)),
                                 jnp.asarray([30, 30]),
                                 jax.random.PRNGKey(1))["params"], seed)
    return jv, p, port(TV(NFEATS, (7, D), FF, LAYERS, H), p, "")


@pytest.mark.parametrize("mode", ["sample", "sample_mean", "fact"])
def test_vae_encode(mode):
    """Mixed lengths (1, 2, 3 and 5 active latents of 5), 30 frames + 10
    distribution tokens = 40 tokens; the same Gaussian noise on both
    sides."""
    jv, p, tv = _vae_pair(55)
    rng = np.random.RandomState(56)
    T = 30
    lengths = np.array([7, 30, 20, 13], np.int32)
    feats = rnd(rng, 4, T, NFEATS, scale=0.5)
    key = jax.random.PRNGKey(9)
    kw = {"sample": {}, "sample_mean": {"sample_mean": True},
          "fact": {"fact": 0.3}}[mode]
    jv6 = jv.clone(frame_per_latent=6)
    want = jv6.apply({"params": p}, jnp.asarray(feats), jnp.asarray(lengths),
                     rng=key, method=jv6.encode, **kw)
    eps = np.asarray(jax.random.normal(key, (4, 5, D), jnp.float32))
    tv.frame_per_latent = 6
    with torch.no_grad():
        got = tv.encode(t(feats), t(lengths).long(), eps=t(eps), **kw)
    for g, w, name in zip(got[:3], want[:3], ("z", "mu", "logvar")):
        assert relerr(g, w) <= TOL, name
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].sum(1).tolist() == [2, 5, 4, 3]
    assert not got[0][0, 2:].any() and got[0][0, :2].all()
    # without eps the sample comes from the generator, reproducibly
    with torch.no_grad():
        a = tv.encode(t(feats), t(lengths).long(),
                      generator=torch.Generator().manual_seed(1))[0]
        b = tv.encode(t(feats), t(lengths).long(),
                      generator=torch.Generator().manual_seed(1))[0]
    assert torch.equal(a, b)


def test_vae_add_noise():
    """DVAE corruption: at most int(T F p) flattened positions (drawn with
    replacement), the same positions for every sample, unit-variance
    noise."""
    from ladiff_torch.models.vae import LAVae
    vae = LAVae(NFEATS, (7, D), FF, LAYERS, H, dvae=True,
                percentage_noised=0.2)
    B, T = 6, 40
    feats = torch.zeros(B, T, NFEATS)
    out = vae.add_noise(feats, torch.Generator().manual_seed(3))
    changed = (out != 0).reshape(B, -1)
    n = int(T * NFEATS * 0.2)
    # n draws with replacement out of T F positions hit n (1 - n / 2TF)
    # distinct ones on average
    assert 0.85 * n <= int(changed[0].sum()) <= n
    assert bool((changed == changed[0]).all())
    assert abs(float(out.reshape(B, -1)[:, changed[0]].std()) - 1.0) < 0.05
    # encode corrupts its input only in training mode
    vae.train()
    lengths = torch.full((B,), T)
    g = lambda: torch.Generator().manual_seed(4)
    eps = torch.zeros(B, 5, D)
    with torch.no_grad():
        noisy = vae.encode(feats, lengths, eps=eps, generator=g())[1]
        vae.eval()
        clean = vae.encode(feats, lengths, eps=eps, generator=g())[1]
    assert not torch.allclose(noisy, clean)


# -- losses -------------------------------------------------------------------

@pytest.mark.parametrize("with_joints", [True, False])
def test_vae_loss(with_joints):
    from ladiff_torch.losses import mld as tm
    from ladiff_tpu.losses import mld as jm
    rng = np.random.RandomState(57)
    a, b = rnd(rng, 3, 20, NFEATS, scale=1.5), rnd(rng, 3, 20, NFEATS)
    ja, jb = rnd(rng, 3, 20, 22, 3, scale=2.0), rnd(rng, 3, 20, 22, 3)
    mu, logvar = rnd(rng, 3, 5, D), rnd(rng, 3, 5, D, scale=0.5)
    weights = dict(lambda_rec=1.0, lambda_joint=0.7, lambda_kl=1e-2)
    jj = (jnp.asarray(ja), jnp.asarray(jb)) if with_joints else (None, None)
    tj = (t(ja), t(jb)) if with_joints else (None, None)
    want, wlogs = jm.vae_loss(jnp.asarray(a), jnp.asarray(b), *jj,
                              jnp.asarray(mu), jnp.asarray(logvar),
                              jm.LossWeights(**weights))
    got, logs = tm.vae_loss(t(a), t(b), *tj, t(mu), t(logvar),
                            tm.LossWeights(**weights))
    assert relerr(got, want) <= 1e-6
    assert set(logs) == set(wlogs)
    for k in logs:
        assert relerr(logs[k], wlogs[k]) <= 1e-6, k
    # reductions run in float32 whatever the inputs' type
    low, _ = tm.vae_loss(t(a).bfloat16(), t(b).bfloat16(), *tj, t(mu),
                         t(logvar), tm.LossWeights(**weights))
    assert low.dtype == torch.float32


def test_diffusion_loss():
    from ladiff_torch.losses import mld as tm
    from ladiff_tpu.losses import mld as jm
    rng = np.random.RandomState(58)
    a, b = rnd(rng, 3, 5, D), rnd(rng, 3, 5, D)
    want, _ = jm.diffusion_loss(jnp.asarray(a), jnp.asarray(b))
    got, logs = tm.diffusion_loss(t(a), t(b))
    assert relerr(got, want) <= 1e-6 and set(logs) == {"inst_loss", "total"}
    want, _ = jm.diffusion_loss(None, None, predict_epsilon=False,
                                x0_pred=jnp.asarray(a), x0=jnp.asarray(b))
    got, logs = tm.diffusion_loss(None, None, predict_epsilon=False,
                                  x0_pred=t(a), x0=t(b))
    assert relerr(got, want) <= 1e-6 and set(logs) == {"x_loss", "total"}


# -- the slice as a whole -----------------------------------------------------

FRAMES, LENGTHS = 40, np.array([40, 17, 33], np.int32)


def _systems(seed=60, **torch_kw):
    from ladiff_torch.models.ladiff import LADiffSystem as TS
    from ladiff_tpu.models.ladiff import LADiffSystem as JS
    kw = dict(nfeats=NFEATS, njoints=22, max_frames=FRAMES, latent_dim=(7, D),
              ff_size=FF, num_layers=LAYERS, num_heads=H)
    rng = np.random.RandomState(seed)
    mean = rnd(rng, NFEATS, scale=0.1)
    std = (np.abs(rng.randn(NFEATS)) * 0.1 + 0.05).astype(np.float32)
    jsys = JS(dropout=0.0, mean=jnp.asarray(mean), std=jnp.asarray(std), **kw)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), seed + 1)
    tsys = TS(mean=mean, std=std, device="cpu", **kw, **torch_kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    batch = {"motion": rnd(rng, len(LENGTHS), FRAMES, NFEATS, scale=0.5),
             "length": LENGTHS}
    return jsys, params, tsys, batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {"motion": t(batch["motion"]), "length": t(batch["length"]).long()}


def _eps_of(key):
    """The latent noise ``vae_forward`` of the JAX package draws from
    ``key``."""
    enc_rng = jax.random.split(key, 3)[0]
    return t(np.asarray(jax.random.normal(enc_rng, (len(LENGTHS), 5, D),
                                          jnp.float32)))


@pytest.mark.parametrize("train", [True, False])
def test_vae_forward_matches_jax(train):
    """Loss, logs and reconstruction; in training mode (dropout 0) also
    every gradient of the VAE, name by name through the converted gradient
    tree.  Gradients: 1e-3 per tensor (small gradients of the deep layers
    carry the float32 rounding of the whole backward pass), 1e-4 over the
    whole gradient vector."""
    jsys, params, tsys, batch = _systems()
    key = jax.random.PRNGKey(5)

    def loss(p):
        total, (logs, aux) = jsys.vae_forward(p, _jax_batch(batch), key,
                                              train=train)
        return total, (logs, aux)

    (want, (wlogs, waux)), gtree = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params["vae"])
    grad_mode = torch.enable_grad() if train else torch.no_grad()
    with grad_mode:
        got, (logs, aux) = tsys.vae_forward(_torch_batch(batch), train=train,
                                            eps=_eps_of(key))
    assert not tsys.vae.training  # the mode is restored
    assert relerr(got, want) <= TOL
    for k in ("recons_feature", "recons_joints", "kl_motion", "total"):
        assert relerr(logs[k], wlogs[k]) <= TOL, k
    for k in ("feats_rst", "z", "joints_rst", "joints_ref"):
        assert relerr(aux[k], waux[k]) <= TOL, k
    if not train:
        return
    got.backward()
    gwant = flax_state_dict(gtree, "vae.")
    named = dict(tsys.named_parameters())
    assert set(gwant) == {n for n in named if n.startswith("vae.")}
    for name, g in gwant.items():
        assert relerr(named[name].grad, g.numpy()) <= 1e-3, name
    flat = lambda d: np.concatenate([d[n].reshape(-1) for n in sorted(gwant)])
    assert relerr(flat({n: named[n].grad.numpy() for n in gwant}),
                  flat({n: g.numpy() for n, g in gwant.items()})) <= TOL
    assert all(p.grad is None for n, p in named.items()
               if n.startswith("denoiser."))


@pytest.mark.parametrize("grad_clip,weight_decay", [(None, 1e-2),
                                                    (0.05, 1e-1)])
def test_adamw_steps_match_optax(grad_clip, weight_decay):
    """Two optimizer steps on a fixed batch against ``optax.adamw`` as the
    JAX trainer configures it: the parameter vector within 1e-5 norm-wise.

    The first AdamW steps move every weight by about lr whatever the size
    of its gradient, so an element whose true gradient is zero (the key
    third of every ``in_proj_bias``: softmax ignores a constant added to
    all logits) turns float32 rounding into a full +-lr update.  The update
    itself is therefore compared, within 2e-3, over the elements whose
    gradient is at least 1e-3 of its tensor's largest in both steps; a
    wrong lr, beta, eps, decay or clip moves all of those."""
    from ladiff_torch.training.trainer import make_optimizer, vae_train_step
    from ladiff_tpu.training.trainer import make_optimizer as jax_optimizer
    jsys, params, tsys, batch = _systems(62)
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    tx = jax_optimizer(1e-4, weight_decay, grad_clip)
    jp = params["vae"]
    state = tx.init(jp)
    jnorms, clear = [], None
    grad_fn = jax.jit(jax.grad(lambda p, key: jsys.vae_forward(
        p, _jax_batch(batch), key, train=True)[0]))
    for key in keys:
        grads = grad_fn(jp, key)
        jnorms.append(float(optax.global_norm(grads)))
        big = {n: g.abs() >= 1e-3 * g.abs().max()
               for n, g in flax_state_dict(grads, "").items()}
        clear = big if clear is None else {n: clear[n] & big[n] for n in big}
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
    before = {n: p.detach().clone() for n, p in tsys.vae.named_parameters()}
    opt = make_optimizer(tsys.vae.parameters(), 1e-4, weight_decay, grad_clip)
    for key, jn in zip(keys, jnorms):
        logs = vae_train_step(tsys, opt, _torch_batch(batch),
                              eps=_eps_of(key))
        # the second step's gradient is taken at parameters that already
        # differ by the first update's rounding
        assert abs(float(logs["grad_norm"]) - jn) <= 1e-3 * jn
    want = flax_state_dict(jp, "")
    got = {n: p.detach() for n, p in tsys.vae.named_parameters()}
    assert set(want) == set(got)
    names = sorted(want)
    vec = lambda d: np.concatenate([d[n].reshape(-1).numpy() for n in names])
    assert relerr(vec(got), vec(want)) <= 1e-5
    mask = vec(clear)
    assert mask.mean() > 0.5
    upd = lambda d: vec({n: d[n] - before[n] for n in names})[mask]
    assert relerr(upd(got), upd(want)) <= 2e-3


def test_gradient_tree_converts_like_the_parameters():
    """``flax_state_dict`` gives a gradient tree the parameters' names and
    the same transposes."""
    tree = {"linear1": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                        "bias": np.zeros(3, np.float32)},
            "input_blocks_1": {"norm1": {"scale": np.ones(4, np.float32)},
                               "self_attn": {"in_proj_kernel": np.ones(
                                   (4, 12), np.float32)}}}
    got = flax_state_dict(tree, "vae.")
    assert set(got) == {"vae.linear1.weight", "vae.linear1.bias",
                        "vae.input_blocks.1.norm1.weight",
                        "vae.input_blocks.1.self_attn.in_proj_weight"}
    assert got["vae.linear1.weight"].shape == (3, 2)
    assert got["vae.linear1.weight"][2, 1] == 5.0
    assert got["vae.input_blocks.1.self_attn.in_proj_weight"].shape == (12, 4)


def test_seed_draws_follow_the_generator():
    """One seed per kernel call: the same sequence for the same generator
    seed, another for another."""
    from ladiff_torch.ops.cuda_common import draw_seed, split_seed
    draws = lambda s: [draw_seed(g) for g in [torch.Generator().manual_seed(s)]
                       for _ in range(3)]
    assert draws(1) == draws(1)
    assert len({*draws(1), *draws(2)}) == 6
    for v in draws(1) + [2 ** 64 - 1, 2 ** 63]:
        lo, hi = split_seed(v)
        assert -2 ** 31 <= lo < 2 ** 31 and -2 ** 31 <= hi < 2 ** 31
        assert ((hi % 2 ** 32) << 32 | (lo % 2 ** 32)) == v % 2 ** 64


def test_train_bench_protocol_on_the_cpu():
    """The bench's fixed batch follows the JAX script's length ramp, and a
    cut-down system takes finite steps through ``measure``."""
    from ladiff_torch import train_bench
    batch = train_bench.make_batch(128, 196)
    want = np.minimum(40 + (8 * np.arange(128)) % 157, 196)
    np.testing.assert_array_equal(batch["length"].numpy(), want)
    assert batch["motion"].shape == (128, 196, 263)
    np.testing.assert_allclose(
        batch["motion"][0, 0, :3].numpy(),
        np.random.RandomState(0).randn(3).astype(np.float32))
    system, opt = train_bench.build("cpu", latent_dim=(7, D), ff_size=FF,
                                    num_layers=LAYERS, num_heads=H,
                                    max_frames=FRAMES)
    assert system.vae.encoder.middle_block.dropout == train_bench.DROPOUT
    assert system.vae.final_layer.weight.dtype == torch.float32
    res = train_bench.measure(system, opt,
                              train_bench.make_batch(3, FRAMES), iters=1,
                              warmup=1)
    assert np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"])
    assert res["samples_per_sec"] > 0 and res["peak_mem_gb"] is None
