"""The PyTorch port's denoiser training (stage 2) and joint stage against the
JAX package on the CPU: the plain version of the masked-attention kernel
against the Pallas kernel in interpret mode, ``add_noise``, the MD layer and
the denoiser in training mode with every gradient by name,
``diffusion_forward`` and ``vae_diffusion_forward`` with the JAX function's
own random draws fed in, an AdamW step of the denoiser against
``optax.adamw``, dropout, the gradient rule of the transformer layers, and
the inference kernels' refusal of a required gradient.

Small sizes: d 128, 2 heads, ff 256, 3 layers, 64 frames (74 encoder tokens,
so the frozen encode's attention takes the kernel's route), batch 3.  Both
sides compute in float32 from the same numpy-seeded inputs and the same
(converted) weights.

Tolerance 1e-4 norm-wise on values (order of sums, erf / exp
implementations), 1e-3 on each gradient tensor (small gradients of deep
layers carry the float32 rounding of the whole backward pass).
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

TOL, GRAD_TOL = 1e-4, 1e-3
D, H, FF, LAYERS, NFEATS = 128, 2, 256, 3, 263
FRAMES, LENGTHS, FPL = 64, np.array([64, 17, 40], np.int32), 16
B = len(LENGTHS)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _grads_match(named, gtree, prefix=""):
    """Every gradient of the JAX tree against the port's parameter of the
    same name; a parameter the port's graph never reached (``grad`` None)
    must have an all-zero JAX gradient."""
    want = flax_state_dict(gtree, prefix)
    assert set(want) == {n for n in named if n.startswith(prefix)}
    for name, g in want.items():
        got = named[name].grad
        if got is None:
            assert not g.any(), name
        else:
            assert relerr(got, g.numpy()) <= GRAD_TOL, name
    return want


# -- kernel 10 ----------------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False])
def test_masked_attention_plain_matches_pallas(interpret, masked):
    from ladiff_torch.ops.attention import masked_attention
    from ladiff_torch.ops.attention_kernel import (fused_masked_attention,
                                                   masked_attention_plain)
    from ladiff_tpu.ops.attention import masked_attention as jax_attention
    from ladiff_tpu.ops.pallas_attention import pallas_masked_attention
    rng = np.random.RandomState(70)
    S = 74
    q, k, v = (rnd(rng, B, S, D) for _ in range(3))
    valid = (np.arange(S)[None] < np.array([[S], [9], [40]])) if masked \
        else None
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else t(valid)
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    got = masked_attention_plain(t(q), t(k), t(v), tvalid, num_heads=H)
    assert relerr(got, pallas_masked_attention(*jargs, jvalid,
                                               num_heads=H)) <= TOL
    assert relerr(got, jax_attention(*jargs, jvalid, num_heads=H)) <= TOL
    # on CPU tensors the wrapper, and the dispatch at S >= 64, are the plain
    # version
    assert torch.equal(fused_masked_attention(t(q), t(k), t(v), tvalid,
                                              num_heads=H), got)
    assert torch.equal(masked_attention(t(q), t(k), t(v), tvalid,
                                        num_heads=H), got)


def test_masked_attention_dispatch(monkeypatch):
    """Self-attention over at least 64 tokens without dropout goes to the
    kernel's wrapper; shorter streams, cross-attention and dropout keep the
    plain version."""
    from ladiff_torch.ops import attention as ta
    calls = []
    real = ta.fused_masked_attention
    monkeypatch.setattr(ta, "fused_masked_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x64, x63, x5 = (torch.randn(2, s, D) for s in (64, 63, 5))
    ta.masked_attention(x64, x64, x64, num_heads=H)
    assert len(calls) == 1
    ta.masked_attention(x63, x63, x63, num_heads=H)
    ta.masked_attention(x64, x5, x5, num_heads=H)
    ta.masked_attention(x64, x64, x64, num_heads=H, dropout_rate=0.1,
                        generator=torch.Generator().manual_seed(0))
    assert len(calls) == 1


# -- add_noise ----------------------------------------------------------------

def test_add_noise():
    from ladiff_torch.diffusion.schedulers import make_schedule as tmake
    from ladiff_tpu.diffusion.schedulers import make_schedule as jmake
    rng = np.random.RandomState(71)
    x0, noise = rnd(rng, 4, 5, D), rnd(rng, 4, 5, D)
    ts = np.array([0, 17, 500, 999], np.int32)
    want = jmake().add_noise(jnp.asarray(x0), jnp.asarray(noise),
                             jnp.asarray(ts))
    got = tmake().add_noise(t(x0), t(noise), t(ts).long())
    assert relerr(got, want) <= 1e-6


# -- the MD layer and the denoiser in training mode ---------------------------

def _md_inputs(seed, T=5):
    rng = np.random.RandomState(seed)
    x, xf, emb = rnd(rng, B, T, D, scale=0.5), rnd(rng, B, 1, D), \
        rnd(rng, B, D)
    valid = np.arange(T)[None] < np.array([[T], [2], [1]])
    return x, xf, emb, valid


def test_md_layer_training_mode_matches_jax():
    """Dropout 0, ``deterministic=False`` on the JAX side (its concat form
    over T + 2 tokens) against the port's ``extra_kv`` form: output, the
    input gradient and every parameter gradient by name."""
    from ladiff_torch.ops.stylization import MDTransformerLayer as TL
    from ladiff_tpu.ops.stylization import MDTransformerLayer as JL
    x, xf, emb, valid = _md_inputs(72)
    jl = JL(D, D, FF, H, 0.0)
    jargs = tuple(map(jnp.asarray, (xf, emb, valid)))
    p = randomize(jax.eval_shape(jl.init, jax.random.PRNGKey(0),
                                 jnp.asarray(x), *jargs)["params"], 73)
    fn = lambda p_, x_: jl.apply({"params": p_}, x_, *jargs,
                                 deterministic=False)
    want = fn(p, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(lambda p_, x_: jnp.sum(fn(p_, x_) ** 2),
                              argnums=(0, 1)))(p, jnp.asarray(x))
    tl = port(TL(D, D, FF, H), p).train()
    xt = t(x).requires_grad_()
    got = tl(xt, t(xf), t(emb), t(valid))
    assert relerr(got, want) <= TOL
    (got ** 2).sum().backward()
    assert relerr(xt.grad, gx) <= GRAD_TOL
    _grads_match(dict(tl.named_parameters()), gp)
    # the same weights give the same output through the fused eval route
    with torch.no_grad():
        assert relerr(tl.eval()(t(x), t(xf), t(emb), t(valid)), want) <= TOL


def _denoiser_pair(seed, dropout=0.0):
    from ladiff_torch.models.denoiser import LADenoiser as TD
    from ladiff_tpu.models.denoiser import LADenoiser as JD
    rng = np.random.RandomState(seed)
    sample, text = rnd(rng, B, 5, D), rnd(rng, B, 1, 768)
    valid = np.arange(5)[None] < np.array([[5], [3], [1]])
    ts = np.array([981, 481, 1], np.int32)
    jd = JD(latent_dim=(7, D), ff_size=FF, num_layers=LAYERS, num_heads=H,
            dropout=0.0)
    jargs = tuple(map(jnp.asarray, (sample, ts, text, valid)))
    p = randomize(jax.eval_shape(jd.init, jax.random.PRNGKey(0),
                                 *jargs)["params"], seed + 1)
    td = port(TD(latent_dim=(7, D), ff_size=FF, num_layers=LAYERS,
                 num_heads=H, dropout=dropout), p)
    targs = (t(sample), t(ts).long(), t(text), t(valid))
    return jd, p, jargs, td, targs


def test_denoiser_training_mode_matches_jax():
    jd, p, jargs, td, targs = _denoiser_pair(74)
    fn = lambda p_: jd.apply({"params": p_}, *jargs, deterministic=False)
    want = fn(p)
    gp = jax.jit(jax.grad(lambda p_: jnp.sum(fn(p_) ** 2)))(p)
    got = td.train()(*targs)
    assert relerr(got, want) <= TOL
    (got ** 2).sum().backward()
    _grads_match(dict(td.named_parameters()), gp)


def test_denoiser_dropout():
    """Dropout 0.1 changes the training-mode output, the same generator seed
    repeats it, another seed does not, eval mode ignores it; it adds no
    parameter or buffer."""
    _, _, _, td, targs = _denoiser_pair(75, dropout=0.1)
    _, _, _, plain, _ = _denoiser_pair(75)
    assert set(td.state_dict()) == set(plain.state_dict())
    gen = lambda s: torch.Generator().manual_seed(s)
    with torch.no_grad():
        base = plain.train()(*targs)
        a = td.train()(*targs, generator=gen(1))
        b = td(*targs, generator=gen(1))
        c = td(*targs, generator=gen(2))
        assert torch.equal(a, b)
        assert not torch.equal(a, c)
        assert 1e-3 < relerr(a, base.numpy()) < 1.0
        assert torch.equal(td.eval()(*targs, generator=gen(1)),
                           plain.eval()(*targs))
    # every dropout place is live: probabilities, residual and both FFN
    # masks of sa_block, after each StylizationBlock's SiLU, after the GELU
    layer = td.encoder.middle_block
    assert layer.sa_block.dropout == layer.sa_block.self_attn.dropout == 0.1
    assert layer.ca_block.proj_out.dropout == layer.ffn.dropout == 0.1
    assert layer.ffn.proj_out.dropout == 0.1


# -- the gradient rule of the transformer layers ------------------------------

@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_eval_layer_under_grad_takes_the_training_route_at_rate_0(kind):
    """An eval-mode layer whose input or parameters require a gradient runs
    the training kernels' route without dropout: the eval-mode value, a
    backward, and the gradients of a dropout-free training-mode layer."""
    from ladiff_torch.ops import transformer as tt
    rng = np.random.RandomState(76)
    S, L = 40, 5
    x, mem = t(rnd(rng, 2, S, D, scale=0.5)), t(rnd(rng, 2, L, D))
    kv = t(np.arange(S)[None] < np.array([[S], [23]]))
    cls = (tt.TransformerEncoderLayer if kind == "encoder"
           else tt.TransformerDecoderLayer)
    torch.manual_seed(0)
    layer = cls(D, H, FF, "gelu", dropout=0.3).eval()
    ref = cls(D, H, FF, "gelu", dropout=0.0).train()
    ref.load_state_dict(layer.state_dict())
    call = (lambda m, x_: m(x_, kv)) if kind == "encoder" else \
        (lambda m, x_: m(x_, mem, kv))
    with torch.no_grad():
        want = call(layer, x)
    assert want.grad_fn is None
    got = call(layer, x)  # parameters require a gradient
    assert "TrainPostnormFFN" in type(
        got.grad_fn.next_functions[0][0]).__name__
    assert relerr(got, want.numpy()) <= 1e-5
    (got ** 2).sum().backward()
    out = call(ref, x)
    (out ** 2).sum().backward()
    for (n, p), q in zip(layer.named_parameters(), ref.parameters()):
        assert relerr(p.grad, q.grad.numpy()) <= 1e-5, n
    # frozen parameters and a plain input: the inference route again
    for p in layer.parameters():
        p.requires_grad_(False)
    assert call(layer, x).grad_fn is None
    assert call(layer, x.clone().requires_grad_()).grad_fn is not None


# -- the inference kernels refuse a required gradient -------------------------

class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device, so that a wrapper
    takes its kernel branch up to the first check."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("kernel", ["fused_md_layer", "fused_ln_qkv",
                                    "fused_proj_mlp",
                                    "fused_masked_attention"])
def test_inference_wrappers_refuse_a_required_gradient(kernel):
    """K1, K3, K4 and kernel 10 have no backward: on a CUDA tensor, with
    autograd recording and a weight or input that requires a gradient, they
    raise instead of returning a result cut from the graph."""
    from ladiff_torch.models.clip_text import CLIPTextLayer
    from ladiff_torch.ops.attention_kernel import fused_masked_attention
    from ladiff_torch.ops.clip_layer import fused_ln_qkv, fused_proj_mlp
    from ladiff_torch.ops.md_layer import fused_md_layer
    from ladiff_torch.ops.stylization import MDTransformerLayer
    fake = lambda *s: torch.zeros(*s).as_subclass(_OnTheCard)
    if kernel == "fused_md_layer":
        p = MDTransformerLayer(D, D, FF, H).kernel_params()
        call = lambda: fused_md_layer(
            fake(10, D), torch.zeros(4, D), torch.ones(10), torch.zeros(2, D),
            torch.zeros(1, 2 * D), torch.zeros(1, 2 * D), p, T=5, E=2, H=H)
    elif kernel == "fused_masked_attention":
        q = torch.zeros(2, 64, D, requires_grad=True)
        call = lambda: fused_masked_attention(fake(2, 64, D) + q, q, q,
                                              num_heads=H)
    else:
        layer = CLIPTextLayer(D, H)
        call = (lambda: fused_ln_qkv(fake(8, D), layer.qkv_params(),
                                     scale=0.125)) \
            if kernel == "fused_ln_qkv" else \
            (lambda: fused_proj_mlp(fake(8, D), fake(8, D),
                                    layer.mlp_params()))
    with pytest.raises(RuntimeError, match=f"{kernel} is an inference"):
        call()
    # under no_grad the check passes and the next one (the tensors are not
    # on a card after all) raises instead
    with torch.no_grad(), pytest.raises((ValueError, TypeError)):
        call()


# -- the slice as a whole -----------------------------------------------------

def _systems(seed=80, steps=4, **torch_kw):
    from ladiff_torch.models.ladiff import LADiffSystem as TS
    from ladiff_tpu.models.ladiff import LADiffSystem as JS
    kw = dict(nfeats=NFEATS, njoints=22, max_frames=FRAMES, latent_dim=(7, D),
              ff_size=FF, num_layers=LAYERS, num_heads=H,
              frame_per_latent=FPL, num_inference_timesteps=steps,
              guidance_uncondp=0.4)
    rng = np.random.RandomState(seed)
    mean = rnd(rng, NFEATS, scale=0.1)
    std = (np.abs(rng.randn(NFEATS)) * 0.1 + 0.05).astype(np.float32)
    jsys = JS(dropout=0.0, mean=jnp.asarray(mean), std=jnp.asarray(std), **kw)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), seed + 1)
    tsys = TS(mean=mean, std=std, device="cpu", **kw, **torch_kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    batch = {"motion": rnd(rng, B, FRAMES, NFEATS, scale=0.5),
             "length": LENGTHS, "text_emb": rnd(rng, B, 1, 768)}
    uncond = rnd(rng, 1, 1, 768, scale=0.1)
    return jsys, params, tsys, batch, uncond


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {"motion": t(batch["motion"]), "length": t(batch["length"]).long(),
            "text_emb": t(batch["text_emb"])}


def _normal(key):
    return t(np.asarray(jax.random.normal(key, (B, 5, D), jnp.float32)))


def _diffusion_draws(key, train=True):
    """What ``diffusion_forward`` of the JAX package draws from ``key``."""
    enc_rng, t_rng, n_rng, cfg_rng, _ = jax.random.split(key, 5)
    draws = {"eps": _normal(enc_rng), "noise": _normal(n_rng),
             "timesteps": t(np.asarray(jax.random.randint(
                 t_rng, (B,), 0, 1000))).long()}
    if train:
        draws["cond_drop"] = t(np.asarray(jax.random.bernoulli(
            cfg_rng, 0.4, (B, 1, 1))))
    return draws


@pytest.mark.parametrize("train", [True, False])
def test_diffusion_forward_matches_jax(train):
    """Loss and logs; in training mode (dropout 0) every gradient of the
    denoiser by name, and no gradient for the frozen VAE.  Key 4 drops the
    first caption of the three."""
    jsys, params, tsys, batch, uncond = _systems()
    key = jax.random.PRNGKey(4)
    draws = _diffusion_draws(key, train)
    if train:
        assert 0 < int(draws["cond_drop"].sum()) < B

    def loss(den):
        total, (logs, _) = jsys.diffusion_forward(
            den, params["vae"], _jax_batch(batch), key, jnp.asarray(uncond),
            train=train)
        return total, logs

    (want, wlogs), gtree = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params["denoiser"])
    for p in tsys.vae.parameters():
        assert p.requires_grad
    with torch.enable_grad() if train else torch.no_grad():
        got, (logs, aux) = tsys.diffusion_forward(
            _torch_batch(batch), t(uncond), train=train, **draws)
    assert not tsys.vae.training and not tsys.denoiser.training
    assert relerr(got, want) <= TOL
    assert set(logs) == set(wlogs) == {"inst_loss", "total"}
    assert aux["latent_valid"].sum(1).tolist() == [4, 2, 3]
    if not train:
        return
    got.backward()
    named = dict(tsys.named_parameters())
    _grads_match(named, gtree, "denoiser.")
    assert all(p.grad is None for n, p in named.items()
               if n.startswith("vae."))


def test_diffusion_forward_draws_from_the_generator():
    """Without the optional tensors every draw comes from the generator:
    the same seed gives the same loss, another seed another."""
    _, _, tsys, batch, uncond = _systems(82, dropout=0.1)
    run = lambda s: float(tsys.diffusion_forward(
        _torch_batch(batch), t(uncond),
        generator=torch.Generator().manual_seed(s))[0])
    with torch.no_grad():
        assert run(3) == run(3) != run(4)


def _joint_draws(key):
    vae_rng, diff_rng, gen_rng = jax.random.split(key, 3)
    return {"eps": _normal(jax.random.split(vae_rng, 3)[0]),
            "diffusion_draws": _diffusion_draws(diff_rng),
            "init_latents": _normal(jax.random.split(gen_rng)[0])}


def test_vae_diffusion_forward_matches_jax():
    """Every log term of the joint stage at 4 guided DDIM steps, and the
    gradients of both trees by name.  The sampled latents pass through
    guidance 7.5 four times, so the generation terms carry a few 1e-5 of
    float32 rounding; gradients through the joints' integration of root
    velocities are held at 1e-3 over each tree's whole gradient vector and
    at 5e-3 per tensor."""
    jsys, params, tsys, batch, uncond = _systems(84)
    key = jax.random.PRNGKey(4)  # drops the second caption

    def loss(p):
        total, (logs, _) = jsys.vae_diffusion_forward(
            p, _jax_batch(batch), key, jnp.asarray(uncond), train=True)
        return total, logs

    (want, wlogs), gtree = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    got, (logs, aux) = tsys.vae_diffusion_forward(
        _torch_batch(batch), t(uncond), train=True, **_joint_draws(key))
    assert not tsys.vae.training and not tsys.denoiser.training
    assert set(logs) == set(wlogs)
    assert {"vae_recons_feature", "vae_kl_motion", "diff_inst_loss",
            "gen_feature", "gen_joints", "total"} <= set(logs)
    for k in logs:
        assert relerr(logs[k], wlogs[k]) <= TOL, k
    assert relerr(got, want) <= TOL
    got.backward()
    named = dict(tsys.named_parameters())
    for tree in ("vae", "denoiser"):
        gwant = flax_state_dict(gtree[tree], tree + ".")
        assert set(gwant) == {n for n in named if n.startswith(tree + ".")}
        zero = lambda n: torch.zeros_like(named[n])
        gg = {n: zero(n) if named[n].grad is None else named[n].grad
              for n in gwant}
        for n, g in gwant.items():
            assert relerr(gg[n], g.numpy()) <= 5e-3, n
        flat = lambda d: np.concatenate(
            [d[n].reshape(-1).numpy() for n in sorted(gwant)])
        assert relerr(flat(gg), flat(gwant)) <= GRAD_TOL, tree


def test_generation_losses_reach_the_decoder():
    """With the reconstruction, KL and joints weights at zero the VAE's only
    gradient comes from ``gen_feature`` through the eval-mode decode: the
    decoder's parameters get one, the encoder's stay zero."""
    from ladiff_torch.losses.mld import LossWeights
    from ladiff_torch.training.trainer import (make_optimizer,
                                               vae_diffusion_train_step)
    _, _, tsys, batch, uncond = _systems(
        86, weights=LossWeights(lambda_rec=0.0, lambda_joint=0.0,
                                lambda_kl=0.0, lambda_gen=1.0))
    opt = make_optimizer(tsys.parameters(), 1e-4)
    before = tsys.vae.decoder.middle_block.linear1.weight.detach().clone()
    logs = vae_diffusion_train_step(
        tsys, opt, _torch_batch(batch), t(uncond),
        torch.Generator().manual_seed(5))
    assert float(logs["gen_feature"]) > 0 and float(logs["grad_norm"]) > 0
    vae = tsys.vae
    for n, p in vae.decoder.named_parameters():
        assert p.grad is not None and bool(p.grad.any()), n
    assert bool(vae.final_layer.weight.grad.any())
    for n, p in vae.encoder.named_parameters():
        assert p.grad is None or not bool(p.grad.any()), n
    assert not torch.equal(vae.decoder.middle_block.linear1.weight, before)


def test_diffusion_train_step_matches_optax():
    """One AdamW step of the denoiser on a fixed batch against
    ``optax.adamw`` as the JAX trainer configures it: the parameter vector
    within 1e-5 norm-wise, the gradient norm within 1e-3, and no VAE
    parameter has a gradient or moves.  (Parameters the graph never reaches,
    the collapsed cross-attention's query / key / norm, get no gradient in
    the port and so no weight decay, as in the reference torch LADiff;
    optax decays them by lr * wd = 1e-6 of their value, inside the
    tolerance.)"""
    from ladiff_torch.training.trainer import (diffusion_train_step,
                                               make_optimizer)
    from ladiff_tpu.training.trainer import make_optimizer as jax_optimizer
    jsys, params, tsys, batch, uncond = _systems(88)
    key = jax.random.PRNGKey(3)
    tx = jax_optimizer(1e-4, 1e-2, None)
    jp = params["denoiser"]
    state = tx.init(jp)
    grads = jax.jit(jax.grad(lambda p: jsys.diffusion_forward(
        p, params["vae"], _jax_batch(batch), key, jnp.asarray(uncond),
        train=True)[0]))(jp)
    updates, state = tx.update(grads, state, jp)
    jp = optax.apply_updates(jp, updates)
    vae_before = {n: p.detach().clone()
                  for n, p in tsys.vae.named_parameters()}
    opt = make_optimizer(tsys.denoiser.parameters(), 1e-4, 1e-2)
    logs = diffusion_train_step(tsys, opt, _torch_batch(batch), t(uncond),
                                **_diffusion_draws(key))
    jn = float(optax.global_norm(grads))
    assert abs(float(logs["grad_norm"]) - jn) <= 1e-3 * jn
    want = flax_state_dict(jp, "")
    got = {n: p.detach() for n, p in tsys.denoiser.named_parameters()}
    assert set(want) == set(got)
    vec = lambda d: np.concatenate(
        [d[n].reshape(-1).numpy() for n in sorted(want)])
    assert relerr(vec(got), vec(want)) <= 1e-5
    start = flax_state_dict(params["denoiser"], "")
    assert relerr(vec(got) - vec(start), vec(want) - vec(start)) <= 2e-2
    for n, p in tsys.vae.named_parameters():
        assert p.grad is None and torch.equal(p, vae_before[n]), n


def test_train_bench_stages_on_the_cpu():
    """The bench's batch carries the JAX script's text features, each stage
    trains its own tree, and a cut-down system takes finite steps."""
    from ladiff_torch import train_bench
    batch = train_bench.make_batch(128, 196)
    np.testing.assert_allclose(
        batch["text_emb"].numpy(),
        np.random.RandomState(1).randn(128, 1, 768).astype(np.float32))
    kw = dict(latent_dim=(7, D), ff_size=FF, num_layers=LAYERS, num_heads=H,
              max_frames=FRAMES)
    small = train_bench.make_batch(3, FRAMES)
    n_vae = n_den = None
    for stage in train_bench.STAGES:
        system, opt = train_bench.build("cpu", stage=stage, **kw)
        n = sum(len(g["params"]) for g in opt.param_groups)
        n_vae = n_vae or len(list(system.vae.parameters()))
        n_den = n_den or len(list(system.denoiser.parameters()))
        assert n == {"vae_train": n_vae, "diffusion_train": n_den,
                     "vae_diffusion_train": n_vae + n_den}[stage]
        assert system.denoiser.encoder.middle_block.ffn.dropout \
            == train_bench.DROPOUT
        res = train_bench.measure(system, opt, small, iters=1, warmup=1,
                                  stage=stage)
        assert np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"])
    with pytest.raises(ValueError, match="stage"):
        train_bench.build("cpu", stage="distill")


def test_train_bench_host_rows_on_the_cpu():
    """The breakdown's host profile names the step's own bookkeeping: one
    backward, one gradient norm and one optimizer step per step, and the
    mode switches of ``diffusion_forward`` (each a recursion over a tree)."""
    from ladiff_torch import train_bench
    system, opt = train_bench.build(
        "cpu", stage="diffusion_train", latent_dim=(7, D), ff_size=FF,
        num_layers=LAYERS, num_heads=H, max_frames=FRAMES)
    small = train_bench.make_batch(3, FRAMES)
    step = train_bench.make_step(system, opt, small, "diffusion_train")
    out = train_bench._host_ms(step, torch.Generator().manual_seed(0), 2)
    rows = out["ms_per_step"]
    assert set(rows) == {name for name, _, _ in train_bench._HOST_ROWS}
    for name in ("global_norm", "Tensor.backward", "optimizer.step"):
        assert rows[name]["calls"] == 1.0
    n_modules = (len(list(system.vae.modules()))
                 + len(list(system.denoiser.modules())))
    assert rows["Module.train (mode switches of the stage forwards)"][
        "calls"] == 2 * n_modules
    assert all(0 < r["ms"] <= out["profiled_wall_ms_per_step"]
               for r in rows.values())
