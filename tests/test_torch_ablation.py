"""The ablation switches and the LA-VAE's module options in the PyTorch
port against the JAX package on the CPU, on converted weights
(``strict=True``) and the same numpy inputs:

  * ``LAVae`` in each variant (the fixed-size latent set of ``MAX_IT`` 0
    without ``LAD``, ``LAD`` off at ``MAX_IT`` 5, ``MLP_DIST``,
    ``TEST_EFFICIENCY``, pre-norm, the all-encoder decoder, sine PEs):
    encode and decode, and every parameter's gradient in training mode;
    the plain denoiser with pre-norm layers the same way; pre-norm layers
    call no kernel wrapper in either mode;
  * the decoder's default memory mask at 7 fixed latents (the JAX
    package's, kept: memory rows past ``ceil(len / FRAME_PER_LATENT)`` are
    not attended to, although the encoder and the denoiser treat all 7 as
    valid);
  * per switch at batch 4: ``generate``, the stage-1 pass and the stage-2
    pass with every gradient; with every switch on at once the joint stage
    and the distill pass; the AR family without ``LAD`` under x0
    prediction;
  * ``from_cfg`` on each switch set in a copy of the shipped HumanML3D
    configurations against the JAX ``from_cfg`` (``model.activation``
    included, which neither package reads);
  * the ``ValueError``s where the JAX package has no working path.

Sizes: d 32, 2 heads, ff 64, 3 layers, 64 frames, 16 frames a latent, 3
sampler steps.  Tolerances: modules and their gradients 1e-4 norm-wise,
``generate`` 2e-3, the passes' losses and gradients 1e-3 (float32 on both
sides, sums in another order; guided steps amplify the rounding).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import flax_state_dict, system_state_dict
from test_torch_modules import randomize, relerr, rnd, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFEATS, T, D, H, FF, LAYERS, FPL, STEPS, TEXT = (263, 64, 32, 2, 64, 3, 16,
                                                 3, 48)
LENGTHS = np.array([64, 40, 17, 30], np.int32)  # 4, 3, 2, 2 of 5 latents
B = len(LENGTHS)
TOL, GEN_TOL, PASS_TOL = 1e-4, 2e-3, 1e-3

# the LA-VAE's variants as the two packages' LAVae arguments
VAE_VARIANTS = {
    "fixed7": dict(max_it=0, lad=False),
    "lad_off": dict(max_it=5, lad=False),
    "mlp_dist": dict(max_it=0, lad=False, mlp_dist=True),
    "test_efficiency": dict(test_efficiency=True),
    "prenorm": dict(normalize_before=True),
    "all_encoder": dict(arch="all_encoder"),
    "sine": dict(position_embedding="sine"),
}
# the module options that no configuration reaches, together
PRENORM_VAE = dict(normalize_before=True, arch="all_encoder",
                   position_embedding="sine")
# the systems' switches as the two packages' LADiffSystem arguments;
# "prenorm" is the published LA-VAE built with PRENORM_VAE
SWITCHES = {
    "fixed7": dict(max_it=0, lad=False),
    "mlp_dist": dict(max_it=0, lad=False, mlp_dist=True),
    "x0": dict(predict_epsilon=False),
    "test_efficiency": dict(test_efficiency=True),
    "prenorm": {},
    "all": dict(max_it=0, lad=False, mlp_dist=True, test_efficiency=True,
                predict_epsilon=False),
    "ar": dict(ardiff=True, lad=False, predict_epsilon=False),
}
VAE_OPTIONS = {"prenorm": PRENORM_VAE, "all": PRENORM_VAE}


def _key_valid(lengths, n):
    return np.arange(n)[None, :] < np.asarray(lengths)[:, None]


# -- the LA-VAE's variants ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _vae_pair(variant):
    from ladiff_torch.models.vae import LAVae as TV
    from ladiff_tpu.models.vae import LAVae as JV
    kw = dict(latent_dim=(7, D), ff_size=FF, num_layers=LAYERS,
              num_heads=H, frame_per_latent=FPL, **VAE_VARIANTS[variant])
    jv = JV(nfeats=NFEATS, dropout=0.0, **kw)
    p = randomize(jax.eval_shape(jv.init, jax.random.PRNGKey(0),
                                 jnp.zeros((2, T, NFEATS)),
                                 jnp.asarray([T, T]),
                                 jax.random.PRNGKey(1))["params"], 70)
    tv = TV(NFEATS, **kw)
    tv.load_state_dict(flax_state_dict(p), strict=True)
    return jv, p, tv


def _vae_jax_pass(jv):
    """encode -> decode of the JAX module in training mode (at dropout 0
    the eval-mode math) and a scalar of both, with its gradient,
    compiled."""
    def run(params, feats, lengths, key):
        kw = dict(deterministic=False, rngs={"dropout": key})
        z, mu, logvar, valid = jv.apply(
            {"params": params}, feats, lengths, rng=key, method=jv.encode,
            **kw)
        out = jv.apply({"params": params}, z, lengths, nframes=T,
                       method=jv.decode, **kw)
        return jnp.mean(out ** 2) + jnp.mean(z ** 2), (out, z, mu, logvar,
                                                       valid)
    return jax.jit(jax.value_and_grad(run, has_aux=True))


@pytest.mark.parametrize("variant", VAE_VARIANTS)
def test_vae_variant_matches_jax(variant):
    """The port in eval mode: z, mu, logvar, the latent mask and the
    decoded features; in training mode at dropout 0: a scalar of them and
    every parameter's gradient, name by name; all within 1e-4 of the JAX
    module's."""
    jv, p, tv = _vae_pair(variant)
    feats = rnd(np.random.RandomState(71), B, T, NFEATS, scale=0.5)
    key = jax.random.PRNGKey(9)
    n_lat = tv.n_lat
    assert n_lat == (VAE_VARIANTS[variant].get("max_it", 5) or 7)
    eps = t(np.asarray(jax.random.normal(key, (B, 7 if tv.mlp_dist else
                                               n_lat, D), jnp.float32)))
    (wloss, want), gtree = _vae_jax_pass(jv)(
        p, jnp.asarray(feats), jnp.asarray(LENGTHS), key)
    lengths = t(LENGTHS).long()
    with torch.no_grad():
        z, mu, logvar, valid = tv.encode(t(feats), lengths, eps=eps)
        out = tv.decode(z, lengths, T)
    for name, g, w in zip(("feats", "z", "mu", "logvar"),
                          (out, z, mu, logvar), want[:4]):
        assert g.shape == w.shape, name
        assert relerr(g, w) <= TOL, name
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[4]))
    if tv.length_aware:
        assert valid.sum(1).tolist() == [4, 3, 2, 2]
        assert not z[2, 2:].any()
    else:
        assert bool(valid.all()) and bool(z.abs().amin(2).gt(0).all())

    tv.train()
    tv.zero_grad(set_to_none=True)
    z, _, _, _ = tv.encode(t(feats), lengths, eps=eps)
    out = tv.decode(z, lengths, T)
    loss = (out ** 2).mean() + (z ** 2).mean()
    loss.backward()
    tv.eval()
    assert relerr(loss.detach(), wloss) <= TOL
    named = dict(tv.named_parameters())
    gwant = flax_state_dict(gtree)
    assert set(gwant) == set(named)
    for name, g in gwant.items():
        assert relerr(named[name].grad, g.numpy()) <= TOL, name


def test_prenorm_denoiser_matches_jax():
    """The plain denoiser wiring with pre-norm layers: the output and every
    gradient against the JAX ``LADenoiser(normalize_before=True)``."""
    from ladiff_torch.models.denoiser import LADenoiser as TD
    from ladiff_tpu.models.denoiser import LADenoiser as JD
    kw = dict(nfeats=NFEATS, latent_dim=(7, D), ff_size=FF,
              num_layers=LAYERS, num_heads=H, text_encoded_dim=TEXT,
              md_trans=False, normalize_before=True)
    jd = JD(dropout=0.0, **kw)
    rng = np.random.RandomState(72)
    x = rnd(rng, B, 5, D)
    ts = np.array([3, 500, 999, 40])
    text = rnd(rng, B, 1, TEXT)
    lv = _key_valid([4, 3, 2, 2], 5)
    jargs = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(text),
             jnp.asarray(lv))
    p = randomize(jax.eval_shape(jd.init, jax.random.PRNGKey(0), *jargs)
                  ["params"], 73)
    td = TD(**kw)
    td.load_state_dict(flax_state_dict(p), strict=True)
    assert all(layer.normalize_before
               for layer in td.encoder.ordered_blocks())
    run = jax.jit(jax.value_and_grad(lambda q: jnp.sum(jd.apply(
        {"params": q}, *jargs, deterministic=False) ** 2)))
    want = jd.apply({"params": p}, *jargs)
    wloss, gtree = run(p)
    with torch.no_grad():
        assert relerr(td(t(x), t(ts).long(), t(text), t(lv)), want) <= TOL
    td.train()
    loss = (td(t(x), t(ts).long(), t(text), t(lv)) ** 2).sum()
    loss.backward()
    assert relerr(loss.detach(), wloss) <= TOL
    named = dict(td.named_parameters())
    for name, g in flax_state_dict(gtree).items():
        assert relerr(named[name].grad, g.numpy()) <= TOL, name


_WRAPPERS = {
    "ladiff_torch.ops.attention": ("fused_masked_attention",),
    "ladiff_torch.ops.transformer": (
        "fused_decoder_layer", "fused_postnorm_ffn", "train_self_attention",
        "train_postnorm_ffn", "train_encoder_layer", "train_decoder_layer"),
}


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Calls of each kernel wrapper the VAE's layers can reach (on the CPU
    every call reaches its wrapper, which runs the plain version)."""
    import importlib
    calls = {}
    for mod_name, names in _WRAPPERS.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            orig = getattr(mod, name)

            def counted(*a, _orig=orig, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _orig(*a, **k)
            monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("variant", ["prenorm", "sine"])
def test_prenorm_layers_call_no_kernel_wrapper(wrapper_calls, variant):
    """A pre-norm layer's route is decided from the module before any
    launch: encode and decode call none of the wrappers of kernels 5, 8,
    9, 10, 12, 13 or K2, in eval mode and in training mode, and the
    whole-layer gates say no; the post-norm layers of the same shapes call
    the wrappers."""
    from ladiff_torch.models.vae import LAVae
    vae = LAVae(NFEATS, (7, D), FF, LAYERS, H, frame_per_latent=FPL,
                train_whole_layer="1", **VAE_VARIANTS[variant])
    feats = t(rnd(np.random.RandomState(74), B, T, NFEATS))
    lengths = t(LENGTHS).long()
    with torch.no_grad():
        z = vae.encode(feats, lengths, sample_mean=True)[0]
        vae.decode(z, lengths, T)
    vae.train()
    z = vae.encode(feats, lengths, sample_mean=True)[0]
    vae.decode(z, lengths, T).sum().backward()
    prenorm = variant == "prenorm"
    assert bool(wrapper_calls) != prenorm, wrapper_calls
    if prenorm:
        layer = vae.decoder.middle_block
        assert not layer.takes_whole_layer(5)
        assert not layer.takes_whole_training_layer(T, 5)
        assert not vae.encoder.middle_block.takes_whole_training_layer(
            T + 10)


@pytest.mark.parametrize("variant", ["fixed7", "test_efficiency"])
def test_decoder_default_memory_mask_at_7_latents(variant):
    """The fixed-size set's decode without ``latent_valid`` masks the memory
    rows past ``ceil(len / 48)``, as the JAX package's ``decode`` does: at
    lengths 40 and 196 latents 5 and 6 change nothing (1 and 5 rows are
    attended to) although the encoder made all 7; latent 1 changes the
    196-frame sample only.  With ``TEST_EFFICIENCY`` the decoder attends to
    every row, so both change both samples.  Both against the JAX
    decode."""
    jv, p, tv = _vae_pair(variant)
    jv = jv.clone(frame_per_latent=48)
    tv.frame_per_latent = 48
    if variant == "fixed7":
        assert tv.n_lat == 7 and not tv.length_aware
    lengths = np.array([40, 196], np.int32)
    rng = np.random.RandomState(75)
    z = rnd(rng, 2, 7, D)
    moved = z.copy()
    moved[:, 5:] += rnd(rng, 2, 2, D, scale=3.0)
    one = z.copy()
    one[:, 1] += rnd(rng, 2, D, scale=3.0)

    def decode(latents):
        with torch.no_grad():
            return tv.decode(t(latents), t(lengths).long(), 196)

    base = decode(z)
    want = jv.apply({"params": p}, jnp.asarray(z), jnp.asarray(lengths),
                    nframes=196, method=jv.decode)
    assert relerr(base, want) <= TOL
    row1, row56 = decode(one), decode(moved)
    assert not torch.equal(row1[1], base[1])
    masked = variant == "fixed7"
    assert torch.equal(row1[0], base[0]) == masked
    assert torch.equal(row56, base) == masked
    tv.frame_per_latent = FPL


def test_vae_refuses_mlp_dist_against_a_max_it_mask():
    """``MLP_DIST`` with ``MAX_IT`` 5 and ``latent_dim[0]`` 7: 7 mu rows
    against a 5-row mask, which the JAX package cannot trace; the port
    says so when the module is built."""
    from ladiff_torch.models.vae import LAVae
    with pytest.raises(ValueError, match="mlp_dist.*5-row latent mask"):
        LAVae(NFEATS, (7, D), FF, LAYERS, H, max_it=5, mlp_dist=True)
    assert LAVae(NFEATS, (5, D), FF, LAYERS, H, max_it=5,
                 mlp_dist=True).global_motion_token.shape == (5, D)


# -- the systems --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _systems(switch):
    """The JAX and the port's systems of one switch on the same randomized
    weights, and a batch."""
    from ladiff_torch.models.ladiff import LADiffSystem as TS
    from ladiff_torch.models.vae import LAVae
    from ladiff_tpu.models.ladiff import LADiffSystem as JS
    kw = dict(nfeats=NFEATS, njoints=22, max_frames=T, latent_dim=(7, D),
              ff_size=FF, num_layers=LAYERS, num_heads=H,
              frame_per_latent=FPL, text_encoded_dim=TEXT,
              num_inference_timesteps=STEPS, guidance_uncondp=0.4,
              **SWITCHES[switch])
    options = VAE_OPTIONS.get(switch)
    if options:
        class JS(JS):  # noqa: F811 (the published system, other VAE)
            @property
            def vae(self):
                return super().vae.clone(**options)
    rng = np.random.RandomState(76)
    mean = rnd(rng, NFEATS, scale=0.1)
    std = (np.abs(rng.randn(NFEATS)) * 0.1 + 0.05).astype(np.float32)
    jsys = JS(dropout=0.0, mean=jnp.asarray(mean), std=jnp.asarray(std), **kw)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), 77)
    tsys = TS(mean=mean, std=std, device="cpu", **kw)
    if options:
        v = tsys.vae
        tsys.vae = LAVae(NFEATS, (7, D), FF, LAYERS, H, max_it=v.max_it,
                         frame_per_latent=FPL, lad=v.lad,
                         mlp_dist=v.mlp_dist,
                         test_efficiency=v.test_efficiency, **options)
        tsys.vae.compute_dtype = tsys.dtype
    tsys.load_state_dict(system_state_dict(params), strict=True)
    batch = {"motion": rnd(rng, B, T, NFEATS, scale=0.5), "length": LENGTHS,
             "text_emb": rnd(rng, B, 1, TEXT)}
    uncond = rnd(rng, 1, 1, TEXT, scale=0.1)
    return jsys, params, tsys, batch, uncond


def _torch_batch(batch):
    return {"motion": t(batch["motion"]), "length": t(batch["length"]).long(),
            "text_emb": t(batch["text_emb"])}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _normal(key, n):
    return t(np.asarray(jax.random.normal(key, (B, n, D), jnp.float32)))


def _diffusion_draws(key, n_lat):
    """What ``diffusion_forward`` of the JAX package draws from ``key``."""
    enc_rng, t_rng, n_rng, cfg_rng, _ = jax.random.split(key, 5)
    return {"eps": _normal(enc_rng, n_lat), "noise": _normal(n_rng, n_lat),
            "timesteps": t(np.asarray(jax.random.randint(
                t_rng, (B,), 0, 1000))).long(),
            "cond_drop": t(np.asarray(jax.random.bernoulli(
                cfg_rng, 0.4, (B, 1, 1))))}


def _grads_match(named, gtree, prefix, tol=PASS_TOL):
    """Every gradient of the JAX tree against the port's parameter of the
    same name (a parameter the port's graph never reached must have an
    all-zero JAX gradient)."""
    want = flax_state_dict(gtree, prefix)
    assert set(want) == {n for n in named if n.startswith(prefix)}
    for name, g in want.items():
        got = named[name].grad
        if got is None:
            assert not g.any(), name
        else:
            assert relerr(got, g.numpy()) <= tol, name


@pytest.mark.parametrize("switch", ["fixed7", "mlp_dist", "x0",
                                    "test_efficiency", "prenorm"])
def test_generate_matches_jax(switch):
    """CFG DDIM-3 and the decode from the JAX sampler's initial noise: the
    latents (7 rows, none masked, on the fixed-size set) and the features
    within 2e-3."""
    jsys, params, tsys, batch, uncond = _systems(switch)
    cond = batch["text_emb"]
    unc = np.repeat(uncond, B, 0)
    key = jax.random.PRNGKey(11)
    feats_j, z_j = jsys.generate(params, jnp.asarray(cond), jnp.asarray(unc),
                                 jnp.asarray(LENGTHS), key, nframes=T)
    n_lat = tsys.n_latents
    init = _normal(jax.random.split(key)[0], n_lat)
    feats_t, z_t = tsys.generate(t(cond), t(unc), t(LENGTHS).long(),
                                 nframes=T, init_latents=init)
    assert z_t.shape == (B, n_lat, D) == z_j.shape
    assert relerr(z_t, z_j) <= GEN_TOL
    assert relerr(feats_t, feats_j) <= GEN_TOL
    if n_lat == 7:
        assert bool(z_t.abs().amin(2).gt(0).all())
    assert not feats_t[2, LENGTHS[2]:].any()


@functools.lru_cache(maxsize=None)
def _jax_vae_forward(switch):
    jsys = _systems(switch)[0]
    return jax.jit(jax.value_and_grad(
        lambda p, b, key: jsys.vae_forward(p, b, key, train=True),
        has_aux=True))


@pytest.mark.parametrize("switch", ["fixed7", "mlp_dist", "test_efficiency",
                                    "prenorm"])
def test_vae_forward_matches_jax(switch):
    """Stage 1 in training mode at dropout 0: every loss term within 1e-4,
    the total and every VAE gradient within 1e-3."""
    jsys, params, tsys, batch, _ = _systems(switch)
    key = jax.random.PRNGKey(5)
    (want, (wlogs, waux)), gtree = _jax_vae_forward(switch)(
        params["vae"], _jax_batch(batch), key)
    n_eps = 7 if tsys.vae.mlp_dist else tsys.n_latents
    tsys.zero_grad(set_to_none=True)
    got, (logs, aux) = tsys.vae_forward(
        _torch_batch(batch), train=True,
        eps=_normal(jax.random.split(key, 3)[0], n_eps))
    assert aux["z"].shape == waux["z"].shape
    for k in ("recons_feature", "recons_joints", "kl_motion"):
        assert relerr(logs[k].detach(), wlogs[k]) <= TOL, k
    assert relerr(got.detach(), want) <= PASS_TOL
    got.backward()
    _grads_match(dict(tsys.named_parameters()), gtree, "vae.")
    tsys.zero_grad(set_to_none=True)


@functools.lru_cache(maxsize=None)
def _jax_diffusion_forward(switch):
    jsys = _systems(switch)[0]
    return jax.jit(jax.value_and_grad(
        lambda den, vae, b, key, unc: jsys.diffusion_forward(
            den, vae, b, key, unc, train=True), has_aux=True))


@pytest.mark.parametrize("switch", ["fixed7", "mlp_dist", "x0", "prenorm"])
def test_diffusion_forward_matches_jax(switch):
    """Stage 2 in training mode at dropout 0 with the JAX pass's draws: the
    loss (the x-loss under x0 prediction) and every denoiser gradient
    within 1e-3; on the fixed-size set no latent row is masked or
    re-zeroed."""
    jsys, params, tsys, batch, uncond = _systems(switch)
    key = jax.random.PRNGKey(4)
    (want, (wlogs, _)), gtree = _jax_diffusion_forward(switch)(
        params["denoiser"], params["vae"], _jax_batch(batch), key,
        jnp.asarray(uncond))
    n_eps = 7 if tsys.vae.mlp_dist else tsys.n_latents
    draws = _diffusion_draws(key, tsys.n_latents)
    draws["eps"] = _normal(jax.random.split(key, 5)[0], n_eps)
    tsys.zero_grad(set_to_none=True)
    got, (logs, aux) = tsys.diffusion_forward(_torch_batch(batch), t(uncond),
                                              train=True, **draws)
    assert set(logs) == set(wlogs) == (
        {"x_loss", "total"} if switch == "x0" else {"inst_loss", "total"})
    valid = aux["latent_valid"]
    assert valid.sum(1).tolist() == ([4, 3, 2, 2] if tsys.max_it
                                     else [7] * B)
    assert relerr(got.detach(), want) <= PASS_TOL
    got.backward()
    named = dict(tsys.named_parameters())
    _grads_match(named, gtree, "denoiser.")
    assert all(p.grad is None for n, p in named.items()
               if n.startswith("vae."))
    tsys.zero_grad(set_to_none=True)


def test_vae_diffusion_forward_with_every_switch_matches_jax():
    """The joint stage with every switch on (7 fixed latents, ``MLP_DIST``,
    ``TEST_EFFICIENCY``, x0 prediction) and the pre-norm, all-encoder,
    sine-PE VAE: every log term within 1e-4 and the gradients of both
    trees within 1e-3 over each tree, 5e-3 per tensor (the generated
    motion's joints integrate root velocities)."""
    jsys, params, tsys, batch, uncond = _systems("all")
    key = jax.random.PRNGKey(4)

    def loss(p):
        total, (logs, _) = jsys.vae_diffusion_forward(
            p, _jax_batch(batch), key, jnp.asarray(uncond), train=True)
        return total, logs

    (want, wlogs), gtree = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    vae_rng, diff_rng, gen_rng = jax.random.split(key, 3)
    draws = _diffusion_draws(diff_rng, 7)
    tsys.zero_grad(set_to_none=True)
    got, (logs, _) = tsys.vae_diffusion_forward(
        _torch_batch(batch), t(uncond), train=True,
        eps=_normal(jax.random.split(vae_rng, 3)[0], 7),
        diffusion_draws=draws,
        init_latents=_normal(jax.random.split(gen_rng)[0], 7))
    assert set(logs) == set(wlogs) and "diff_x_loss" in logs
    for k in logs:
        assert relerr(logs[k].detach(), wlogs[k]) <= TOL, k
    got.backward()
    named = dict(tsys.named_parameters())
    for tree in ("vae", "denoiser"):
        gwant = flax_state_dict(gtree[tree], tree + ".")
        gg = {n: (torch.zeros_like(named[n]) if named[n].grad is None
                  else named[n].grad) for n in gwant}
        for n, g in gwant.items():
            assert relerr(gg[n], g.numpy()) <= 5e-3, n
        flat = lambda d: np.concatenate(
            [np.asarray(d[n]).reshape(-1) for n in sorted(gwant)])
        assert relerr(flat(gg), flat(gwant)) <= PASS_TOL, tree
    tsys.zero_grad(set_to_none=True)


def test_distill_forward_with_every_switch_matches_jax():
    """The distill pass with every switch on: the teacher's half-steps
    read x0 predictions through the schedule, nothing is re-zeroed on the
    fixed-size set; the loss within 1e-4 and every student gradient within
    1e-3."""
    from ladiff_torch.training.distill import distill_forward
    from ladiff_tpu.training.distill import distill_forward as jax_distill
    jsys, params, tsys, batch, uncond = _systems("all")
    student_params = randomize(params["denoiser"], 78)
    key = jax.random.PRNGKey(3)

    def loss(sp):
        return jax_distill(jsys, sp, params["denoiser"], params["vae"],
                           _jax_batch(batch), key, jnp.asarray(uncond), 2)

    (want, (wlogs, _)), gtree = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(student_params)
    enc, i_k, n_k, _ = jax.random.split(key, 4)
    student = type(tsys.denoiser)(
        NFEATS, (7, D), FF, LAYERS, H, TEXT)
    student.load_state_dict(flax_state_dict(student_params), strict=True)
    got, (logs, _) = distill_forward(
        tsys, student, tsys.denoiser, _torch_batch(batch), t(uncond), 2,
        i=t(np.asarray(jax.random.randint(i_k, (B,), 0, 2))).long(),
        noise=_normal(n_k, 7), eps=_normal(enc, 7))
    assert relerr(got.detach(), want) <= TOL
    assert relerr(logs["raw_x0_mse"], wlogs["raw_x0_mse"]) <= TOL
    got.backward()
    named = dict(student.named_parameters())
    _grads_match(named, gtree, "")


def test_ar_without_lad_under_x0_matches_jax():
    """``ARDIFF`` with ``LAD`` off at ``MAX_IT`` 5 and x0 prediction: the
    sampler masks the tokens by length whatever ``LAD`` says (the JAX
    package's), each token's initial noise handed in; the AR stage-2
    pass's x-loss and every denoiser gradient within 1e-3."""
    jsys, params, tsys, batch, uncond = _systems("ar")
    cond, unc = batch["text_emb"], np.repeat(uncond, B, 0)
    key = jax.random.PRNGKey(9)
    feats_j, z_j = jax.jit(functools.partial(jsys.generate, nframes=T))(
        params, jnp.asarray(cond), jnp.asarray(unc), jnp.asarray(LENGTHS),
        key)
    init = []
    for _ in range(5):
        key, k = jax.random.split(key)
        init.append(np.asarray(jax.random.normal(k, (B, 1, D), jnp.float32)))
    feats_t, z_t = tsys.generate(t(cond), t(unc), t(LENGTHS).long(),
                                 nframes=T, init_latents=t(np.concatenate(
                                     init, 1)))
    assert relerr(z_t, z_j) <= GEN_TOL and relerr(feats_t, feats_j) <= GEN_TOL
    assert not z_t[2, 2:].any()

    key = jax.random.PRNGKey(1)
    (want, (wlogs, _)), gtree = jax.jit(jax.value_and_grad(
        lambda den: jsys.diffusion_forward_ar(
            den, params["vae"], _jax_batch(batch), key, jnp.asarray(uncond)),
        has_aux=True))(params["denoiser"])
    enc, t_k, n_k, cfg_k, _, idx_k, coin_k = jax.random.split(key, 7)
    u = np.asarray(jax.random.uniform(idx_k, (B,)))
    idx = np.minimum(1 + np.floor(u * 4).astype(np.int64), 4)  # 5 active
    tsys.zero_grad(set_to_none=True)
    got, (logs, aux) = tsys.diffusion_forward_ar(
        _torch_batch(batch), t(uncond), eps=_normal(enc, 5),
        noise=t(np.asarray(jax.random.normal(n_k, (B, 1, D), jnp.float32))),
        timesteps=t(np.asarray(jax.random.randint(t_k, (B,), 0,
                                                  1000))).long(),
        cond_drop=t(np.asarray(jax.random.bernoulli(cfg_k, 0.4, (B, 1, 1)))),
        latent_idx=torch.from_numpy(idx),
        coin=t(np.asarray(jax.random.uniform(coin_k, ()) < 1.0 / 3.0)))
    assert bool(aux["latent_valid"].all())
    assert set(logs) == set(wlogs) == {"x_loss", "total"}
    assert relerr(got.detach(), want) <= PASS_TOL
    got.backward()
    _grads_match(dict(tsys.named_parameters()), gtree, "denoiser.")
    tsys.zero_grad(set_to_none=True)


# -- configurations and refusals ----------------------------------------------

def _cfg(name, abl=None, **over):
    from ladiff_torch.config import assemble_config
    if abl:
        over = {**over, "TRAIN": {"ABLATION": abl}}
    return assemble_config(os.path.join(REPO, "configs", name),
                           os.path.join(REPO, "configs", "assets.yaml"),
                           overrides=over or None)


CFG_SWITCHES = {
    "fixed7": ({"LAD": False, "MAX_IT": 0}, {}),
    "mlp_dist": ({"LAD": False, "MAX_IT": 0, "MLP_DIST": True}, {}),
    "x0": ({"PREDICT_EPSILON": False}, {}),
    "test_efficiency": ({"TEST_EFFICIENCY": True}, {}),
    "relu": ({}, {"model": {"activation": "relu"}}),
}


@pytest.mark.parametrize("switch,stage", [
    *((name, "diffusion") for name in CFG_SWITCHES),
    ("fixed7", "vae"), ("mlp_dist", "vae")])
def test_from_cfg_builds_each_switch_as_jax(switch, stage):
    """Each switch set in a copy of the shipped stage-1 or stage-2
    HumanML3D configuration: both packages read it the same way, and the
    JAX package's parameters at the published width load with
    ``strict=True``; ``model.activation`` is read by neither (GELU)."""
    from ladiff_torch.models.ladiff import LADiffSystem as TS
    from ladiff_tpu.models.ladiff import LADiffSystem as JS
    name = ("config_vae_humanml3d.yaml" if stage == "vae"
            else "config_ladiff_humanml3d.yaml")
    abl, over = CFG_SWITCHES[switch]
    cfg = _cfg(name, abl, **over)
    jsys = JS.from_cfg(cfg, nfeats=NFEATS, njoints=22)
    tsys = TS.from_cfg(cfg, nfeats=NFEATS, njoints=22, device="cpu")
    for attr in ("max_it", "lad", "predict_epsilon"):
        assert getattr(tsys, attr) == getattr(jsys, attr), attr
    vae = tsys.vae
    assert (vae.lad, vae.mlp_dist, vae.test_efficiency) == (
        jsys.lad, jsys.mlp_dist, jsys.test_efficiency)
    assert tsys.n_latents == (jsys.max_it or 7)
    assert tsys.schedule.prediction_type == jsys.schedule.prediction_type
    layers = [*vae.encoder.ordered_blocks(), *vae.decoder.ordered_blocks()]
    assert {layer.activation for layer in layers} == {jsys.vae.activation} \
        == {"gelu"}
    shapes = jax.eval_shape(jsys.init_params, jax.random.PRNGKey(0))
    sd = system_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    if stage == "vae":  # the port keeps the MD-trans denoiser there
        tsys.vae.load_state_dict({k[4:]: v for k, v in sd.items()
                                  if k.startswith("vae.")}, strict=True)
    else:
        tsys.load_state_dict(sd, strict=True)
    if switch == "mlp_dist":
        assert sd["vae.dist_layer.weight"].shape == (512, 256)
        assert sd["vae.global_motion_token"].shape == (7, 256)


def test_refusals_where_the_jax_package_has_no_working_path(tmp_path):
    """With ``MAX_IT`` 0 there are no token positions: the AR sampler and
    the demo's ``random_latent`` and ``--latentwise_gen`` raise
    ``ValueError``s that say so (AR training and the demo's other tasks
    run)."""
    from ladiff_torch import demo
    from ladiff_torch.models.ladiff import LADiffSystem as TS
    kw = dict(nfeats=NFEATS, njoints=22, max_frames=T, latent_dim=(7, D),
              ff_size=FF, num_layers=LAYERS, num_heads=H,
              text_encoded_dim=TEXT, num_inference_timesteps=1, max_it=0,
              lad=False, device="cpu")
    ar = TS(ardiff=True, **kw)
    text = torch.zeros(1, 1, TEXT)
    with pytest.raises(ValueError, match="max_it .*MAX_IT.* 0"):
        ar.generate(text, text, torch.tensor([T]))
    with torch.no_grad():
        ar.diffusion_forward_ar(
            {"motion": torch.zeros(1, T, NFEATS), "length": torch.tensor([T]),
             "text_emb": text}, text, generator=torch.Generator())
    fixed = TS(**kw)
    for task, latentwise in (("random_latent", None), ("text_motion", "fw")):
        with pytest.raises(ValueError, match="MAX_IT 0"):
            demo.check_latent_tasks(fixed, task, latentwise)
    demo.check_latent_tasks(fixed, "text_motion", None)
    demo.check_latent_tasks(fixed, "reconstruction", None)
