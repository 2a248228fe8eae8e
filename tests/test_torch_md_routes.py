"""Generation's other denoiser routes in the PyTorch port against the JAX
package, on the CPU: the whole-stack kernel's plain version (kernel 11),
the stylized FFN (kernel 6) and the one-token stylize (kernel 7) against
their Pallas kernels in interpret mode and their modules; the MD layer's
per-block route and the route gate; the VAE decoder layer's route by
shape; the sampler's options (eta > 0, DDPM,
the beta schedules and prediction types, the DDIM inversion,
trajectories).  ``generate`` on these routes and the CLIP encoder's
full-context mode are in test_torch_routes_generate.py.

Tolerance 1e-4 norm-wise for modules and kernels' plain versions (both
sides float32, sums in another order; see test_torch_modules.py).  Which
route a layer takes is seen through the kernel wrappers the stylization
module calls (each takes its plain version on a CPU tensor and counts
nothing there): the ``calls`` fixture.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_modules import port, randomize, relerr, rnd, t

TOL = 1e-4
D, H, FF = 128, 2, 256


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of each kernel wrapper that the MD modules make."""
    from ladiff_torch.ops import stylization as st
    counts = {}

    def spy(name):
        fn = getattr(st, name)

        def wrapped(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(st, name, wrapped)

    for name in ("fused_md_layer", "fused_md_stack", "fused_stylized_ffn",
                 "fused_broadcast_stylize"):
        spy(name)
    return counts


# -- kernel 11: the whole stack --------------------------------------------

def _stack_setup(B, masked, seed, L=3, T=5):
    from ladiff_torch.ops.stylization import MDSkipTransformerEncoder as TE
    from ladiff_tpu.ops.stylization import MDSkipTransformerEncoder as JE
    rng = np.random.RandomState(seed)
    x, xf = rnd(rng, B, T, D, scale=0.5), rnd(rng, B, 1, D)
    time_row = rnd(rng, D)
    emb = np.repeat(time_row[None], B, 0)  # a sampling step's shared row
    valid = (np.arange(T)[None] < rng.randint(1, T + 1, (B, 1))
             if masked else None)
    je = JE(D, D, H, L, FF, 0.0)
    p = randomize(je.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(xf), jnp.asarray(emb),
                          None if valid is None else jnp.asarray(valid))
                  ["params"], seed + 1)
    return je, p, port(TE(D, D, H, L, FF), p), x, xf, emb, time_row, valid


@pytest.mark.parametrize("case", ["masked_b5", "two_blocks_b16", "no_mask"])
def test_md_stack_plain_matches_pallas_and_module(interpret, monkeypatch,
                                                  case):
    """Kernel 11's plain version against the JAX kernel (interpret mode,
    the stacked params and prep of the JAX sampling path) and against the
    JAX skip encoder; the port's encoder on its stack route too."""
    from ladiff_torch.ops.md_stack import md_stack_plain
    from ladiff_tpu.ops.pallas_md_stack import fused_md_stack
    B = 16 if case == "two_blocks_b16" else 5
    if case == "two_blocks_b16":
        monkeypatch.setenv("LADIFF_MD_BLOCK", "8")
    je, p, te, x, xf, emb, time_row, valid = _stack_setup(
        B, case != "no_mask", {"masked_b5": 40, "two_blocks_b16": 42,
                               "no_mask": 44}[case])
    T = x.shape[1]
    jv = None if valid is None else jnp.asarray(valid)
    want = je.apply({"params": p}, jnp.asarray(x), jnp.asarray(xf),
                    jnp.asarray(emb), jv)
    jp = {"params": p}
    prep_all = je.apply(jp, jnp.asarray(xf), jnp.asarray(time_row[None]),
                        method=je.precompute_prep)
    values, ca_t, ffn_t = je.apply(jp, prep_all, method=je.stack_prep)
    stacked = je.apply(jp, method=je.stacked_params)
    kvalid = (np.ones((B, T), np.float32) if valid is None
              else valid.astype(np.float32)).reshape(B * T)
    extra = np.concatenate([xf, emb[:, None]], 1).reshape(B * 2, D)
    want_k = fused_md_stack(jnp.asarray(x.reshape(B * T, D)),
                            jnp.asarray(extra), jnp.asarray(kvalid[:, None]),
                            values, ca_t[0], ffn_t[0], stacked, T=T, E=2, H=H)

    with torch.no_grad():
        values_t, ca_tt, ffn_tt = te.stack_prep(te.precompute_prep(
            t(xf), t(time_row[None]), with_params=False))
        st = te.stacked_params(torch.float32)
        got = md_stack_plain(t(x.reshape(B * T, D)), t(extra), t(kvalid),
                             values_t, ca_tt[0], ffn_tt[0], st, T=T, E=2,
                             H=H)
        route = te(t(x), t(xf), t(emb), None if valid is None else t(valid),
                   prep={"stack": {"params": st, "values": values_t,
                                   "ca_ss": ca_tt[0], "ffn_ss": ffn_tt[0]}})
    assert relerr(got, want_k) <= TOL
    assert relerr(got, np.asarray(want).reshape(B * T, D)) <= TOL
    assert relerr(route, want) <= TOL


# -- kernel 6: the stylized FFN --------------------------------------------

def test_stylized_ffn_plain_matches_pallas_and_module(interpret, calls):
    from ladiff_torch.ops.stylization import StylizedFFN as TM
    from ladiff_torch.ops.stylized_ffn import stylized_ffn_plain
    from ladiff_tpu.ops.pallas_fused_ffn import fused_stylized_ffn
    from ladiff_tpu.ops.stylization import StylizedFFN as JM
    rng = np.random.RandomState(50)
    B, T = 3, 5
    x, emb = rnd(rng, B, T, D, scale=0.5), rnd(rng, B, D)
    jm = JM(D, FF, 0.0)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(emb))["params"], 51)
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(emb))
    po = p["proj_out"]
    ss = np.asarray(jax.nn.silu(emb) @ po["emb_layers_1"]["kernel"]
                    + po["emb_layers_1"]["bias"])
    want_k = fused_stylized_ffn(
        jnp.asarray(x.reshape(B * T, D)),
        jnp.asarray(np.repeat(ss[:, :D], T, 0)),
        jnp.asarray(np.repeat(ss[:, D:], T, 0)),
        p["linear1"]["kernel"], p["linear1"]["bias"],
        p["linear2"]["kernel"], p["linear2"]["bias"],
        po["norm"]["scale"], po["norm"]["bias"],
        po["out_layers_2"]["kernel"], po["out_layers_2"]["bias"])
    tm = port(TM(D, FF), p)
    w = [tm.linear1.weight, tm.linear1.bias, tm.linear2.weight,
         tm.linear2.bias, tm.proj_out.norm.weight, tm.proj_out.norm.bias,
         tm.proj_out.out_layers[2].weight, tm.proj_out.out_layers[2].bias]
    with torch.no_grad():
        got = stylized_ffn_plain(t(x.reshape(B * T, D)), t(ss), *w, T=T)
        module = tm(t(x), t(emb))
        # one AdaLN row shared by every sample: the sampling layout
        shared = stylized_ffn_plain(t(x.reshape(B * T, D)), t(ss[:1]), *w,
                                    T=T)
    assert relerr(got, want_k) <= TOL
    assert relerr(module, want) <= TOL
    assert calls == {"fused_stylized_ffn": 1}
    want_shared = fused_stylized_ffn(
        jnp.asarray(x.reshape(B * T, D)),
        jnp.asarray(np.repeat(ss[:1, :D], B * T, 0)),
        jnp.asarray(np.repeat(ss[:1, D:], B * T, 0)),
        p["linear1"]["kernel"], p["linear1"]["bias"],
        p["linear2"]["kernel"], p["linear2"]["bias"],
        po["norm"]["scale"], po["norm"]["bias"],
        po["out_layers_2"]["kernel"], po["out_layers_2"]["bias"])
    assert relerr(shared, want_shared) <= TOL


# -- kernel 7: the one-token stylize ---------------------------------------

def test_broadcast_stylize_plain_matches_pallas_and_module(interpret, calls):
    from ladiff_torch.ops.stylization import \
        LinearTemporalCrossAttention as TM
    from ladiff_torch.ops.stylize import broadcast_stylize_plain
    from ladiff_tpu.ops.pallas_stylize import fused_broadcast_stylize
    from ladiff_tpu.ops.stylization import LinearTemporalCrossAttention as JM
    rng = np.random.RandomState(52)
    B, T = 3, 5
    x, xf = rnd(rng, B, T, D, scale=0.5), rnd(rng, B, 1, D)
    emb = rnd(rng, B, D)
    valid = np.arange(T)[None] < np.array([[T], [2], [1]])
    jm = JM(D, D, H, 0.0)
    args = tuple(map(jnp.asarray, (x, xf, emb, valid)))
    p = randomize(jm.init(jax.random.PRNGKey(0), *args)["params"], 53)
    want = jm.apply({"params": p}, *args)
    po = p["proj_out"]
    # the text value row as the JAX module computes it
    x0 = xf[:, 0].astype(np.float64)
    tn = ((x0 - x0.mean(-1, keepdims=True))
          / np.sqrt(x0.var(-1, keepdims=True) + 1e-5)
          * np.asarray(p["text_norm"]["scale"])
          + np.asarray(p["text_norm"]["bias"]))
    value = (tn @ np.asarray(p["value"]["kernel"])
             + np.asarray(p["value"]["bias"])).astype(np.float32)
    ss = np.asarray(jax.nn.silu(emb) @ po["emb_layers_1"]["kernel"]
                    + po["emb_layers_1"]["bias"])
    mask = valid.astype(np.float32).reshape(B * T)
    want_k = fused_broadcast_stylize(
        jnp.asarray(x.reshape(B * T, D)), jnp.asarray(np.repeat(value, T, 0)),
        jnp.asarray(mask[:, None]), jnp.asarray(np.repeat(ss[:, :D], T, 0)),
        jnp.asarray(np.repeat(ss[:, D:], T, 0)), po["norm"]["scale"],
        po["norm"]["bias"], po["out_layers_2"]["kernel"],
        po["out_layers_2"]["bias"])
    tm = port(TM(D, D, H), p)
    pr = tm.proj_out
    with torch.no_grad():
        got = broadcast_stylize_plain(
            t(x.reshape(B * T, D)), t(value), t(mask),
            t(ss), pr.norm.weight, pr.norm.bias, pr.out_layers[2].weight,
            pr.out_layers[2].bias, T=T)
        module = tm(t(x), t(xf), t(emb), t(valid))
    assert relerr(got, want_k) <= TOL
    assert relerr(module, want) <= TOL
    assert calls == {"fused_broadcast_stylize": 1}


# -- the MD layer's per-block route at inference ---------------------------

@pytest.mark.parametrize("case", ["one_token_head_width_256", "text_9"])
def test_md_layer_per_block_route_matches_jax(calls, case):
    """One text token at head width 256 (K1 takes at most 128): sa_block,
    kernel 7, kernel 6; nine text tokens: sa_block, the plain linear
    cross-attention, kernel 6."""
    from ladiff_torch.ops.stylization import MDTransformerLayer as TL
    from ladiff_tpu.ops.stylization import MDTransformerLayer as JL
    d, h, n = (256, 1, 1) if case == "one_token_head_width_256" else (D, H,
                                                                      9)
    rng = np.random.RandomState(54)
    B, T = 3, 5
    x, xf = rnd(rng, B, T, d, scale=0.5), rnd(rng, B, n, d)
    emb = rnd(rng, B, d)
    valid = np.arange(T)[None] < np.array([[T], [2], [1]])
    jl = JL(d, d, FF, h, 0.0)
    args = tuple(map(jnp.asarray, (x, xf, emb, valid)))
    p = randomize(jl.init(jax.random.PRNGKey(0), *args)["params"], 55)
    tl = port(TL(d, d, FF, h), p)
    assert not tl.takes_whole_layer(t(x), t(xf))
    with torch.no_grad():
        got = tl(t(x), t(xf), t(emb), t(valid))
    assert relerr(got, jl.apply({"params": p}, *args)) <= TOL
    want_calls = {"fused_stylized_ffn": 1}
    if n == 1:
        want_calls["fused_broadcast_stylize"] = 1
    assert calls == want_calls


def test_md_layer_route_gate():
    """Every published MD shape takes K1; a head split across the
    cluster's CTAs (head width 256 or 128 at D 256), a width that is not a
    multiple of 64, an FFN width that is not a multiple of D, a shape whose
    CTA needs more shared memory than the card has, more text tokens or
    training mode take the per-block route."""
    from ladiff_torch.ops.md_layer import md_layer_supported, md_smem_bytes
    from ladiff_torch.ops.stylization import MDTransformerLayer as TL
    assert md_layer_supported(512, 5, 2, 256, 4, 1024, 1024)
    assert not md_layer_supported(512, 5, 2, 256, 1, 1024, 1024)
    assert not md_layer_supported(512, 33, 2, 256, 4, 1024, 1024)
    assert not md_layer_supported(512, 5, 2, 512, 8, 1024, 1024)
    # the cluster body: C = D / 64 CTAs, whole heads in each CTA
    assert not md_layer_supported(512, 5, 2, 256, 2, 1024, 1024)
    assert md_layer_supported(512, 5, 2, 256, 8, 1024, 1024)
    assert not md_layer_supported(512, 5, 2, 96, 2, 1024, 1024)
    assert not md_layer_supported(512, 5, 2, 128, 32, 1024, 1024)
    assert md_layer_supported(3, 5, 2, 128, 2, 1024, 256)
    assert md_layer_supported(3, 5, 2, 64, 4, 1024, 128)
    assert not md_layer_supported(512, 5, 2, 256, 4, 1000, 1024)
    assert md_layer_supported(1, 32, 32, 256, 4, 1024, 1024)
    assert not md_layer_supported(1, 5, 33, 256, 4, 1024, 1024)
    # shared memory: the published shape fits an H100's 227 KB per block,
    # the FFN partials of F 2048 at D 256 do not
    assert md_smem_bytes(256, 1024, 1024) == 232320
    assert md_smem_bytes(256, 1024, 2048) > 232448
    assert not md_layer_supported(512, 5, 2, 256, 4, 1024, 2048)
    # the weight segments of a layer fit the CTA's table of 48
    assert not md_layer_supported(3, 5, 2, 64, 4, 1024, 4096)
    layer = TL(256, 256, 1024, 4).eval()
    x, xf = torch.zeros(2, 5, 256), torch.zeros(2, 1, 256)
    assert layer.takes_whole_layer(x, xf)
    assert not layer.takes_whole_layer(x, torch.zeros(2, 9, 256))
    assert not layer.train().takes_whole_layer(x, xf)
    assert not TL(256, 256, 1024, 1).eval().takes_whole_layer(x, xf)


@pytest.mark.parametrize("B", [1, 7, 128, 512])
def test_md_launch_geometry(B):
    """K1's and kernel 11's row groups cover every sample exactly once, in
    whole samples of at most 96 latent and 48 extra rows; at 2B = 512
    samples on the 30 clusters an H100 holds they fill the card once (29
    groups of 18 samples, 116 CTAs); a requested group size is capped."""
    from ladiff_torch.ops.md_layer import md_geometry
    for T, E, D, slots in ((5, 2, 256, 32), (1, 2, 128, 66), (32, 2, 64, 7)):
        spg, groups, C, ctas = md_geometry(B, T, E, D, slots)
        assert C == D // 64 and ctas == groups * C
        assert spg * T <= 96 and spg * E <= 48 and spg >= 1
        covered = [s for g in range(groups)
                   for s in range(g * spg, min(B, (g + 1) * spg))]
        assert covered == list(range(B))
        if spg < min(96 // T, 48 // E):  # not capped: one cluster per slot
            assert groups <= slots
    assert md_geometry(512, 5, 2, 256, 30) == (18, 29, 4, 116)
    assert md_geometry(B, 5, 2, 256, 30, spg=99)[0] == 19
    assert md_geometry(B, 5, 2, 256, 30, spg=4)[:2] == (4, -(-B // 4))


# -- the VAE decoder layer's route at inference ----------------------------

@pytest.fixture
def layer_calls(monkeypatch):
    """Counts the calls of the kernel wrappers that the encoder and decoder
    layers make (K2, kernel 5, kernel 10)."""
    from ladiff_torch.ops import attention, transformer
    counts = {}
    for mod, name in ((transformer, "fused_decoder_layer"),
                      (transformer, "fused_postnorm_ffn"),
                      (attention, "fused_masked_attention")):
        def wrapped(*a, _fn=getattr(mod, name), _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return counts


# case: (width, heads, FFN width, memory rows) and the wrappers the layer
# calls at inference
_DECODER_ROUTES = {
    "head_width_256": ((256, 1, FF, 5), {"fused_postnorm_ffn": 1}),
    "head_width_64": ((D, H, FF, 5), {"fused_decoder_layer": 1}),
    "ffn_width_96": ((D, H, 96, 5), {"fused_masked_attention": 1}),
    "memory_rows_9": ((D, H, FF, 9), {"fused_masked_attention": 1,
                                      "fused_postnorm_ffn": 1}),
}


@pytest.mark.parametrize("case", list(_DECODER_ROUTES))
def test_decoder_layer_route_matches_jax(layer_calls, case):
    """A shape K2 takes runs the whole layer as K2; one it refuses runs per
    block, as the JAX package's gate sends it to its plain path: head
    width 256 (plain attention over the 70 frames, which kernel 10 does not
    take either, the plain cross-attention, kernel 5), an FFN width that is
    not a multiple of 128 (kernel 10, the plain cross-attention and FFN)
    and 9 memory rows (kernels 10 and 5)."""
    from ladiff_torch.ops.transformer import TransformerDecoderLayer as TL
    from ladiff_tpu.ops.transformer import TransformerDecoderLayer as JL
    (d, h, ff, L), calls = _DECODER_ROUTES[case]
    rng = np.random.RandomState(56)
    T = 70
    tgt, mem = rnd(rng, 3, T, d, scale=0.5), rnd(rng, 3, L, d)
    tv = np.arange(T)[None] < np.array([[T], [T // 2], [3]])
    mv = np.arange(L)[None] < np.array([[L], [2], [1]])
    jl = JL(d, h, ff, 0.0, "gelu")
    args = tuple(map(jnp.asarray, (tgt, mem, tv, mv)))
    p = randomize(jl.init(jax.random.PRNGKey(0), *args[:2])["params"], 57)
    tl = port(TL(d, h, ff, "gelu"), p)
    assert tl.takes_whole_layer(L) == (case == "head_width_64")
    with torch.no_grad():
        got = tl(t(tgt), t(mem), t(tv), t(mv))
    assert relerr(got, jl.apply({"params": p}, *args)) <= TOL
    assert layer_calls == calls


def test_decoder_and_attention_route_gates():
    """Every published shape takes K2 and kernel 10; a head width above
    128 or one that is not a multiple of 16 takes neither."""
    from ladiff_torch.ops.attention_kernel import masked_attention_supported
    from ladiff_torch.ops.decoder_layer import decoder_layer_supported
    assert decoder_layer_supported(256, 4, 1024, "gelu")
    assert decoder_layer_supported(256, 2, 1024, "relu")
    assert not decoder_layer_supported(256, 1, 1024, "gelu")
    assert not decoder_layer_supported(256, 4, 1024, "silu")
    assert not decoder_layer_supported(512, 8, 1024, "gelu")
    assert not decoder_layer_supported(96, 4, 1024, "gelu")
    assert masked_attention_supported(128, 206, 256, 4)
    assert not masked_attention_supported(128, 206, 256, 1)
    assert not masked_attention_supported(128, 206, 96, 4)
    assert not masked_attention_supported(65536, 206, 256, 4)


# K2's gate, case by case: (D, H, F, activation, memory rows) -> takes it
@pytest.mark.parametrize("D_,H_,F_,act,L_,want", [
    (256, 4, 1024, "gelu", 5, True),   # the published decoder layers
    (256, 2, 1024, "relu", 5, True),   # head width 128, the tile's widest
    (64, 2, 256, "gelu", 5, True),     # the tail's narrowest instantiation
    (192, 4, 768, "gelu", 8, True),    # head width 48, 8 memory rows
    (128, 8, 128, "gelu", 1, True),    # head width 16, one FFN chunk
    (256, 1, 1024, "gelu", 5, False),  # head width 256
    (96, 4, 1024, "gelu", 5, False),   # head width 24
    (160, 2, 640, "gelu", 5, False),   # D not a multiple of 64
    (512, 8, 1024, "gelu", 5, False),  # D above 256
    (256, 4, 96, "gelu", 5, False),    # F not a multiple of 128
    (256, 4, 1024, "gelu", 9, False),  # more memory rows than lane quads
    (256, 4, 1024, "gelu", 0, False),  # no memory row
    (256, 4, 1024, "silu", 5, False),  # an activation the tail lacks
])
def test_decoder_layer_gate(D_, H_, F_, act, L_, want):
    from ladiff_torch.ops.decoder_layer import decoder_layer_supported
    assert decoder_layer_supported(D_, H_, F_, act, L_) is want


# -- the sampler's options -------------------------------------------------

@pytest.mark.parametrize("beta_schedule,prediction_type", itertools.product(
    ["linear", "scaled_linear", "squaredcos_cap_v2"],
    ["epsilon", "sample", "v_prediction"]))
def test_sampler_steps_match_jax(beta_schedule, prediction_type):
    """Tables, the DDIM step at eta 0 and 0.7 (the JAX function's noise fed
    in), the DDPM step over a multi-step jump, at t = 0 and on the full
    grid, and the DDIM inversion, per schedule and prediction type."""
    from ladiff_torch.diffusion import schedulers as ts_
    from ladiff_tpu.diffusion import schedulers as js_
    kw = dict(beta_schedule=beta_schedule, prediction_type=prediction_type)
    jsch, tsch = js_.make_schedule(**kw), ts_.make_schedule(**kw)
    np.testing.assert_allclose(tsch.alphas_cumprod,
                               np.asarray(jsch.alphas_cumprod), rtol=1e-6)
    rng = np.random.RandomState(60)
    out, x = rnd(rng, 2, 5, 8), rnd(rng, 2, 5, 8)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (2, 5, 8)))
    for step, prev in ((981, 961), (521, 501), (21, 1), (1, -19)):
        for eta in (0.0, 0.7):
            want = jsch.ddim_step(jnp.asarray(out), step, prev,
                                  jnp.asarray(x), eta=eta,
                                  noise=jnp.asarray(noise))
            got = tsch.ddim_step(t(out), step, prev, t(x), eta=eta,
                                 noise=t(noise))
            assert relerr(got, want) <= TOL, (step, eta)
    for step, prev in ((980, 960), (500, 480), (20, 0), (0, -20), (7, None)):
        want = jsch.ddpm_step(jnp.asarray(out), step, jnp.asarray(x),
                              jnp.asarray(noise), prev_timestep=prev)
        got = tsch.ddpm_step(t(out), step, t(x), t(noise),
                             prev_timestep=prev)
        assert relerr(got, want) <= TOL, (step, prev)
    x_next = rnd(rng, 2, 5, 8)
    tt, tn = np.array([981, 21], np.int32), np.array([961, -19], np.int32)
    want = js_.ddim_solve_eps_x0(jsch, jnp.asarray(x), jnp.asarray(x_next),
                                 jnp.asarray(tt), jnp.asarray(tn))
    got = ts_.ddim_solve_eps_x0(tsch, t(x), t(x_next), t(tt).long(),
                                t(tn).long())
    for g, w in zip(got, want):
        assert relerr(g, w) <= TOL


@pytest.mark.parametrize("kind,eta", [("ddim", 0.0), ("ddim", 0.5),
                                      ("ddpm", 0.0)])
def test_sampler_loop_matches_jax(monkeypatch, kind, eta):
    """The whole loop with CFG and re-masking, every step's latents: the
    JAX sampler's own draws (its initial noise and each step's noise, from
    its key) are fed to the port in their order."""
    from ladiff_torch.diffusion import sampling as tsm
    from ladiff_torch.diffusion.schedulers import make_schedule as tmk
    from ladiff_tpu.diffusion import sampling as jsm
    from ladiff_tpu.diffusion.schedulers import make_schedule as jmk
    rng = np.random.RandomState(61)
    B, steps, shape = 3, 6, (3, 5, 8)
    w = rnd(rng, 8, 8, scale=0.2)
    cu, cc = rnd(rng, B, 1, 8), rnd(rng, B, 1, 8)
    valid = np.arange(5)[None] < np.array([[5], [3], [1]])
    key = jax.random.PRNGKey(5)

    def jden(lat, tt, text, v, aux):
        return jnp.tanh(lat @ w + text) * 0.5

    def tden(lat, step, text, v):
        return torch.tanh(lat @ t(w) + text) * 0.5

    want, want_traj = jsm.ddim_sample(
        jsm.make_cfg_denoise_fn(jden, jnp.asarray(cu), jnp.asarray(cc), 7.5),
        jmk(), key, shape, steps, latent_valid=jnp.asarray(valid), eta=eta,
        kind=kind, return_trajectory=True)
    init_key, noise_key = jax.random.split(key)
    draws = []
    for _ in range(steps):
        noise_key, step_key = jax.random.split(noise_key)
        draws.append(torch.from_numpy(np.asarray(
            jax.random.normal(step_key, shape, jnp.float32))))
    monkeypatch.setattr(torch, "randn", lambda *a, **k: draws.pop(0))
    got, traj = tsm.ddim_sample(
        tsm.make_cfg_denoise_fn(tden, t(cu), t(cc), 7.5), tmk(), shape,
        steps, latent_valid=t(valid), eta=eta, kind=kind,
        init_latents=t(jax.random.normal(init_key, shape)),
        return_trajectory=True)
    assert draws == [] if (kind == "ddpm" or eta > 0) else len(draws) == steps
    assert traj.shape == (steps, *shape)
    assert relerr(got, want) <= TOL
    assert relerr(traj, want_traj) <= TOL
    assert not traj[:, 2, 1:].any()
