"""The port's MotionDiffuse (``MotionTransformer``) against the JAX package
on the CPU, on converted weights filled with noise (the zero-init output
projections included): each attention block with and without frame masks,
both decoder-layer flavours, ``encode_text``, the whole model in both
flavours with and without lengths, gradients against ``jax.grad``; and the
JAX package's own torch converter (``convert_torch_motion_transformer``)
applied to the port's ``state_dict()`` gives back the JAX params bit for
bit, which ties the port's names to the reference layout.

Sizes: 3 samples of 10 frames, 15 features, latent 32, 4 heads, 2 layers,
text latent 24 (2 layers, 2 heads), CLIP width 16, 7 text tokens.
Tolerance 1e-4 norm-wise (PERF.md section 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import (flax_state_dict,
                                  motion_transformer_state_dict)
from ladiff_torch.models import mdiff as port
from ladiff_torch.ops.stylization import LinearTemporalCrossAttention
from ladiff_tpu.models import mdiff as ref
from ladiff_tpu.ops import stylization as ref_styl
from torch_alt_helpers import (TOL, flat_tree, jitted, loaded, noise_tree,
                               relerr, shapes, t)

B, T, F, D, E = 3, 10, 15, 32, 128
TEXT_D, CLIP_D, N_TOK, HEADS = 24, 16, 7, 4
LENGTHS = np.array([10, 6, 3], np.int32)
MODEL = dict(input_feats=F, num_frames=T, latent_dim=D, ff_size=48,
             num_layers=2, num_heads=HEADS, num_text_layers=2,
             text_latent_dim=TEXT_D, text_ff_size=40, text_num_heads=2,
             clip_dim=CLIP_D)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(B, T, D).astype(np.float32),
            "xf": rng.randn(B, N_TOK, TEXT_D).astype(np.float32),
            "emb": rng.randn(B, E).astype(np.float32),
            "valid": np.arange(T)[None] < LENGTHS[:, None]}


# name: (JAX block, the port block's factory, takes text, takes a mask)
BLOCKS = {
    "linear_self": (ref.LinearTemporalSelfAttention(D, HEADS, E),
                    lambda: port.LinearTemporalSelfAttention(D, HEADS, E, 0.1),
                    False, True),
    "self": (ref.TemporalSelfAttention(D, HEADS, E),
             lambda: port.TemporalSelfAttention(D, HEADS, E, 0.1),
             False, True),
    "cross": (ref.TemporalCrossAttention(D, TEXT_D, HEADS, E),
              lambda: port.TemporalCrossAttention(D, TEXT_D, HEADS, E),
              True, False),
    "linear_cross": (ref_styl.LinearTemporalCrossAttention(
        D, TEXT_D, HEADS, emb_dim=E),
        lambda: LinearTemporalCrossAttention(D, TEXT_D, HEADS, E, 0.1),
        True, False),
}


@pytest.mark.parametrize("name,masked", [
    (name, masked) for name, (_, _, _, takes_mask) in sorted(BLOCKS.items())
    for masked in ((False, True) if takes_mask else (False,))])
def test_attention_block_matches_jax(name, masked):
    """The self-attention blocks with and without the frame mask; the
    cross-attention blocks take none in MotionDiffuse."""
    jblock, make, text, _ = BLOCKS[name]
    inp = _inputs(1)
    args = ((inp["x"], inp["xf"], inp["emb"]) if text
            else (inp["x"], inp["emb"], inp["valid"] if masked else None))
    variables = noise_tree(shapes(jblock, *args), 2)
    want = jitted(jblock)(variables, *args)
    block = loaded(make(), flax_state_dict(variables["params"]))
    with torch.no_grad():
        got = block(*[None if a is None else t(a, torch.bool
                                                if a.dtype == bool
                                                else torch.float32)
                      for a in args])
    assert relerr(got.numpy(), want) <= TOL


@pytest.mark.parametrize("no_eff", [False, True])
def test_decoder_layer_matches_jax(no_eff):
    inp = _inputs(3)
    cls = ref.TemporalDecoderLayer if no_eff else ref.LinearTemporalDecoderLayer
    jlayer = cls(D, TEXT_D, E, 48, HEADS)
    args = (inp["x"], inp["xf"], inp["emb"], inp["valid"])
    variables = noise_tree(shapes(jlayer, *args), 4)
    want = jitted(jlayer)(variables, *args)
    pcls = (port.TemporalDecoderLayer if no_eff
            else port.LinearTemporalDecoderLayer)
    layer = loaded(pcls(D, TEXT_D, E, 48, HEADS),
                   flax_state_dict(variables["params"]))
    with torch.no_grad():
        got = layer(t(inp["x"]), t(inp["xf"]), t(inp["emb"]),
                    torch.from_numpy(inp["valid"]))
    assert relerr(got.numpy(), want) <= TOL


def _model_inputs(seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, F).astype(np.float32),
            np.array([3, 500, 999], np.int32),
            rng.randn(B, N_TOK, CLIP_D).astype(np.float32),
            np.array([6, 2, 4], np.int32))


def _models(no_eff):
    jm = ref.MotionTransformer(no_eff=no_eff, **MODEL)
    x, ts, tokens, eot = _model_inputs()
    params = noise_tree(shapes(jm, x, ts, LENGTHS, clip_tokens=tokens,
                               eot_idx=eot), 6)["params"]
    tm = loaded(port.MotionTransformer(no_eff=no_eff, device="cpu",
                                       **MODEL),
                motion_transformer_state_dict(params))
    return jm, params, tm


@pytest.mark.parametrize("with_lengths", [True, False])
@pytest.mark.parametrize("no_eff", [False, True])
def test_motion_transformer_matches_jax(no_eff, with_lengths):
    """The whole model from CLIP tokens, and ``encode_text`` alone."""
    jm, params, tm = _models(no_eff)
    x, ts, tokens, eot = _model_inputs()
    lengths = LENGTHS if with_lengths else None

    @jax.jit
    def run(p, x, ts, tokens, eot, lengths):
        out = jm.apply({"params": p}, x, ts, lengths, clip_tokens=tokens,
                       eot_idx=eot)
        return out, jm.apply({"params": p}, tokens, eot,
                             method=jm.encode_text)

    want, (proj_j, xf_j) = run(params, x, ts, tokens, eot, lengths)
    with torch.no_grad():
        got = tm(t(x), torch.from_numpy(ts.astype(np.int64)),
                 None if lengths is None
                 else torch.from_numpy(lengths.astype(np.int64)),
                 clip_tokens=t(tokens),
                 eot_idx=torch.from_numpy(eot.astype(np.int64)))
        proj_t, xf_t = tm.encode_text(t(tokens),
                                      torch.from_numpy(eot.astype(np.int64)))
    assert got.shape == (B, T, F)
    assert relerr(proj_t.numpy(), proj_j) <= TOL
    assert relerr(xf_t.numpy(), xf_j) <= TOL
    assert relerr(got.numpy(), want) <= TOL


@pytest.mark.parametrize("no_eff", [False, True])
def test_motion_transformer_gradients_match_jax(no_eff):
    """Every parameter's gradient of a weighted sum of the output, with
    lengths, against ``jax.grad``: within 1e-4 of the gradients' overall
    scale (a key bias's is zero up to rounding)."""
    jm, params, tm = _models(no_eff)
    x, ts, tokens, eot = _model_inputs()
    w = np.random.RandomState(7).randn(B, T, F).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, x, ts, LENGTHS, clip_tokens=tokens,
                       eot_idx=eot)
        return jnp.sum(out * w)

    grads = motion_transformer_state_dict(jax.jit(jax.grad(loss))(params))
    out = tm(t(x), torch.from_numpy(ts.astype(np.int64)),
             torch.from_numpy(LENGTHS.astype(np.int64)),
             clip_tokens=t(tokens),
             eot_idx=torch.from_numpy(eot.astype(np.int64)))
    (out * t(w)).sum().backward()
    scale = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
    for name, p in tm.named_parameters():
        g = grads[name].numpy()
        assert np.linalg.norm(p.grad.numpy() - g) <= TOL * max(
            np.linalg.norm(g), 1e-3 * scale), name


@pytest.mark.parametrize("no_eff", [False, True])
def test_reference_converter_reads_port_names(no_eff):
    """``convert_torch_motion_transformer`` on the port's state dict gives
    back the JAX params bit for bit."""
    _, params, tm = _models(no_eff)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = ref.convert_torch_motion_transformer(
        sd, num_layers=2, num_text_layers=2, has_pre_proj=True)["params"]
    want, got = flat_tree(params), flat_tree(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
