"""Each module of the PyTorch port against its JAX counterpart on the CPU.

Same numpy-seeded inputs and the same (converted) weights go through the
JAX function (plain XLA path) and the port (plain PyTorch path; the kernel
wrappers take their plain version on CPU tensors).  Small sizes: d 128,
2 heads, ff 256, 3 layers; CLIP width 128 with 2 layers.

Tolerance: 1e-4 norm-wise relative error.  Both sides compute in float32;
what differs is only the order of sums (XLA vs ATen/BLAS) and erf/exp
implementations, ~1e-6 per layer; 1e-4 leaves room for that over a few
chained products and still fails on any wrong term, mask or layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import clip_state_dict, flax_state_dict

TOL = 1e-4
D, H, FF, LAYERS = 128, 2, 256, 3


def relerr(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def randomize(tree, seed):
    """Random numpy params of the tree's shapes (zero-init projections
    included), fan-in scaled."""
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


def port(module, params, prefix=""):
    """Loads JAX params into a port module (strict) and returns it."""
    module.load_state_dict(flax_state_dict(params, prefix), strict=True)
    return module.eval()


def t(a):
    return torch.from_numpy(np.array(a))


def rnd(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# -- utils/masks ----------------------------------------------------------

def test_masks_match():
    from ladiff_torch.utils import masks as tm
    from ladiff_tpu.utils import masks as jm
    lengths = np.array([1, 16, 47, 48, 49, 100, 196, 240], np.int32)
    np.testing.assert_array_equal(
        tm.lengths_to_mask(t(lengths).long(), 196).numpy(),
        np.asarray(jm.lengths_to_mask(jnp.asarray(lengths), 196)))
    np.testing.assert_array_equal(
        tm.active_latent_count(t(lengths).long(), 48, 5).numpy(),
        np.asarray(jm.active_latent_count(jnp.asarray(lengths), 48, 5)))
    np.testing.assert_array_equal(
        tm.latent_valid_mask(t(lengths).long(), 48, 5).numpy(),
        np.asarray(jm.latent_valid_mask(jnp.asarray(lengths), 48, 5)))


# -- ops/embeddings -------------------------------------------------------

def test_timestep_embedding_768():
    from ladiff_torch.ops.embeddings import timestep_embedding as tf
    from ladiff_tpu.ops.embeddings import timestep_embedding as jf
    ts = np.array([1, 21, 481, 981, 999], np.int32)
    want = jf(jnp.asarray(ts), 768, flip_sin_to_cos=True,
              downscale_freq_shift=0.0)
    got = tf(t(ts), 768, flip_sin_to_cos=True, downscale_freq_shift=0.0)
    assert relerr(got, want) <= TOL


def test_timestep_mlp_and_position_embeddings():
    from ladiff_torch.ops import embeddings as te
    from ladiff_tpu.ops import embeddings as je
    rng = np.random.RandomState(0)
    x = rnd(rng, 4, 768)
    jm = je.TimestepEmbedding(D)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    tmod = port(te.TimestepEmbedding(768, D), p)
    assert relerr(tmod(t(x)), jm.apply({"params": p}, jnp.asarray(x))) <= TOL

    seq = rnd(rng, 2, 7, D)
    jl = je.PositionEmbeddingLearned1D(D)
    pl = randomize(jl.init(jax.random.PRNGKey(1), jnp.asarray(seq))["params"],
                   2)
    tl = port(te.PositionEmbeddingLearned1D(D), pl)
    assert relerr(tl(t(seq)), jl.apply({"params": pl}, jnp.asarray(seq))) \
        <= TOL
    js = je.PositionEmbeddingSine1D(D)
    want = js.apply({}, jnp.asarray(seq))
    assert relerr(te.PositionEmbeddingSine1D(D)(t(seq)), want) <= TOL


# -- ops/attention --------------------------------------------------------

@pytest.mark.parametrize("sq,sk", [(7, 7), (20, 20), (20, 5)])
def test_masked_attention(sq, sk):
    from ladiff_torch.ops.attention import masked_attention as tf
    from ladiff_tpu.ops.attention import masked_attention as jf
    rng = np.random.RandomState(sq + sk)
    q, k, v = rnd(rng, 3, sq, D), rnd(rng, 3, sk, D), rnd(rng, 3, sk, D)
    valid = np.arange(sk)[None] < np.array([[sk], [max(1, sk // 2)], [1]])
    want = jf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              jnp.asarray(valid), num_heads=H)
    got = tf(t(q), t(k), t(v), t(valid), num_heads=H)
    assert relerr(got, want) <= TOL


def test_multihead_attention_module():
    from ladiff_torch.ops.attention import MultiHeadAttention as TM
    from ladiff_tpu.ops.attention import MultiHeadAttention as JM
    rng = np.random.RandomState(3)
    q, kv = rnd(rng, 2, 9, D), rnd(rng, 2, 5, D)
    valid = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    jm = JM(D, H)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(q),
                          jnp.asarray(kv), jnp.asarray(kv))["params"], 4)
    want = jm.apply({"params": p}, jnp.asarray(q), jnp.asarray(kv),
                    jnp.asarray(kv), jnp.asarray(valid))
    got = port(TM(D, H), p)(t(q), t(kv), t(kv), t(valid))
    assert relerr(got, want) <= TOL


# -- ops/transformer ------------------------------------------------------

def test_encoder_layer_with_extra_kv():
    from ladiff_torch.ops.transformer import TransformerEncoderLayer as TL
    from ladiff_tpu.ops.transformer import TransformerEncoderLayer as JL
    rng = np.random.RandomState(5)
    x, extra = rnd(rng, 3, 5, D), rnd(rng, 3, 2, D)
    valid = np.arange(7)[None] < np.array([[7], [4], [6]])
    valid[:, 5:] = True
    jl = JL(D, H, 1024, 0.0, "relu", False)
    p = randomize(jl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 6)
    want = jl.apply({"params": p}, jnp.asarray(x), jnp.asarray(valid),
                    extra_kv=jnp.asarray(extra))
    got = port(TL(D, H, 1024, "relu"), p)(t(x), t(valid), extra_kv=t(extra))
    assert relerr(got, want) <= TOL


def _decoder_inputs(seed, T=20, L=5):
    rng = np.random.RandomState(seed)
    tgt, mem = rnd(rng, 3, T, D, scale=0.5), rnd(rng, 3, L, D)
    tv = np.arange(T)[None] < np.array([[T], [T // 2], [3]])
    mv = np.arange(L)[None] < np.array([[L], [2], [1]])
    return tgt, mem, tv, mv


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_decoder_layer(activation):
    from ladiff_torch.ops.transformer import TransformerDecoderLayer as TL
    from ladiff_tpu.ops.transformer import TransformerDecoderLayer as JL
    tgt, mem, tv, mv = _decoder_inputs(7)
    jl = JL(D, H, FF, 0.0, activation)
    p = randomize(jl.init(jax.random.PRNGKey(0), jnp.asarray(tgt),
                          jnp.asarray(mem))["params"], 8)
    want = jl.apply({"params": p}, *map(jnp.asarray, (tgt, mem, tv, mv)))
    got = port(TL(D, H, FF, activation), p)(t(tgt), t(mem), t(tv), t(mv))
    assert relerr(got, want) <= TOL


def test_skip_decoder():
    from ladiff_torch.ops.transformer import SkipTransformerDecoder as TS
    from ladiff_tpu.ops.transformer import SkipTransformerDecoder as JS
    tgt, mem, tv, mv = _decoder_inputs(9)
    js = JS(D, H, LAYERS, FF, 0.0, "gelu")
    p = randomize(js.init(jax.random.PRNGKey(0), jnp.asarray(tgt),
                          jnp.asarray(mem))["params"], 10)
    want = js.apply({"params": p}, *map(jnp.asarray, (tgt, mem, tv, mv)))
    got = port(TS(D, H, LAYERS, FF, "gelu"), p)(t(tgt), t(mem), t(tv), t(mv))
    assert relerr(got, want) <= TOL


# -- ops/stylization ------------------------------------------------------

def _md_inputs(seed, B=3, T=5, N=1):
    rng = np.random.RandomState(seed)
    x, xf, emb = rnd(rng, B, T, D, scale=0.5), rnd(rng, B, N, D), \
        rnd(rng, B, D)
    valid = np.arange(T)[None] < np.array([[T], [2], [1]])[:B]
    return x, xf, emb, valid


@pytest.mark.parametrize("n_text", [1, 3])
def test_linear_temporal_cross_attention(n_text):
    from ladiff_torch.ops.stylization import \
        LinearTemporalCrossAttention as TM
    from ladiff_tpu.ops.stylization import LinearTemporalCrossAttention as JM
    x, xf, emb, valid = _md_inputs(11, N=n_text)
    jm = JM(D, D, H, 0.0)
    args = tuple(map(jnp.asarray, (x, xf, emb, valid)))
    p = randomize(jm.init(jax.random.PRNGKey(0), *args)["params"], 12)
    got = port(TM(D, D, H), p)(t(x), t(xf), t(emb), t(valid))
    assert relerr(got, jm.apply({"params": p}, *args)) <= TOL


def test_stylized_ffn():
    from ladiff_torch.ops.stylization import StylizedFFN as TM
    from ladiff_tpu.ops.stylization import StylizedFFN as JM
    x, _, emb, _ = _md_inputs(13)
    jm = JM(D, FF, 0.0)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(emb))["params"], 14)
    got = port(TM(D, FF), p)(t(x), t(emb))
    assert relerr(got, jm.apply({"params": p}, jnp.asarray(x),
                                jnp.asarray(emb))) <= TOL


def _md_layer(seed):
    from ladiff_torch.ops.stylization import MDTransformerLayer as TL
    from ladiff_tpu.ops.stylization import MDTransformerLayer as JL
    x, xf, emb, valid = _md_inputs(seed)
    jl = JL(D, D, FF, H, 0.0)
    args = tuple(map(jnp.asarray, (x, xf, emb, valid)))
    p = randomize(jl.init(jax.random.PRNGKey(0), *args)["params"], seed + 1)
    return jl, p, port(TL(D, D, FF, H), p), (x, xf, emb, valid), args


@pytest.mark.parametrize("n_text", [1, 3])
def test_md_layer(n_text):
    """n_text 1 takes the fused path (plain version of K1 on the CPU);
    3 takes the general module path."""
    from ladiff_torch.ops.stylization import MDTransformerLayer as TL
    from ladiff_tpu.ops.stylization import MDTransformerLayer as JL
    x, xf, emb, valid = _md_inputs(15, N=n_text)
    jl = JL(D, D, FF, H, 0.0)
    args = tuple(map(jnp.asarray, (x, xf, emb, valid)))
    p = randomize(jl.init(jax.random.PRNGKey(0), *args)["params"], 16)
    got = port(TL(D, D, FF, H), p)(t(x), t(xf), t(emb), t(valid))
    assert relerr(got, jl.apply({"params": p}, *args)) <= TOL


def test_md_layer_compute_prep():
    jl, p, tl, (x, xf, emb, valid), args = _md_layer(17)
    embs = np.random.RandomState(18).randn(6, D).astype(np.float32)
    want = jl.apply({"params": p}, jnp.asarray(xf), jnp.asarray(embs),
                    method=jl.compute_prep)
    got = tl.compute_prep(t(xf), t(embs))
    for key in ("value", "ca_ss", "ffn_ss"):
        assert relerr(got[key], want[key]) <= TOL, key


def test_md_skip_encoder_with_step_prep():
    """The sampling path: per-step prep slices and shared text/time rows
    (port) against the JAX skip encoder on the same step."""
    from ladiff_torch.ops.stylization import MDSkipTransformerEncoder as TE
    from ladiff_tpu.ops.stylization import MDSkipTransformerEncoder as JE
    x, xf, _, valid = _md_inputs(19)
    B = x.shape[0]
    table = np.random.RandomState(20).randn(4, D).astype(np.float32)
    step = 2
    emb = np.repeat(table[step][None], B, 0)
    je = JE(D, D, H, LAYERS, FF, 0.0)
    args = tuple(map(jnp.asarray, (x, xf, emb, valid)))
    p = randomize(je.init(jax.random.PRNGKey(0), *args)["params"], 21)
    want = je.apply({"params": p}, *args)
    te = port(TE(D, D, H, LAYERS, FF), p)
    prep_all = te.precompute_prep(t(xf), t(table))
    prep = [{"value": q["value"], "ca_ss": q["ca_ss"][step],
             "ffn_ss": q["ffn_ss"][step]} for q in prep_all]
    got = te(t(x), t(xf), t(emb), t(valid), prep=prep)
    assert relerr(got, want) <= TOL


# -- models/denoiser ------------------------------------------------------

def test_denoiser_pieces_and_forward():
    from ladiff_torch.models.denoiser import LADenoiser as TD
    from ladiff_tpu.models.denoiser import LADenoiser as JD
    rng = np.random.RandomState(22)
    B = 3
    sample = rnd(rng, B, 5, D)
    text = rnd(rng, B, 1, 768)
    valid = np.arange(5)[None] < np.array([[5], [3], [1]])
    ts = np.array([981, 481, 1], np.int32)
    jd = JD(latent_dim=(7, D), ff_size=FF, num_layers=LAYERS, num_heads=H,
            dropout=0.0)
    p = randomize(jd.init(jax.random.PRNGKey(0), jnp.asarray(sample),
                          jnp.asarray(ts), jnp.asarray(text),
                          jnp.asarray(valid))["params"], 23)
    td = port(TD(latent_dim=(7, D), ff_size=FF, num_layers=LAYERS,
                 num_heads=H), p)
    jp = {"params": p}
    assert relerr(td.project_text(t(text)),
                  jd.apply(jp, jnp.asarray(text),
                           method=jd.project_text)) <= TOL
    assert relerr(td.compute_time_embedding(t(ts)),
                  jd.apply(jp, jnp.asarray(ts),
                           method=jd.compute_time_embedding)) <= TOL
    want = jd.apply(jp, jnp.asarray(sample), jnp.asarray(ts),
                    jnp.asarray(text), jnp.asarray(valid))
    got = td(t(sample), t(ts).long(), t(text), t(valid))
    assert relerr(got, want) <= TOL


# -- diffusion ------------------------------------------------------------

def test_schedule_and_ddim_step():
    from ladiff_torch.diffusion import schedulers as ts_
    from ladiff_tpu.diffusion import schedulers as js_
    jsch, tsch = js_.make_schedule(), ts_.make_schedule()
    np.testing.assert_allclose(tsch.alphas_cumprod,
                               np.asarray(jsch.alphas_cumprod), rtol=1e-6)
    jt, jp = js_.ddim_timesteps(1000, 50, 1)
    tt, tp = ts_.ddim_timesteps(1000, 50, 1)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(jp, tp)
    rng = np.random.RandomState(24)
    eps, x = rnd(rng, 2, 5, D), rnd(rng, 2, 5, D)
    for step, prev in ((981, 961), (21, 1), (1, -19)):
        want = jsch.ddim_step(jnp.asarray(eps), step, prev, jnp.asarray(x))
        got = tsch.ddim_step(t(eps), step, prev, t(x))
        assert relerr(got, want) <= TOL


def test_cfg_ddim_sample():
    """CFG doubling, [uncond; cond] order, guidance combine, DDIM and the
    latent-row re-masking, with a toy denoiser in both frameworks."""
    from ladiff_torch.diffusion import sampling as tsm
    from ladiff_torch.diffusion.schedulers import make_schedule as tmk
    from ladiff_tpu.diffusion import sampling as jsm
    from ladiff_tpu.diffusion.schedulers import make_schedule as jmk
    rng = np.random.RandomState(25)
    B, steps = 3, 6
    w = rnd(rng, D, D, scale=0.05)
    cu, cc = rnd(rng, B, 1, D), rnd(rng, B, 1, D)
    valid = np.arange(5)[None] < np.array([[5], [3], [1]])
    key = jax.random.PRNGKey(3)

    def jden(lat, tt, text, v, aux):
        return jnp.tanh(lat @ w + text) * 0.5

    def tden(lat, step, text, v):
        return torch.tanh(lat @ t(w) + text) * 0.5

    want = jsm.ddim_sample(jsm.make_cfg_denoise_fn(jden, jnp.asarray(cu),
                                                   jnp.asarray(cc), 7.5),
                           jmk(), key, (B, 5, D), steps,
                           latent_valid=jnp.asarray(valid))
    init = jax.random.normal(jax.random.split(key)[0], (B, 5, D))
    got = tsm.ddim_sample(tsm.make_cfg_denoise_fn(tden, t(cu), t(cc), 7.5),
                          tmk(), (B, 5, D), steps, latent_valid=t(valid),
                          init_latents=t(init))
    assert relerr(got, want) <= TOL
    assert not got[2, 1:].any()


# -- models/vae -----------------------------------------------------------

def test_vae_decode():
    from ladiff_torch.models.vae import LAVae as TV
    from ladiff_tpu.models.vae import LAVae as JV
    rng = np.random.RandomState(26)
    B, T = 3, 60
    lengths = np.array([60, 33, 7], np.int32)
    z = rnd(rng, B, 5, D)
    jv = JV(nfeats=263, latent_dim=(7, D), ff_size=FF, num_layers=LAYERS,
            num_heads=H, dropout=0.0)
    p = randomize(jv.init(jax.random.PRNGKey(0), jnp.zeros((B, T, 263)),
                          jnp.asarray(lengths),
                          jax.random.PRNGKey(1))["params"], 27)
    want = jv.apply({"params": p}, jnp.asarray(z), jnp.asarray(lengths),
                    nframes=T, method=jv.decode)
    tv = port(TV(263, (7, D), FF, LAYERS, H), p)
    got = tv.decode(t(z), t(lengths).long(), T)
    assert relerr(got, want) <= TOL
    assert not got[2, 7:].any()


# -- data/humanml ---------------------------------------------------------

def test_recover_from_ric():
    from ladiff_torch.data.humanml.motion_repr import recover_from_ric as tf
    from ladiff_tpu.data.humanml.motion_repr import recover_from_ric as jf
    feats = rnd(np.random.RandomState(28), 2, 40, 263, scale=0.3)
    want = jf(jnp.asarray(feats), 22)
    got = tf(t(feats), 22)
    assert got.shape == (2, 40, 22, 3)
    assert relerr(got, want) <= TOL


def test_quaternion_ops():
    from ladiff_torch.data.humanml import quaternion as tq
    from ladiff_tpu.data.humanml import quaternion as jq
    rng = np.random.RandomState(29)
    q = rnd(rng, 5, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rnd(rng, 5, 3)
    assert relerr(tq.qinv(t(q)), np.asarray(jq.qinv(jnp.asarray(q)))) <= TOL
    assert relerr(tq.qrot(t(q), t(v)),
                  np.asarray(jq.qrot(jnp.asarray(q), jnp.asarray(v)))) <= TOL


# -- models/clip_text -----------------------------------------------------

CLIP_W, CLIP_L, CLIP_H, CLIP_V = 128, 2, 2, 300


def _clip_pair():
    from ladiff_torch.models.clip_text import CLIPTextTower as TT
    from ladiff_tpu.models.clip_text import CLIPTextTower as JT
    jt = JT(vocab_size=CLIP_V, width=CLIP_W, num_layers=CLIP_L,
            heads=CLIP_H, projection_dim=CLIP_W)
    ids = np.zeros((3, 77), np.int32)
    p = jt.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    p = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * np.random.RandomState(
            a.size % 97).randn(*np.shape(a)).astype(np.float32), p)
    tt = TT(vocab_size=CLIP_V, width=CLIP_W, num_layers=CLIP_L,
            heads=CLIP_H, projection_dim=CLIP_W)
    tt.load_state_dict(clip_state_dict(p), strict=True)
    return jt, p, tt.eval()


def _caption_ids(B, S, seed):
    rng = np.random.RandomState(seed)
    ids = np.zeros((B, S), np.int32)
    for b in range(B):
        n = rng.randint(3, S - 2)
        ids[b, 0] = CLIP_V - 2
        ids[b, 1:1 + n] = rng.randint(1, CLIP_V - 3, n)
        ids[b, 1 + n] = CLIP_V - 1
    return ids


@pytest.mark.parametrize("bucket", [16, 32, 77])
def test_clip_tower(bucket):
    jt, p, tt = _clip_pair()
    ids = _caption_ids(3, bucket, bucket)
    want = jt.apply({"params": p}, jnp.asarray(ids))
    with torch.no_grad():
        got = tt(t(ids).long())
        hid = tt(t(ids).long(), return_hidden=True)
    assert relerr(got, want) <= TOL
    want_h = jt.apply({"params": p}, jnp.asarray(ids), return_hidden=True)
    assert relerr(hid, want_h) <= TOL


def test_clip_pooled_invariant_to_trailing_padding():
    _, _, tt = _clip_pair()
    ids = _caption_ids(3, 16, 30)
    full = np.zeros((3, 77), np.int32)
    full[:, :16] = ids
    with torch.no_grad():
        short = tt(t(ids).long())
        long_ = tt(t(full).long())
    assert relerr(short, long_.numpy()) <= 1e-5


def test_tokenizers_are_copies():
    from ladiff_torch.models.clip_text import HashTokenizer as TH
    from ladiff_tpu.models.clip_text import HashTokenizer as JH
    texts = ["a person walks forward", "someone jumps &amp; spins twice"]
    np.testing.assert_array_equal(TH()(texts), JH()(texts))


def test_bpe_tokenizer_matches(tmp_path):
    import json
    from ladiff_torch.models.clip_text import BPETokenizer as TB
    from ladiff_tpu.models.clip_text import BPETokenizer as JB
    vocab, merges = {}, ["#version: 0.2"]
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for a, b in (("w", "a"), ("wa", "l"), ("k", "s</w>"), ("t", "h")):
        merges.append(f"{a} {b}")
        vocab.setdefault(a + b, len(vocab))
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("\n".join(merges))
    texts = ["the man walks", "a thin walk"]
    np.testing.assert_array_equal(TB(str(tmp_path))(texts),
                                  JB(str(tmp_path))(texts))


def test_clip_encoder_buckets():
    """The port's wrapper buckets like the JAX one and pools the same
    feature at the bucket as at the full context."""
    from ladiff_torch.models.clip_text import ClipTextEncoder
    enc = ClipTextEncoder(device="cpu")
    texts = ["a person walks forward", "someone jumps"]
    ids = enc.tokenizer(texts)
    assert enc.bucket_ids(ids).shape == (2, 16)
    out = enc(texts)
    assert out.shape == (2, 1, 768) and torch.isfinite(out).all()
    full = enc.encode_ids(torch.from_numpy(ids.astype(np.int64)))
    assert relerr(out, full.numpy()) <= 1e-5
