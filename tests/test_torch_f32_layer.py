"""The float32 routes of K1, K2, kernel 5 and kernel 10
(``ladiff_torch/ops/f32_layer.py``) on the CPU, against the plain versions
and, for K2 and kernel 10, the JAX package's Pallas kernels in float32 in
interpret mode.

The routes' launches are emulated at pointer level
(``tests/torch_f32_emulation.py``: the ``emulated`` fixture; K2's and
kernel 10's tensor-core products as three-term TF32), so the routes'
pointers, strides, slices, tiles and arguments are held here, the
kernels' arithmetic on the card (``chip_smoke.py`` ``kernels_f32``,
``tests/test_torch_cuda.py``).  Each route agrees with its plain version
within 1e-5 norm-wise (float32 sums in another order) at the published
paths' shapes and at the edges the card cases cover: partial row and key
tiles, a masked key tile between valid ones, a sample without a valid key
or memory row, every head width kernel 10's gate takes from 16 to 128, L
1 to 8 memory rows, 7 latent rows, one shared or per-sample AdaLN row;
K2 and kernel 10 within 1e-4 of the JAX kernels (float32 on both sides,
other sums and erf).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl

from test_torch_modules import relerr
from torch_f32_emulation import emulated  # noqa: F401 (a fixture)

TOL = 1e-5
JAX_TOL = 1e-4


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _p(rng, shapes):
    out = {}
    for k, s in shapes.items():
        r = rng.randn(*s)
        if len(s) == 2:
            r = r / np.sqrt(s[1])
        elif k.endswith("_w"):
            r = 1 + 0.1 * r
        else:
            r = 0.05 * r
        out[k] = torch.tensor(r, dtype=torch.float32)
    return out


def _lengths_valid(lengths, T):
    return (torch.arange(T)[None] < torch.tensor(lengths)[:, None]).float()


@pytest.mark.parametrize("M,D,Fd,act", [(2 * 206, 256, 1024, "gelu"),
                                        (37, 64, 128, "relu"),
                                        (70, 192, 384, "gelu")])
def test_postnorm_ffn_chain(emulated, M, D, Fd, act):
    """Kernel 5's chain: LN1, W1 + act, W2 + residual, LN2."""
    from ladiff_torch.ops.f32_layer import CHAIN_LAUNCHES, postnorm_ffn_f32
    from ladiff_torch.ops.postnorm_ffn import postnorm_ffn_plain
    rng = np.random.RandomState(M)
    p = _p(rng, {"ln1_w": (D,), "ln1_b": (D,), "w1": (Fd, D), "b1": (Fd,),
                 "w2": (D, Fd), "b2": (D,), "ln2_w": (D,), "ln2_b": (D,)})
    x = torch.tensor(rng.randn(M, D), dtype=torch.float32)
    got = postnorm_ffn_f32(x, p, activation=act)
    assert len(emulated) == CHAIN_LAUNCHES["fused_postnorm_ffn"]
    want = postnorm_ffn_plain(x, p, activation=act)
    assert relerr(got, want.numpy()) <= TOL


def _attention_valid(lengths, S, hole):
    """[B, S] float: each sample's first ``lengths`` keys, less the keys
    in ``hole`` (a key tile masked between valid ones)."""
    valid = _lengths_valid(lengths, S)
    if hole:
        valid[:, hole[0]:hole[1]] = 0.0
    return valid


@pytest.mark.parametrize("lengths,D,H,hole", [
    ([196, 60, 16], 256, 4, None), ([70, 0], 64, 2, None),
    ([198, 198], 512, 4, None), ([70, 33], 64, 4, None),
    ([100, 0, 37], 160, 2, None), ([200, 180], 128, 2, (50, 140)),
    ([128, 128], 192, 2, None), ([130, 1], 224, 2, None),
    ([65], 96, 2, None)])
def test_masked_attention_chain(emulated, lengths, D, H, hole):
    """Kernel 10: one launch of the tensor-core attention; partial key and
    query tiles, a sample without a valid key (uniform), one with a single
    valid key, the key tile 64 .. 127 wholly masked between valid keys,
    every head width the gate takes (16 to 128)."""
    from ladiff_torch.ops.attention_kernel import masked_attention_plain
    from ladiff_torch.ops.f32_layer import masked_attention_f32
    rng = np.random.RandomState(D + H)
    B, S = len(lengths), max(max(lengths), 70)
    q, k, v = (torch.tensor(rng.randn(B, S, D), dtype=torch.float32)
               for _ in range(3))
    valid = _attention_valid(lengths, S, hole)
    got = masked_attention_f32(q, k, v, valid, H=H)
    assert emulated == ["f32l_masked_attention"]
    want = masked_attention_plain(q, k, v, valid > 0.5, num_heads=H)
    assert relerr(got, want.numpy()) <= TOL
    if 0 in lengths:
        i = lengths.index(0)
        assert relerr(got[i], v[i].mean(0, keepdim=True).expand(
            S, D).numpy()) <= TOL


@pytest.mark.parametrize("lengths,D,H,hole", [
    ([70, 0, 33], 64, 2, None), ([130, 100], 256, 2, (20, 90))])
def test_masked_attention_chain_matches_pallas(emulated, interpret, lengths,
                                               D, H, hole):
    """Kernel 10's float32 route against the JAX Pallas kernel in float32
    (interpret mode): head widths 32 and 128, a sample without a valid key,
    a masked key tile between valid keys."""
    from ladiff_torch.ops.f32_layer import masked_attention_f32
    from ladiff_tpu.ops.pallas_attention import pallas_masked_attention
    rng = np.random.RandomState(D)
    B, S = len(lengths), max(lengths)
    q, k, v = (rng.randn(B, S, D).astype(np.float32) for _ in range(3))
    valid = _attention_valid(lengths, S, hole)
    got = masked_attention_f32(*map(torch.tensor, (q, k, v)), valid, H=H)
    want = pallas_masked_attention(*map(jnp.asarray, (q, k, v)),
                                   jnp.asarray(valid.numpy() > 0.5),
                                   num_heads=H)
    assert relerr(got, np.asarray(want)) <= JAX_TOL


def _dec_params(rng, D, Fd):
    return _p(rng, {"sa_in_w": (3 * D, D), "sa_in_b": (3 * D,),
                    "sa_out_w": (D, D), "sa_out_b": (D,), "ln1_w": (D,),
                    "ln1_b": (D,), "ca_in_w": (3 * D, D), "ca_in_b": (3 * D,),
                    "ca_out_w": (D, D), "ca_out_b": (D,), "ln2_w": (D,),
                    "ln2_b": (D,), "w1": (Fd, D), "b1": (Fd,), "w2": (D, Fd),
                    "b2": (D,), "ln3_w": (D,), "ln3_b": (D,)})


# K2's launches in order
DEC_LAUNCHES = ["f32l_gemm", "f32l_masked_attention", "f32l_gemm",
                "f32l_gemm", "f32l_cross_attention", "f32l_gemm",
                "f32l_gemm", "f32l_gemm"]


@pytest.mark.parametrize("lengths,L,mem_len,T,H,D,act", [
    ([196, 40, 100], 5, [5, 2, 1], 196, 4, 256, "gelu"),
    ([40, 13, 40], 1, [1, 1, 1], 40, 4, 256, "gelu"),
    ([60, 30], 7, [7, 0], 60, 4, 256, "gelu"),
    ([40, 23, 7], 8, [8, 0, 3], 40, 2, 256, "gelu"),
    ([196, 100], 5, [5, 3], 196, 2, 256, "gelu"),
    ([40, 13], 3, [3, 1], 40, 4, 64, "relu"),
    ([70, 64, 6], 2, [2, 0, 1], 70, 2, 128, "gelu"),
    ([60, 31], 4, [4, 4], 60, 4, 192, "relu"),
    ([196, 5], 6, [6, 1], 196, 1, 128, "gelu"),
    ([33, 20, 1], 5, [5, 5, 5], 33, 2, 64, "gelu")])
def test_decoder_layer_chain(emulated, lengths, L, mem_len, T, H, D, act):
    """K2's eight launches at L 1 to 8 memory rows, widths D 64 to 256 at
    head widths 16 to 128, ReLU and GELU, partial row blocks, a sample
    without a valid memory row."""
    from ladiff_torch.ops.decoder_layer import decoder_layer_plain
    from ladiff_torch.ops.f32_layer import CHAIN_LAUNCHES, decoder_layer_f32
    Fd = 4 * D
    rng = np.random.RandomState(T + L + H + D)
    B = len(lengths)
    p = _dec_params(rng, D, Fd)
    x = torch.tensor(rng.randn(B * T, D), dtype=torch.float32)
    mem = torch.tensor(rng.randn(B, L, D), dtype=torch.float32)
    kv = _lengths_valid(lengths, T).reshape(B * T)
    mv = _lengths_valid(mem_len, L)
    got = decoder_layer_f32(x, kv, mem, mv, p, T=T, H=H, activation=act)
    assert emulated == DEC_LAUNCHES
    assert len(emulated) == CHAIN_LAUNCHES["fused_decoder_layer"]
    want = decoder_layer_plain(x, kv, mem, mv, p, T=T, H=H, activation=act)
    assert relerr(got, want.numpy()) <= TOL


@pytest.mark.parametrize("activation,H", [("gelu", 2), ("relu", 1)])
def test_decoder_layer_chain_matches_pallas(emulated, interpret, activation,
                                            H):
    """K2's float32 route against the JAX Pallas kernel in float32
    (interpret mode) at 3 x 40 frames over 5 memory rows, one sample with
    one valid memory row, head widths 64 and 128.  (The Pallas kernel pads
    the memory rows to 8, so a sample without a valid one attends
    uniformly over 8 slots there, against the 5 rows of the JAX package's
    module and of the plain version, to which ``test_decoder_layer_chain``
    holds that case.)"""
    import jax

    from ladiff_torch.ops.f32_layer import decoder_layer_f32
    from ladiff_torch.ops.transformer import TransformerDecoderLayer as TL
    from ladiff_tpu.ops.pallas_decoder_layer import fused_decoder_layer
    from ladiff_tpu.ops.transformer import TransformerDecoderLayer as JL
    from test_torch_modules import port, randomize
    D, Fd, T, L = 128, 256, 40, 5
    rng = np.random.RandomState(7 + H)
    B = 3
    x = (0.5 * rng.randn(B * T, D)).astype(np.float32)
    mem = rng.randn(B, L, D).astype(np.float32)
    kv = _lengths_valid([40, 23, 7], T).numpy()
    mv = _lengths_valid([5, 1, 2], L).numpy()
    jl = JL(D, H, Fd, 0.0, activation)
    params = randomize(jl.init(jax.random.PRNGKey(0),
                               jnp.asarray(x.reshape(B, T, D)),
                               jnp.asarray(mem))["params"], 33)
    want = fused_decoder_layer(
        jnp.asarray(x), jnp.asarray(kv.reshape(-1, 1)), jnp.asarray(mem),
        jnp.asarray(mv), params, T=T, L=L, H=H, activation=activation)
    with torch.no_grad():
        p = port(TL(D, H, Fd, activation), params).kernel_params()
        got = decoder_layer_f32(torch.tensor(x), torch.tensor(kv.reshape(-1)),
                                torch.tensor(mem), torch.tensor(mv), p, T=T,
                                H=H, activation=activation)
    assert emulated == DEC_LAUNCHES
    assert relerr(got, np.asarray(want)) <= JAX_TOL


def _md_params(rng, D, F1, F2):
    return _p(rng, {"sa_in_w": (3 * D, D), "sa_in_b": (3 * D,),
                    "sa_out_w": (D, D), "sa_out_b": (D,), "ln1_w": (D,),
                    "ln1_b": (D,), "w1": (F1, D), "b1": (F1,),
                    "w2": (D, F1), "b2": (D,), "ln2_w": (D,), "ln2_b": (D,),
                    "ca_ln_w": (D,), "ca_ln_b": (D,), "ca_w": (D, D),
                    "ca_b": (D,), "fw1": (F2, D), "fb1": (F2,),
                    "fw2": (D, F2), "fb2": (D,), "f_ln_w": (D,),
                    "f_ln_b": (D,), "fp_w": (D, D), "fp_b": (D,)})


@pytest.mark.parametrize("valid,T,ss_rows", [([5, 3, 1, 0], 5, 1),
                                             ([7, 2, 7], 7, "B"),
                                             ([1, 1], 1, "B")])
def test_md_layer_chain(emulated, valid, T, ss_rows):
    """K1's chain: 5 and 7 latent rows, 2 extra rows, a sample without a
    valid latent, one shared AdaLN row or one per sample."""
    from ladiff_torch.ops.f32_layer import CHAIN_LAUNCHES, md_layer_f32
    from ladiff_torch.ops.md_layer import md_layer_plain
    D, H, E = 256, 4, 2
    rng = np.random.RandomState(T)
    B = len(valid)
    S = B if ss_rows == "B" else 1
    p = _md_params(rng, D, 1024, 1024)
    x, extra = (torch.tensor(rng.randn(B * n, D), dtype=torch.float32)
                for n in (T, E))
    value = torch.tensor(rng.randn(B, D), dtype=torch.float32)
    ca_ss, ffn_ss = (torch.tensor(0.3 * rng.randn(S, 2 * D),
                                  dtype=torch.float32) for _ in range(2))
    kv = _lengths_valid(valid, T).reshape(B * T)
    got = md_layer_f32(x, extra, kv, value, ca_ss, ffn_ss, p, T=T, E=E, H=H)
    assert len(emulated) == CHAIN_LAUNCHES["fused_md_layer"]
    want = md_layer_plain(x, extra, kv, value, ca_ss, ffn_ss, p, T=T, E=E,
                          H=H)
    assert relerr(got, want.numpy()) <= TOL
