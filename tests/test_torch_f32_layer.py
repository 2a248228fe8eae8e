"""The float32 chains of K1, K2, kernel 5 and kernel 10
(``ladiff_torch/ops/f32_layer.py``) on the CPU, against the plain versions.

The chains' launches are emulated at pointer level
(``tests/torch_f32_emulation.py``: the ``emulated`` fixture), so the
chains' pointers, strides, slices and arguments are held here, the
kernels' arithmetic on the card (``chip_smoke.py`` ``kernels_f32``,
``tests/test_torch_cuda.py``).  Each chain agrees with its plain version
within 1e-5 norm-wise (float32 sums in another order) at the published
paths' shapes and at the edges the card cases cover: partial row and key
tiles, a sample without a valid key, L 1 and 7 memory rows, 7 latent
rows, one shared or per-sample AdaLN row.
"""
import numpy as np
import pytest
import torch

from test_torch_modules import relerr
from torch_f32_emulation import emulated  # noqa: F401 (a fixture)

TOL = 1e-5


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


@pytest.mark.parametrize("lengths,D,H", [([196, 60, 16], 256, 4),
                                         ([70, 0], 64, 2),
                                         ([198, 198], 512, 4)])
def test_masked_attention_chain(emulated, lengths, D, H):
    """Kernel 10: partial key and query tiles, a sample without a valid key
    (uniform), head widths 64, 32 and 128."""
    from ladiff_torch.ops.attention_kernel import masked_attention_plain
    from ladiff_torch.ops.f32_layer import masked_attention_f32
    rng = np.random.RandomState(D)
    B, S = len(lengths), max(max(lengths), 70)
    q, k, v = (torch.tensor(rng.randn(B, S, D), dtype=torch.float32)
               for _ in range(3))
    valid = _lengths_valid(lengths, S)
    got = masked_attention_f32(q, k, v, valid, H=H)
    assert emulated == ["f32_attention"]
    want = masked_attention_plain(q, k, v, valid > 0.5, num_heads=H)
    assert relerr(got, want.numpy()) <= TOL
    if 0 in lengths:
        i = lengths.index(0)
        assert relerr(got[i], v[i].mean(0, keepdim=True).expand(
            S, D).numpy()) <= TOL


def _dec_params(rng, D, Fd):
    return _p(rng, {"sa_in_w": (3 * D, D), "sa_in_b": (3 * D,),
                    "sa_out_w": (D, D), "sa_out_b": (D,), "ln1_w": (D,),
                    "ln1_b": (D,), "ca_in_w": (3 * D, D), "ca_in_b": (3 * D,),
                    "ca_out_w": (D, D), "ca_out_b": (D,), "ln2_w": (D,),
                    "ln2_b": (D,), "w1": (Fd, D), "b1": (Fd,), "w2": (D, Fd),
                    "b2": (D,), "ln3_w": (D,), "ln3_b": (D,)})


@pytest.mark.parametrize("lengths,L,mem_len,T", [
    ([196, 40, 100], 5, [5, 2, 1], 196), ([40, 13, 40], 1, [1, 1, 1], 40),
    ([60, 30], 7, [7, 0], 60)])
def test_decoder_layer_chain(emulated, lengths, L, mem_len, T):
    """K2's chain at L 5, 1 and 7 memory rows, partial row blocks, a
    sample without a valid memory row."""
    from ladiff_torch.ops.decoder_layer import decoder_layer_plain
    from ladiff_torch.ops.f32_layer import CHAIN_LAUNCHES, decoder_layer_f32
    D, H, Fd = 256, 4, 1024
    rng = np.random.RandomState(T + L)
    B = len(lengths)
    p = _dec_params(rng, D, Fd)
    x = torch.tensor(rng.randn(B * T, D), dtype=torch.float32)
    mem = torch.tensor(rng.randn(B, L, D), dtype=torch.float32)
    kv = _lengths_valid(lengths, T).reshape(B * T)
    mv = _lengths_valid(mem_len, L)
    got = decoder_layer_f32(x, kv, mem, mv, p, T=T, H=H, activation="gelu")
    assert len(emulated) == CHAIN_LAUNCHES["fused_decoder_layer"]
    want = decoder_layer_plain(x, kv, mem, mv, p, T=T, H=H,
                               activation="gelu")
    assert relerr(got, want.numpy()) <= TOL


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
