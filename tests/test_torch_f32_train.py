"""The float32 chains of the training kernels 8, 9, 12 and 13, forward and
backward (``ladiff_torch/ops/f32_train.py``), on the CPU.

The chains' kernels (``csrc/f32_train.cu`` on ``csrc/f32_tile.cuh``;
``csrc/f32_train_layer.cu`` on ``csrc/f32_tc_tile.cuh``) run on the card
only.  Here ``launch`` is replaced by an emulation of their C entry points
that reads and writes the very memory the pointers, row strides and ints
name (CPU tensors' addresses, through ``ctypes``), computing each kernel's
contract in float64, and checks the 16-byte alignment of the rows the
kernels read with 16-byte cp.async pieces (the tensor-core entry points'
emulation, shared with the float32 K2 and kernel 10, and the numpy
Philox-4x32-10 that mirrors ``csrc/common.cuh`` ``keep_scale`` live in
``tests/torch_f32_emulation.py``).  The plain versions are fed the masks
that generator writes for each wrapper's mask ids.  Held here:

  (a) each chain's forward, dx, every parameter gradient and kernel 13's
      memory gradient against the float32 plain versions under the same
      masks, within 1e-5 norm-wise (float32 sums in another order): D 64 to
      256, S 13 / 37 / 70, rates 0 and 0.1, a sample without a valid key,
      L 1 and 7, partial row and key tiles, ReLU and GELU; the launches of
      each chain; the split-K and LayerNorm partials' geometry;
  (b) each autograd Function on the emulated float32 route at rate 0
      against the JAX package's Pallas kernel in interpret mode
      (``jax.grad``), within 1e-4;
  (c) a float32 stage-1 ``vae_forward`` and its backward on the emulated
      kernel route against the JAX package's float32 loss and gradients,
      name by name, within the tolerances ``tests/test_torch_train.py``
      holds the plain route to.

The kernels' arithmetic itself is held on the card (``chip_smoke.py``
``train_kernels_f32``, ``tests/test_torch_cuda.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from test_torch_modules import relerr
from torch_f32_emulation import (TC_ENTRY, _act, _act_grad, _attn_views,
                                 _drop, _keep, _logits, _mm3, _philox,
                                 _philox_bits, _split, _tf32, _vec, _view)

TOL = 1e-5      # the same float32 function, sums in another order
JAX_TOL = 1e-4  # float32 on both sides, other sums and erf


# -- the dropout generator (torch_f32_emulation.py) -------------------------

def _mask(shape, rate, seed, mask_id):
    """The keep-mask of ``mask_id`` over ``shape`` (element = flat index),
    as ``train_*_masks`` write it on the card."""
    from ladiff_torch.ops.cuda_common import split_seed
    lo, hi = split_seed(seed)
    n = int(np.prod(shape))
    return torch.tensor(_keep(lo, hi, rate, mask_id, np.arange(n)).reshape(
        shape))


def test_philox_matches_the_reference_vector():
    """The generator is Philox-4x32-10: Random123's known-answer vector
    (counter and key all ones) comes out."""
    c = _philox([np.array([0xFFFFFFFF], np.uint64)] * 4, 0xFFFFFFFF,
                0xFFFFFFFF)
    assert [int(v[0]) for v in c] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                      0x6D5451FD]
    # element 4 q + w of a mask is word w of counter q's block
    bits = _philox_bits(5, -7, 3, np.arange(8))
    assert len(set(bits.tolist())) == 8
    keep = _keep(5, -7, 0.25, 3, np.arange(100000))
    assert abs(float((keep > 0).mean()) - 0.75) < 0.01
    assert set(np.unique(keep).tolist()) == {0.0, float(np.float32(1 / 0.75))}


# -- the emulated entry points of csrc/f32_train.cu (those of
# csrc/f32_train_layer.cu: torch_f32_emulation.py) ---------------------------

def _gemm(p, n, f):
    (M, N, K, lda, ldb, ldc, a_mn, b_mn, act, ldpre, ldg, gact, ldr, mid, lo,
     hi, ksplit, cstride, sstride) = n
    # a K-contiguous operand is read in 16-byte pieces
    for mn, ptr, ld in ((a_mn, p[0], lda), (b_mn, p[1], ldb)):
        if not mn:
            assert K % 4 == 0 and ld % 4 == 0 and ptr % 16 == 0
            assert ksplit % 4 == 0
    A = (_view(p[0], K, M, lda).T if a_mn else _view(p[0], M, K, lda))
    B = (_view(p[1], K, N, ldb).T if b_mn else _view(p[1], N, K, ldb))
    A, B = A.double(), B.double()
    splits = -(-K // ksplit)
    if cstride:  # split-K partials and the column sums of A
        for z in range(splits):
            k0, k1 = z * ksplit, min(K, (z + 1) * ksplit)
            _view(p[2] + 4 * z * cstride, M, N, ldc).copy_(
                A[:, k0:k1] @ B[:, k0:k1].T)
            if p[7]:
                _vec(p[7] + 4 * z * sstride, M).copy_(A[:, k0:k1].sum(1))
        assert not any(p[3:7])
        return
    assert splits == 1 and not p[7]
    v = A @ B.T
    if p[3]:
        v = v + _vec(p[3], N).double()
    if p[4]:
        _view(p[4], M, N, ldpre).copy_(v)
    v = _act(v, act)
    if p[5]:
        v = v * _act_grad(_view(p[5], M, N, ldg).double(), gact)
    v = v * _drop(lo, hi, f[0], mid, (M, N))
    if p[6]:
        v = v + _view(p[6], M, N, ldr).double()
    _view(p[2], M, N, ldc).copy_(v)


def _rownorm(p, n, f):
    M, D, lds, ldo = n
    x = _view(p[0], M, D, lds).double()
    _view(p[3], M, D, ldo).copy_(F.layer_norm(
        x, (D,), _vec(p[1], D).double(), _vec(p[2], D).double(), 1e-5))


def _attention(p, n, f):
    B, Sq, Nk, H, Dh, ldq, ldk, ldo, mid, lo, hi = n
    q, k, v, valid = _attn_views(p, n)
    s = _logits(q, k, valid, B, Sq, Nk, H, f[0])
    prob = torch.softmax(s, -1) * _drop(lo, hi, f[1], mid, (B, H, Sq, Nk))
    o = torch.einsum("bhqk,bkhd->bqhd", prob, v)
    _view(p[4], B * Sq, H * Dh, ldo).copy_(o.reshape(B * Sq, H * Dh))
    _view(p[5], B * Sq, H, H).copy_(
        torch.logsumexp(s, -1).transpose(1, 2).reshape(B * Sq, H))


def _attention_bwd(p, n, f):
    B, Sq, Nk, H, Dh, ldq, ldk, ldd, lddq, lddk, mid, lo, hi, side = n
    q, k, v, valid = _attn_views(p, n)
    assert ldd % 4 == 0 and p[4] % 16 == 0
    D = H * Dh
    do = _view(p[4], B * Sq, D, ldd).double().reshape(B, Sq, H, Dh)
    lse = _view(p[5], B * Sq, H, H).double().reshape(B, Sq, H).transpose(1, 2)
    delta = _view(p[6], B * Sq, H, H).double().reshape(B, Sq, H).transpose(
        1, 2)
    s = _logits(q, k, valid, B, Sq, Nk, H, f[0])
    prob = torch.exp(s - lse[..., None])
    keep = _drop(lo, hi, f[1], mid, (B, H, Sq, Nk))
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = prob * (dp * keep - delta[..., None])
    if side == 0:
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * f[0]
        _view(p[7], B * Sq, D, lddq).copy_(dq.reshape(B * Sq, D))
    else:
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * f[0]
        dv = torch.einsum("bhqk,bqhd->bkhd", prob * keep, do)
        _view(p[8], B * Nk, D, lddk).copy_(dk.reshape(B * Nk, D))
        _view(p[9], B * Nk, D, lddk).copy_(dv.reshape(B * Nk, D))


def _rowdot(p, n, f):
    M, H, Dh, lda, ldb = n
    a = _view(p[0], M, H * Dh, lda).double().reshape(M, H, Dh)
    b = _view(p[1], M, H * Dh, ldb).double().reshape(M, H, Dh)
    _view(p[2], M, H, H).copy_((a * b).sum(-1))


def _lnbwd(p, n, f):
    M, D, ldx, ldg, lddx, ldpart, rpb, mid, lo, hi = n
    assert D % 32 == 0 and D <= 256 and ldpart >= 2 * D
    x = _view(p[0], M, D, ldx).double()
    w = _vec(p[1], D).double()
    g = _view(p[2], M, D, ldg).double()
    mu = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    xhat = (x - mu) * rstd
    gw = g * w
    dx = rstd * (gw - gw.mean(-1, keepdim=True)
                 - xhat * (gw * xhat).mean(-1, keepdim=True))
    _view(p[3], M, D, lddx).copy_(dx)
    if p[4]:
        _view(p[4], M, D, lddx).copy_(dx * _drop(lo, hi, f[0], mid, (M, D)))
    nblk = -(-M // rpb)
    part = _view(p[5], nblk, 2 * D, ldpart)
    for z in range(nblk):
        r = slice(z * rpb, min(M, (z + 1) * rpb))
        part[z, :D] = (g[r] * xhat[r]).sum(0)
        part[z, D:] = g[r].sum(0)


def _keep_mul(p, n, f):
    N, mid, lo, hi = n
    x = _vec(p[0], N).double()
    _vec(p[1], N).copy_(x * _drop(lo, hi, f[0], mid, (N,)))


def _reduce(p, n, f):
    splits, ld, *sizes = n
    total = sum(sizes)
    assert ld >= total
    s = _view(p[0], splits, total, ld).double().sum(0)
    o = 0
    for ptr, size in zip(p[1:], sizes):
        if size:
            _vec(ptr, size).copy_(s[o:o + size])
        o += size


_ENTRY = {"f32t_gemm": _gemm, "f32t_rownorm": _rownorm,
          "f32t_attention": _attention, "f32t_attention_bwd": _attention_bwd,
          "f32t_rowdot": _rowdot, "f32t_lnbwd": _lnbwd,
          "f32t_keep_mul": _keep_mul, "f32t_reduce": _reduce, **TC_ENTRY}
# the library each entry point lives in
_LIB = {name: "f32_train_layer" if name in TC_ENTRY else "f32_train"
        for name in _ENTRY}


@pytest.fixture
def emulated(monkeypatch):
    """``f32_train``'s launches run the emulation; returns the launches
    made, by entry point."""
    from ladiff_torch.ops import f32_train
    made = []

    def fake(lib, fn, device, ptrs, ints, floats=()):
        assert lib == _LIB[fn]
        _ENTRY[fn](list(ptrs), list(ints), list(floats))
        made.append(fn)

    monkeypatch.setattr(f32_train, "launch", fake)
    return made


# -- inputs ------------------------------------------------------------------

def _params(rng, shapes):
    out = {}
    for k, s in shapes.items():
        r = rng.randn(*s)
        if len(s) == 2:
            r = r / np.sqrt(s[1])
        elif k.endswith("ln1_w") or k.endswith("ln2_w") or k.endswith(
                "ln3_w"):
            r = 1 + 0.1 * r
        else:
            r = 0.05 * r
        out[k] = torch.tensor(r, dtype=torch.float32)
    return out


def _attn_shapes(D, prefix=""):
    return {prefix + "in_w": (3 * D, D), prefix + "in_b": (3 * D,),
            prefix + "out_w": (D, D), prefix + "out_b": (D,)}


def _ffn_shapes(D, Fd, ln=("ln1", "ln2")):
    return {ln[0] + "_w": (D,), ln[0] + "_b": (D,), "w1": (Fd, D),
            "b1": (Fd,), "w2": (D, Fd), "b2": (D,), ln[1] + "_w": (D,),
            ln[1] + "_b": (D,)}


def _valid(lengths, S):
    return (torch.arange(S)[None] < torch.tensor(lengths)[:, None]).float()


def _drop_args(rate, seed):
    from ladiff_torch.ops.cuda_common import split_seed
    return (*split_seed(seed if rate > 0 else 0), rate)


def _hold(got, want, what):
    assert bool(torch.isfinite(got).all()), what
    assert relerr(got, want.detach().numpy()) <= TOL, what


def _hold_grads(got, want):
    assert set(got) == set(want)
    for k in want:
        _hold(got[k], want[k], k)


SEED = 0x5EED1234ABCD


# -- (a) each chain against its float32 plain version ----------------------

@pytest.mark.parametrize("M,D,Fd,act,rate", [(37, 64, 128, "relu", 0.1),
                                             (70, 128, 256, "gelu", 0.0),
                                             (140, 256, 512, "gelu", 0.1)])
def test_train_ffn_chain(emulated, M, D, Fd, act, rate):
    """Kernel 9: forward, dx and the eight parameter gradients under masks
    0 (hidden) and 1 (output)."""
    from ladiff_torch.ops.f32_train import (CHAIN_LAUNCHES,
                                            train_postnorm_ffn_f32,
                                            train_postnorm_ffn_f32_bwd)
    from ladiff_torch.ops.train_ffn import (train_postnorm_ffn_bwd_plain,
                                            train_postnorm_ffn_plain)
    rng = np.random.RandomState(M)
    p = _params(rng, _ffn_shapes(D, Fd))
    x, dout = (torch.tensor(rng.randn(M, D), dtype=torch.float32)
               for _ in range(2))
    drop = _drop_args(rate, SEED)
    masks = ((_mask((M, Fd), rate, SEED, 0), _mask((M, D), rate, SEED, 1))
             if rate else None)
    out = train_postnorm_ffn_f32(x, p, activation=act, drop=drop)
    assert len(emulated) == CHAIN_LAUNCHES["train_postnorm_ffn"]
    _hold(out, train_postnorm_ffn_plain(x, p, masks, activation=act), "out")
    emulated.clear()
    dx, grads = train_postnorm_ffn_f32_bwd(x, dout, p, activation=act,
                                           drop=drop)
    assert len(emulated) == CHAIN_LAUNCHES["train_postnorm_ffn_bwd"]
    wdx, wgrads = train_postnorm_ffn_bwd_plain(x, dout, p, masks,
                                               activation=act)
    _hold(dx, wdx, "dx")
    _hold_grads(grads, wgrads)


@pytest.mark.parametrize("lengths,S,D,H,rate", [
    ([13, 9, 4], 13, 64, 4, 0.1), ([70, 0, 33], 70, 128, 2, 0.0),
    ([37, 20], 37, 192, 4, 0.1), ([70, 0, 70], 70, 64, 1, 0.1)])
def test_train_attention_chain(emulated, lengths, S, D, H, rate):
    """Kernel 8: forward, dx and the four parameter gradients under masks 0
    (probabilities) and 1 (residual); head widths 16, 64 and 48; a sample
    without a valid key (uniform, and its gradients flow as the plain
    backward's do); partial query and key tiles."""
    from ladiff_torch.ops.f32_train import (CHAIN_LAUNCHES,
                                            train_self_attention_f32,
                                            train_self_attention_f32_bwd)
    from ladiff_torch.ops.train_attention import (
        train_self_attention_bwd_plain, train_self_attention_plain)
    B = len(lengths)
    M = B * S
    rng = np.random.RandomState(S + D)
    p = _params(rng, _attn_shapes(D))
    x, dout = (torch.tensor(rng.randn(M, D), dtype=torch.float32)
               for _ in range(2))
    kv = _valid(lengths, S).reshape(M)
    drop = _drop_args(rate, SEED)
    masks = ((_mask((B, H, S, S), rate, SEED, 0),
              _mask((M, D), rate, SEED, 1)) if rate else None)
    out, saved = train_self_attention_f32(x, kv, p, H=H, S=S, drop=drop)
    assert len(emulated) == CHAIN_LAUNCHES["train_self_attention"]
    assert [tuple(s.shape) for s in saved] == [(M, 3 * D), (M, D), (M, H)]
    _hold(out, train_self_attention_plain(x, kv, p, masks, H=H, S=S), "out")
    emulated.clear()
    dx, grads = train_self_attention_f32_bwd(x, kv, dout, p, saved, H=H, S=S,
                                             drop=drop)
    assert len(emulated) == CHAIN_LAUNCHES["train_self_attention_bwd"]
    wdx, wgrads = train_self_attention_bwd_plain(x, kv, dout, p, masks, H=H,
                                                 S=S)
    _hold(dx, wdx, "dx")
    _hold_grads(grads, wgrads)


@pytest.mark.parametrize("lengths,S,D,H,Fd,act,rate", [
    ([70, 0, 41], 70, 64, 4, 128, "gelu", 0.1),
    ([37, 30], 37, 128, 2, 256, "relu", 0.0)])
def test_train_encoder_layer_chain(emulated, lengths, S, D, H, Fd, act,
                                   rate):
    """Kernel 12: kernel 8's chain and kernel 9's under masks 0 to 3."""
    from ladiff_torch.ops.f32_train import (CHAIN_LAUNCHES,
                                            train_encoder_layer_f32,
                                            train_encoder_layer_f32_bwd)
    from ladiff_torch.ops.train_layer import (train_encoder_layer_bwd_plain,
                                              train_encoder_layer_plain)
    B = len(lengths)
    M = B * S
    rng = np.random.RandomState(S + Fd)
    p = _params(rng, {**_attn_shapes(D), **_ffn_shapes(D, Fd)})
    x, dout = (torch.tensor(rng.randn(M, D), dtype=torch.float32)
               for _ in range(2))
    kv = _valid(lengths, S).reshape(M)
    drop = _drop_args(rate, SEED)
    masks = tuple(_mask(s, rate, SEED, i) for i, s in enumerate(
        ((B, H, S, S), (M, D), (M, Fd), (M, D)))) if rate else None
    out, saved = train_encoder_layer_f32(x, kv, p, H=H, S=S, activation=act,
                                         drop=drop)
    assert len(emulated) == CHAIN_LAUNCHES["train_encoder_layer"]
    assert all(fn.startswith("f32l_") for fn in emulated)
    _hold(out, train_encoder_layer_plain(x, kv, p, masks, H=H, S=S,
                                         activation=act), "out")
    emulated.clear()
    dx, grads = train_encoder_layer_f32_bwd(x, kv, dout, p, saved, H=H, S=S,
                                            activation=act, drop=drop)
    assert len(emulated) == CHAIN_LAUNCHES["train_encoder_layer_bwd"]
    assert all(fn.startswith("f32l_") for fn in emulated)
    wdx, wgrads = train_encoder_layer_bwd_plain(x, kv, dout, p, masks, H=H,
                                                S=S, activation=act)
    _hold(dx, wdx, "dx")
    _hold_grads(grads, wgrads)


@pytest.mark.parametrize("lengths,mem_len,S,L,D,H,Fd,act,rate", [
    ([37, 20, 0], [7, 0, 3], 37, 7, 64, 4, 128, "gelu", 0.1),
    ([70, 13], [1, 1], 70, 1, 128, 2, 256, "relu", 0.0),
    ([13, 9, 13], [5, 2, 1], 13, 5, 256, 4, 512, "gelu", 0.1)])
def test_train_decoder_layer_chain(emulated, lengths, mem_len, S, L, D, H,
                                   Fd, act, rate):
    """Kernel 13: forward, dx, the memory's gradient and the eighteen
    parameter gradients under masks 0 to 5; L 7, 1 and 5 memory rows, a
    sample without a valid memory row, one without a valid frame."""
    from ladiff_torch.ops.f32_train import (CHAIN_LAUNCHES,
                                            train_decoder_layer_f32,
                                            train_decoder_layer_f32_bwd)
    from ladiff_torch.ops.train_decoder_layer import (
        train_decoder_layer_bwd_plain, train_decoder_layer_plain)
    B = len(lengths)
    M = B * S
    rng = np.random.RandomState(S + L)
    p = _params(rng, {**_attn_shapes(D, "sa_"), "ln1_w": (D,),
                      "ln1_b": (D,), **_attn_shapes(D, "ca_"),
                      **_ffn_shapes(D, Fd, ("ln2", "ln3"))})
    x, dout = (torch.tensor(rng.randn(M, D), dtype=torch.float32)
               for _ in range(2))
    mem = torch.tensor(rng.randn(B, L, D), dtype=torch.float32)
    kv = _valid(lengths, S).reshape(M)
    mv = _valid(mem_len, L)
    drop = _drop_args(rate, SEED)
    masks = tuple(_mask(s, rate, SEED, i) for i, s in enumerate(
        ((B, H, S, S), (M, D), (B, H, S, L), (M, D), (M, Fd),
         (M, D)))) if rate else None
    out, saved = train_decoder_layer_f32(x, kv, mem, mv, p, H=H, S=S,
                                         activation=act, drop=drop)
    assert len(emulated) == CHAIN_LAUNCHES["train_decoder_layer"]
    assert all(fn.startswith("f32l_") for fn in emulated)
    assert tuple(saved[3].shape) == (B * L, 2 * D)
    _hold(out, train_decoder_layer_plain(x, kv, mem, mv, p, masks, H=H, S=S,
                                         activation=act), "out")
    emulated.clear()
    dx, dmem, grads = train_decoder_layer_f32_bwd(
        x, kv, mem, mv, dout, p, saved, H=H, S=S, activation=act, drop=drop)
    assert len(emulated) == CHAIN_LAUNCHES["train_decoder_layer_bwd"]
    assert all(fn.startswith("f32l_") for fn in emulated)
    wdx, wdmem, wgrads = train_decoder_layer_bwd_plain(
        x, kv, mem, mv, dout, p, masks, H=H, S=S, activation=act)
    _hold(dx, wdx, "dx")
    _hold(dmem, wdmem, "dmem")
    _hold_grads(grads, wgrads)


@pytest.mark.parametrize("N1,N2,K", [(768, 256, 64 * 206), (256, 256, 640),
                                     (1024, 256, 128 * 206), (512, 256, 320),
                                     (64, 64, 13)])
def test_wgrad_split_geometry(N1, N2, K):
    """The split-K weight gradients: splits of whole 16-row slices that
    cover the K rows once, at least two blocks an SM where the rows allow
    (the 64 x 64 tiles times the splits), and a split at most every 64
    rows."""
    from ladiff_torch.ops.f32_train import wgrad_split
    splits, ksplit = wgrad_split(N1, N2, K)
    assert ksplit % 16 == 0 and (splits - 1) * ksplit < K <= splits * ksplit
    tiles = -(-N1 // 64) * -(-N2 // 64)
    assert tiles * splits >= min(264, tiles * -(-K // 64)) // 2
    assert 1 <= splits <= max(1, -(-K // 64))


@pytest.mark.parametrize("K,tiles", [(64 * 206, 48), (64 * 196, 64),
                                     (64 * 5, 64), (3 * 70, 48),
                                     (128 * 62, 48), (37, 300)])
def test_tc_wgrad_split_fills_one_wave(K, tiles):
    """Kernels 12's and 13's grouped weight gradients: whole 16-row slices
    covering the K rows once, a split at most every 64 rows, and the
    group's blocks (its 128 x 128 tiles times the splits) within one wave
    of two blocks an SM, as full as the rows allow."""
    from ladiff_torch.ops.f32_train import TC_FILL, tc_wgrad_split
    splits, ksplit = tc_wgrad_split(K, tiles)
    assert ksplit % 16 == 0 and (splits - 1) * ksplit < K <= splits * ksplit
    assert 1 <= splits <= max(1, -(-K // 64))
    assert tiles * splits <= max(TC_FILL, tiles)
    assert splits == 1 or tiles * (splits + 1) > TC_FILL or \
        splits >= -(-K // 64) - 1


@pytest.mark.parametrize("flush", [16, 48, 1024])
def test_grouped_weight_gradients_flush_partials(emulated, monkeypatch,
                                                 flush):
    """Kernels 12's and 13's weight gradients in one launch: each split's
    rows summed in partials of at most ``TC_FLUSH`` rows (zeros past the
    split's rows), the bias from each split's column sums, one reduction;
    two products of different depths (13's memory rows), a row slice of
    an output, within 1e-5 of float64."""
    from ladiff_torch.ops import f32_train as ft
    monkeypatch.setattr(ft, "TC_FLUSH", flush)
    rng = np.random.RandomState(flush)
    t = lambda *shape: torch.tensor(rng.randn(*shape), dtype=torch.float32)
    dy1, x1, dy2, x2 = t(210, 192), t(210, 64), t(15, 128), t(15, 64)
    grads = {"w": torch.empty(320, 64), "b": torch.empty(320),
             "v": torch.empty(128, 64), "c": torch.empty(128)}
    segs = ft._wgrads([(dy1, x1, ("w", slice(0, 192)), ("b", slice(0, 192))),
                       (dy2, x2, "v", "c"),
                       (dy2, x2, ("w", slice(192, 320)),
                        ("b", slice(192, 320)))], grads, dy1)
    ft._reduce_tc(segs, dy1)
    assert emulated == ["f32l_gemm", "f32l_reduce"]
    want_w = torch.cat([dy1.double().T @ x1.double(),
                        dy2.double().T @ x2.double()])
    _hold(grads["w"], want_w, "w")
    _hold(grads["b"], torch.cat([dy1.double().sum(0), dy2.double().sum(0)]),
          "b")
    _hold(grads["v"], dy2.double().T @ x2.double(), "v")
    _hold(grads["c"], dy2.double().sum(0), "c")


@pytest.mark.parametrize("M", [13, 37 * 3, 64 * 196, 128 * 206, 640])
def test_layernorm_backward_rows(M):
    """The LayerNorm backward's blocks: whole warps' rows (a multiple of 8),
    at most 256 blocks (the partials its reduction sums), covering M."""
    from ladiff_torch.ops.f32_train import ln_rows
    r = ln_rows(M)
    assert r % 8 == 0 and -(-M // r) <= 256 and -(-M // r) * r >= M


def test_tf32_split_rounds_to_nearest_ties_away():
    """The emulated ``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties
    away from zero in either sign; hi + lo (lo = x - hi as the tensor core
    reads it) carries the float32 value to 2^-21."""
    ulp = 2.0 ** -10
    x = np.array([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + ulp * 1.5,
                  -(1 + ulp / 2), 3.0e-3, -7.5e5], np.float32)
    got = _tf32(x)
    assert got[:5].tolist() == [1.0, 1 + ulp, 1.0, 1 + 2 * ulp, -(1 + ulp)]
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()
    v = torch.tensor(np.random.RandomState(5).randn(4096), dtype=torch.float32)
    hi, lo = _split(v)
    assert bool((hi == torch.from_numpy(_tf32(v.numpy())).double()).all())
    err = (v.double() - hi - lo).abs() / v.double().abs()
    assert float(err.max()) <= 2.0 ** -21


@pytest.mark.parametrize("M,N,K", [(64, 64, 64), (64, 64, 256),
                                   (64, 64, 1024), (64, 64, 13184)])
def test_three_term_products_hold_float32_accuracy(M, N, K):
    """The three-term TF32 product at the layers' depths (K 64, 256 and
    1024: head width, D, F) and a weight gradient over 64 x 206 = 13,184
    rows: within 1e-5 of the float64 product of the float32 operands, and
    far closer than one TF32 term alone."""
    rng = np.random.RandomState(K)
    a = torch.tensor(rng.randn(M, K), dtype=torch.float32)
    b = torch.tensor(rng.randn(K, N), dtype=torch.float32)
    want = (a.double() @ b.double()).numpy()
    assert relerr(_mm3(a, b), want) <= TOL
    ah, _ = _split(a)
    bh, _ = _split(b)
    assert relerr(_mm3(a, b), want) * 50 < relerr(ah @ bh, want)


@pytest.mark.parametrize("S,lengths", [(37, [37, 0, 20]), (70, [0, 70]),
                                       (206, [206, 0, 131])])
def test_attention_dq_partials_sum_in_key_tile_order(emulated, monkeypatch,
                                                     S, lengths):
    """Kernels 12's and 13's attention backward: dk and dv whole, dq one
    partial per 64-key tile summed in tile order by one reduction (no
    atomics); a sample without a valid key attends uniformly, forward and
    backward.  ctx and dq, dk, dv against float64 autograd within 1e-5."""
    from ladiff_torch.ops import f32_train as ft
    B, H, D = len(lengths), 2, 64
    M = B * S
    rng = np.random.RandomState(S)
    qkv = torch.tensor(rng.randn(M, 3 * D), dtype=torch.float32)
    dctx = torch.tensor(rng.randn(M, D), dtype=torch.float32)
    kv = _valid(lengths, S).reshape(M)
    q, k, v = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
    ctx, lse = ft._tc_attention(q, k, v, kv, B=B, S=S, H=H,
                                drop=ft.NO_DROP, mask_id=0)
    delta = (dctx * ctx).reshape(M, H, D // H).sum(-1)
    reduced = []
    fake = ft.launch

    def spy(lib, fn, device, ptrs, ints, floats=()):
        if fn == "f32l_reduce":
            reduced.append(list(ints))
        fake(lib, fn, device, ptrs, ints, floats)

    monkeypatch.setattr(ft, "launch", spy)
    emulated.clear()
    dqkv = torch.empty(M, 3 * D)
    ft._tc_attention_bwd(q, k, v, kv, dctx, lse, delta, dqkv, B=B, S=S, H=H,
                         drop=ft.NO_DROP, mask_id=0)
    assert emulated == ["f32l_attention_bwd", "f32l_reduce"]
    tiles = ft.attention_key_tiles(S)
    assert reduced == [[1, tiles, M * D, M, D, 3 * D]]
    # the reference in float64: the kernels' logits (a masked key -1e9, a
    # sample without a valid key uniform), the gradient through them as
    # through the plain versions' additive key bias
    heads = lambda t: t.double().reshape(B, S, H, D // H)
    qh, kh, vh, do = (heads(t) for t in (q, k, v, dctx))
    scale = 1 / np.sqrt(D // H)
    prob = torch.softmax(_logits(qh, kh, kv, B, S, S, H, scale), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", prob, vh)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vh)
    ds = prob * (dp - (dp * prob).sum(-1, keepdim=True))
    want = torch.cat([torch.einsum(eq, ds, t).reshape(M, D) * scale
                      for eq, t in (("bhqk,bkhd->bqhd", kh),
                                    ("bhqk,bqhd->bkhd", qh))]
                     + [torch.einsum("bhqk,bqhd->bkhd", prob, do
                                     ).reshape(M, D)], 1)
    _hold(ctx, o.reshape(M, D), "ctx")
    _hold(dqkv, want, "dqkv")


# -- (b) the autograd Functions on the float32 route against the JAX kernels --

@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


@pytest.fixture
def f32_route(emulated, monkeypatch):
    """The four training wrappers' forward and backward run their float32
    chains (emulated) on CPU tensors, as they do on float32 CUDA tensors;
    returns the emulated launches."""
    from ladiff_torch.ops import f32_train as ft
    from ladiff_torch.ops import train_attention as ta
    from ladiff_torch.ops import train_decoder_layer as td
    from ladiff_torch.ops import train_ffn as tf
    from ladiff_torch.ops import train_layer as tl

    def drop(rate, seed, masks):
        assert masks is None
        return _drop_args(rate, seed)

    def ta_fwd(x, kvalid, p, *, H, S, rate=0.0, seed=0, masks=None,
               return_saved=False):
        out, saved = ft.train_self_attention_f32(
            x, kvalid, p, H=H, S=S, drop=drop(rate, seed, masks))
        return (out, saved) if return_saved else out

    def ta_bwd(x, kvalid, dout, p, saved=None, *, H, S, rate=0.0, seed=0,
               masks=None):
        return ft.train_self_attention_f32_bwd(
            x, kvalid, dout, p, saved, H=H, S=S, drop=drop(rate, seed, masks))

    def tf_fwd(x, p, *, activation="gelu", rate=0.0, seed=0, masks=None,
               cluster=0):
        return ft.train_postnorm_ffn_f32(x, p, activation=activation,
                                         drop=drop(rate, seed, masks))

    def tf_bwd(x, dout, p, *, activation="gelu", rate=0.0, seed=0,
               masks=None):
        return ft.train_postnorm_ffn_f32_bwd(x, dout, p,
                                             activation=activation,
                                             drop=drop(rate, seed, masks))

    def tl_fwd(x, kvalid, p, *, H, S, activation="gelu", rate=0.0, seed=0,
               masks=None, return_saved=False):
        out, saved = ft.train_encoder_layer_f32(
            x, kvalid, p, H=H, S=S, activation=activation,
            drop=drop(rate, seed, masks))
        return (out, saved) if return_saved else out

    def tl_bwd(x, kvalid, dout, p, saved=None, *, H, S, activation="gelu",
               rate=0.0, seed=0, masks=None):
        return ft.train_encoder_layer_f32_bwd(
            x, kvalid, dout, p, saved, H=H, S=S, activation=activation,
            drop=drop(rate, seed, masks))

    def td_fwd(x, kvalid, mem, mvalid, p, *, H, S, activation="gelu",
               rate=0.0, seed=0, masks=None, return_saved=False):
        out, saved = ft.train_decoder_layer_f32(
            x, kvalid, mem, mvalid, p, H=H, S=S, activation=activation,
            drop=drop(rate, seed, masks))
        return (out, saved) if return_saved else out

    def td_bwd(x, kvalid, mem, mvalid, dout, p, saved=None, *, H, S,
               activation="gelu", rate=0.0, seed=0, masks=None):
        return ft.train_decoder_layer_f32_bwd(
            x, kvalid, mem, mvalid, dout, p, saved, H=H, S=S,
            activation=activation, drop=drop(rate, seed, masks))

    for mod, name, fn in ((ta, "train_self_attention_fwd", ta_fwd),
                          (ta, "train_self_attention_bwd", ta_bwd),
                          (tf, "train_postnorm_ffn_fwd", tf_fwd),
                          (tf, "train_postnorm_ffn_bwd", tf_bwd),
                          (tl, "train_encoder_layer_fwd", tl_fwd),
                          (tl, "train_encoder_layer_bwd", tl_bwd),
                          (td, "train_decoder_layer_fwd", td_fwd),
                          (td, "train_decoder_layer_bwd", td_bwd)):
        monkeypatch.setattr(mod, name, fn)
    return emulated


def _jax_grads(fn, args):
    want = fn(*args)
    gwant = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                     argnums=tuple(range(len(args))))(*args)
    return want, gwant


def _torch_grad(name, p, g):
    return np.asarray(g).T if p[name].dim() == 2 else np.asarray(g)


def test_train_ffn_function_matches_pallas(interpret, f32_route):
    """``train_postnorm_ffn`` on the float32 route: forward and the nine
    gradients of sum(out^2) against the Pallas pair (rate 0)."""
    from ladiff_torch.ops.train_ffn import train_postnorm_ffn
    from ladiff_tpu.ops.pallas_train_ffn import \
        train_postnorm_ffn as jax_kernel
    D, Fd, M = 128, 256, 45
    rng = np.random.RandomState(80)
    p = _params(rng, _ffn_shapes(D, Fd))
    x = torch.tensor(rng.randn(M, D) * 0.5, dtype=torch.float32)
    order = ("w1", "b1", "w2", "b2", "ln1_w", "ln1_b", "ln2_w", "ln2_b")
    args = (jnp.asarray(x.numpy()),) + tuple(
        jnp.asarray(p[k].numpy().T if p[k].dim() == 2 else p[k].numpy())
        for k in order)
    want, gwant = _jax_grads(
        lambda *a: jax_kernel(*a, jnp.int32(7), "gelu", 0.0), args)
    xt = x.clone().requires_grad_()
    pt = {k: v.clone().requires_grad_() for k, v in p.items()}
    out = train_postnorm_ffn(xt, pt, activation="gelu")
    assert relerr(out, want) <= JAX_TOL
    (out ** 2).sum().backward()
    assert relerr(xt.grad, gwant[0]) <= JAX_TOL
    for name, g in zip(order, gwant[1:]):
        assert relerr(pt[name].grad, _torch_grad(name, p, g)) <= JAX_TOL, \
            name
    assert {"f32t_lnbwd", "f32t_reduce"} <= set(f32_route)


def test_train_attention_function_matches_pallas(interpret, f32_route):
    """``train_self_attention`` on the float32 route: a key mask, S 13,
    against the Pallas pair (rate 0).  (A sample without a valid key is
    held against the plain version, the specification, in (a).)"""
    from ladiff_torch.ops.train_attention import train_self_attention
    from ladiff_tpu.ops.pallas_train_attention import \
        train_self_attention as jax_kernel
    D, H, S, lengths = 128, 2, 13, [9, 13, 4]
    M = len(lengths) * S
    rng = np.random.RandomState(81)
    p = _params(rng, _attn_shapes(D))
    x = torch.tensor(rng.randn(M, D) * 0.5, dtype=torch.float32)
    kv = _valid(lengths, S).reshape(M)
    order = ("in_w", "in_b", "out_w", "out_b")
    jkv = jnp.asarray(kv.numpy().reshape(M, 1))
    args = (jnp.asarray(x.numpy()),) + tuple(
        jnp.asarray(p[k].numpy().T if p[k].dim() == 2 else p[k].numpy())
        for k in order)
    want, gwant = _jax_grads(
        lambda x_, *w: jax_kernel(x_, jkv, *w, jnp.int32(3), H, S, 0.0), args)
    xt = x.clone().requires_grad_()
    pt = {k: v.clone().requires_grad_() for k, v in p.items()}
    out = train_self_attention(xt, kv, pt, H=H, S=S)
    assert relerr(out, want) <= JAX_TOL
    (out ** 2).sum().backward()
    assert relerr(xt.grad, gwant[0]) <= JAX_TOL
    for name, g in zip(order, gwant[1:]):
        assert relerr(pt[name].grad, _torch_grad(name, p, g)) <= JAX_TOL, \
            name
    assert "f32t_attention_bwd" in f32_route


def test_train_encoder_layer_function_matches_pallas(interpret, f32_route):
    """``train_encoder_layer`` on the float32 route against the Pallas
    kernel (rate 0), ReLU, 36 tokens."""
    from ladiff_torch.ops.train_layer import train_encoder_layer
    from ladiff_tpu.ops.pallas_train_layer import \
        train_encoder_layer as jax_kernel
    D, H, Fd, S, lengths = 128, 2, 128, 36, [24, 36]
    M = len(lengths) * S
    rng = np.random.RandomState(82)
    p = _params(rng, {**_attn_shapes(D), **_ffn_shapes(D, Fd)})
    x = torch.tensor(rng.randn(M, D) * 0.5, dtype=torch.float32)
    kv = _valid(lengths, S).reshape(M)
    order = ("in_w", "in_b", "out_w", "out_b", "w1", "b1", "w2", "b2",
             "ln1_w", "ln1_b", "ln2_w", "ln2_b")
    jkv = jnp.asarray(kv.numpy().reshape(M, 1))
    args = (jnp.asarray(x.numpy()),) + tuple(
        jnp.asarray(p[k].numpy().T if p[k].dim() == 2 else p[k].numpy())
        for k in order)
    want, gwant = _jax_grads(
        lambda x_, *w: jax_kernel(x_, jkv, *w, jnp.int32(5), H, S, 0.0,
                                  "relu"), args)
    xt = x.clone().requires_grad_()
    pt = {k: v.clone().requires_grad_() for k, v in p.items()}
    out = train_encoder_layer(xt, kv, pt, H=H, S=S, activation="relu")
    assert relerr(out, want) <= JAX_TOL
    (out ** 2).sum().backward()
    assert relerr(xt.grad, gwant[0]) <= JAX_TOL
    for name, g in zip(order, gwant[1:]):
        assert relerr(pt[name].grad, _torch_grad(name, p, g)) <= JAX_TOL, \
            name


@pytest.mark.parametrize("L,mem_len", [(1, [1, 1, 1]), (7, [7, 2, 1])])
def test_train_decoder_layer_function_matches_pallas(interpret, f32_route, L,
                                                     mem_len):
    """``train_decoder_layer`` on the float32 route against the Pallas
    kernel (rate 0): forward, dx, the memory's gradient and the eighteen
    parameter gradients; L 1 and 7, one to seven valid memory rows."""
    from ladiff_torch.ops.train_decoder_layer import train_decoder_layer
    from ladiff_tpu.ops.pallas_train_decoder_layer import \
        train_decoder_layer as jax_kernel
    D, H, Fd, S, lengths = 128, 2, 128, 36, [24, 36, 5]
    B = len(lengths)
    M = B * S
    rng = np.random.RandomState(83 + L)
    p = _params(rng, {**_attn_shapes(D, "sa_"), "ln1_w": (D,),
                      "ln1_b": (D,), **_attn_shapes(D, "ca_"),
                      **_ffn_shapes(D, Fd, ("ln2", "ln3"))})
    x = torch.tensor(rng.randn(M, D) * 0.5, dtype=torch.float32)
    mem = torch.tensor(rng.randn(B, L, D) * 0.5, dtype=torch.float32)
    kv, mv = _valid(lengths, S).reshape(M), _valid(mem_len, L)
    mats = ("sa_in_w", "sa_in_b", "sa_out_w", "sa_out_b", "ca_in_w",
            "ca_in_b", "ca_out_w", "ca_out_b", "w1", "b1", "w2", "b2")
    lns = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "ln3_w", "ln3_b")
    jkv, jmv = jnp.asarray(kv.numpy().reshape(M, 1)), jnp.asarray(mv.numpy())
    args = (jnp.asarray(x.numpy()), jnp.asarray(mem.numpy())) + tuple(
        jnp.asarray(p[k].numpy().T if p[k].dim() == 2 else p[k].numpy())
        for k in mats + lns)
    want, gwant = _jax_grads(
        lambda x_, m_, *a: jax_kernel(x_, jkv, m_, jmv, *a[:12],
                                      tuple(a[12:]), jnp.int32(6), H, S, L,
                                      0.0, "gelu"), args)
    xt, mt = x.clone().requires_grad_(), mem.clone().requires_grad_()
    pt = {k: v.clone().requires_grad_() for k, v in p.items()}
    out = train_decoder_layer(xt, kv, mt, mv, pt, H=H, S=S)
    assert relerr(out, want) <= JAX_TOL
    (out ** 2).sum().backward()
    assert relerr(xt.grad, gwant[0]) <= JAX_TOL
    assert relerr(mt.grad, gwant[1]) <= JAX_TOL
    for name, g in zip(mats + lns, gwant[2:]):
        assert relerr(pt[name].grad, _torch_grad(name, p, g)) <= JAX_TOL, \
            name


# -- (c) a float32 stage-1 pass on the kernel route against the JAX package --

def test_vae_forward_on_the_float32_kernel_route_matches_jax(f32_route):
    """A small VAE's float32 stage-1 ``vae_forward`` (training mode, dropout
    0) and its backward with every training layer on the float32 chains of
    kernels 8 and 9 (emulated): the loss within 1e-4 of the JAX package's,
    every VAE gradient name by name within 1e-3 and the whole gradient
    vector within 1e-4, as ``tests/test_torch_train.py`` holds the plain
    route."""
    from ladiff_torch.convert import flax_state_dict
    from test_torch_train import _eps_of, _jax_batch, _systems, _torch_batch
    jsys, params, tsys, batch = _systems(64)
    key = jax.random.PRNGKey(9)
    want, gtree = jax.jit(jax.value_and_grad(lambda p: jsys.vae_forward(
        p, _jax_batch(batch), key, train=True)[0]))(params["vae"])
    got, _ = tsys.vae_forward(_torch_batch(batch), train=True,
                              eps=_eps_of(key))
    got.backward()
    launched = set(f32_route)
    assert {"f32t_attention", "f32t_attention_bwd", "f32t_lnbwd"} <= launched
    assert relerr(got.detach(), want) <= JAX_TOL
    gwant = flax_state_dict(gtree, "vae.")
    named = dict(tsys.named_parameters())
    for name, g in gwant.items():
        assert relerr(named[name].grad, g.numpy()) <= 1e-3, name
    flat = lambda d: np.concatenate([d[n].reshape(-1) for n in sorted(gwant)])
    assert relerr(flat({n: named[n].grad.numpy() for n in gwant}),
                  flat({n: g.numpy() for n, g in gwant.items()})) <= JAX_TOL
