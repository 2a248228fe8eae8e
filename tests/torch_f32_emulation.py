"""The launches of the float32 kernels emulated on the CPU, for the tests
of the float32 routes (``tests/test_torch_f32_layer.py``,
``tests/test_torch_f32_routes.py``, ``tests/test_torch_f32_train.py``):
the FFMA chains' entry points of ``csrc/f32_layer.cu`` (K1, kernels 5, 6,
7 and 11) and the tensor-core entry points of ``csrc/f32_train_layer.cu``
(``f32l_*``: the float32 K2 and kernel 10, and the training kernels 12
and 13), one copy for every test file.

The kernels run on the card only.  The ``emulated`` fixture replaces
``f32_layer.launch`` by an emulation of their C entry points that reads
and writes the very memory the pointers, row strides and ints name (CPU
tensors' addresses, through ``ctypes``), computing each kernel's contract
in float64 PyTorch, and checks the 16-byte alignment of the rows the
kernels read with 16-byte loads: so the routes' pointers, strides, slices
and arguments are held on the CPU, the kernels' arithmetic on the card
(``chip_smoke.py`` ``kernels_f32``, ``train_kernels_f32``,
``tests/test_torch_cuda.py``).  The tensor-core products are emulated as
the tensor cores compute them: each operand rounded to float32 and split
into a TF32 hi and lo part (``_split``), lo hi + hi lo + hi hi summed in
float64 (``_mm3``).  Dropout keep-scales come from a numpy Philox-4x32-10
that mirrors ``csrc/common.cuh`` ``keep_scale`` (the seed's two words as
the key, counter (element / 4, mask id, 0), word element % 4, kept below
keep * 2^32).
"""
import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

NEG = -1e9
U32 = np.uint64(0xFFFFFFFF)


# -- memory ------------------------------------------------------------------

def _view(ptr, rows, cols, ld):
    """A [rows, cols] float32 view of the memory at ``ptr`` with row stride
    ``ld``."""
    n = (rows - 1) * ld + cols
    buf = torch.frombuffer((ctypes.c_float * n).from_address(ptr),
                           dtype=torch.float32)
    return buf.as_strided((rows, cols), (ld, 1))


def _vec(ptr, n):
    return None if not ptr else _view(ptr, 1, n, n)[0]


# -- the FFMA chains' entry points (csrc/f32_layer.cu) -------------------------

def _linear(p, n, f):
    M, N, K, lda, ldr, ldc, act = n
    # the kernel reads A's and W's rows in 16-byte pieces
    assert K % 4 == 0 and lda % 4 == 0 and p[0] % 16 == 0 and p[1] % 16 == 0
    a = _view(p[0], M, K, lda).double()
    w = _view(p[1], N, K, K).double()
    y = a @ w.T
    if p[2]:
        y = y + _vec(p[2], N).double()
    y = {0: y, 1: torch.relu(y), 2: F.gelu(y)}[act]
    if p[3]:
        y = y + _view(p[3], M, N, ldr).double()
    _view(p[4], M, N, ldc).copy_(y)


def _rownorm(p, n, f):
    M, D, lds, src_div, ss_div, ldo = n
    rows = torch.arange(M) // src_div
    x = _view(p[0], int(rows.max()) + 1, D, lds).double()[rows]
    if p[1]:
        x = x * _vec(p[1], M).double()[:, None]
    y = F.layer_norm(x, (D,), _vec(p[2], D).double(), _vec(p[3], D).double(),
                     1e-5)
    if p[4]:
        s = torch.arange(M) // ss_div if ss_div else torch.zeros(M).long()
        ss = _view(p[4], int(s.max()) + 1, 2 * D, 2 * D).double()[s]
        y = F.silu(y * (1 + ss[:, :D]) + ss[:, D:])
    _view(p[5], M, D, ldo).copy_(y)


def _attention(p, n, f):
    B, Sq, n1, n2, H, Dh, ldq, ldk1, ldk2, ldo = n
    # the kernel reads q, k and v rows in 16-byte pieces
    assert Dh % 4 == 0 and ldq % 4 == 0 and ldk1 % 4 == 0 and ldk2 % 4 == 0
    assert all(ptr % 16 == 0 for ptr in p[:3] + [q for q in p[4:6] if q])
    D = H * Dh
    q = _view(p[0], B * Sq, D, ldq).double().reshape(B, Sq, H, Dh)
    k = _view(p[1], B * n1, D, ldk1).double().reshape(B, n1, D)
    v = _view(p[2], B * n1, D, ldk1).double().reshape(B, n1, D)
    valid = (torch.ones(B, n1, dtype=torch.bool) if not p[3]
             else _vec(p[3], B * n1).reshape(B, n1) > 0.5)
    if n2:
        k = torch.cat([k, _view(p[4], B * n2, D, ldk2).double().reshape(
            B, n2, D)], 1)
        v = torch.cat([v, _view(p[5], B * n2, D, ldk2).double().reshape(
            B, n2, D)], 1)
        valid = torch.cat([valid, torch.ones(B, n2, dtype=torch.bool)], 1)
    kh = k.reshape(B, -1, H, Dh)
    vh = v.reshape(B, -1, H, Dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q * f[0], kh)
    s = s.masked_fill(~valid[:, None, None, :], NEG)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vh)
    _view(p[6], B * Sq, D, ldo).copy_(o.reshape(B * Sq, D))


# -- the dropout generator ----------------------------------------------------

def _philox(c, k0, k1):
    """Philox-4x32-10 of the counter words c (uint64 arrays holding 32
    bits) under the key (k0, k1), as ``common.cuh`` ``philox4x32_10``."""
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & U32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & U32]
        k0 = (k0 + np.uint64(0x9E3779B9)) & U32
        k1 = (k1 + np.uint64(0xBB67AE85)) & U32
    return c


def _philox_bits(lo: int, hi: int, mask_id: int, idx: np.ndarray):
    """The 32-bit word of Philox-4x32-10 that ``keep_scale`` reads for the
    elements ``idx`` of mask ``mask_id`` under the seed (lo, hi)."""
    idx = np.asarray(idx, dtype=np.uint64)
    q = idx >> np.uint64(2)
    c = _philox([q & U32, q >> np.uint64(32),
                 np.full_like(q, np.uint64(mask_id)), np.zeros_like(q)],
                lo & 0xFFFFFFFF, hi & 0xFFFFFFFF)
    return np.choose((idx & np.uint64(3)).astype(np.int64), c)


def _keep(lo: int, hi: int, rate: float, mask_id: int, idx):
    """``keep_scale``: 0 or 1 / keep (float32) per element; the rate comes
    as a float32, as the C entry points take it."""
    keep = 1.0 - float(np.float32(rate))
    t = keep * 4294967296.0
    thresh = 4294967295 if t >= 4294967295.0 else int(t)
    bits = _philox_bits(lo, hi, mask_id, idx)
    return np.where(bits < np.uint64(thresh), np.float32(1.0 / keep),
                    np.float32(0.0))


# -- shared by the entry points ------------------------------------------------

def _act(v, act):
    return {0: v, 1: torch.relu(v), 2: F.gelu(v)}[act]


def _act_grad(a, act):
    if act == 1:
        return (a > 0).double()
    cdf = 0.5 * (1 + torch.erf(a / np.sqrt(2.0)))
    return cdf + a * torch.exp(-0.5 * a * a) / np.sqrt(2 * np.pi)


def _drop(lo, hi, rate, mask_id, shape, idx=None):
    if rate <= 0:
        return 1.0
    idx = np.arange(int(np.prod(shape))) if idx is None else idx
    return torch.tensor(_keep(lo, hi, rate, mask_id, idx).reshape(
        shape)).double()


def _logits(q, k, valid, B, Sq, Nk, H, scale):
    """The attention's logits [B, H, Sq, Nk] under the kernels' rule: -1e9
    for a masked key, every logit 0 in a sample without a valid key."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if valid is None:
        return s
    ok = valid.reshape(B, 1, 1, Nk) > 0.5
    s = torch.where(ok, s, torch.full_like(s, NEG))
    none = ~ok.reshape(B, Nk).any(1)
    s[none] = 0.0
    return s


def _attn_views(p, n):
    B, Sq, Nk, H, Dh, ldq, ldk = n[:7]
    D = H * Dh
    assert Dh % 4 == 0 and ldq % 4 == 0 and ldk % 4 == 0
    assert all(ptr % 16 == 0 for ptr in p[:3])
    q = _view(p[0], B * Sq, D, ldq).double().reshape(B, Sq, H, Dh)
    k = _view(p[1], B * Nk, D, ldk).double().reshape(B, Nk, H, Dh)
    v = _view(p[2], B * Nk, D, ldk).double().reshape(B, Nk, H, Dh)
    valid = _vec(p[3], B * Nk)
    return q, k, v, valid


# -- the tensor-core entry points (csrc/f32_train_layer.cu) -------------------

def _tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits of the result are 0)."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x: torch.Tensor):
    """The three-term split of float32 values as the tensor cores see it:
    (hi, lo) with hi = tf32(x) and lo = x - hi cut to its top 10 mantissa
    bits (the tensor core ignores a TF32 operand's 13 low bits), as float64
    tensors."""
    v = x.detach().float().numpy()
    hi = _tf32(v)
    lo = (v - hi).view(np.uint32) & np.uint32(0xFFFFE000)
    return (torch.from_numpy(hi).double(),
            torch.from_numpy(lo.view(np.float32)).double())


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the tensor cores compute it in three-term TF32: each
    operand rounded to float32 and split, lo hi + hi lo + hi hi (the sums
    in float64)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _ln_bwd_rows(x, w, g):
    """(dx, xhat) of the LayerNorm of x's backward for g (float64)."""
    mu = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    xhat = (x - mu) * rstd
    gw = g * w
    return rstd * (gw - gw.mean(-1, keepdim=True)
                   - xhat * (gw * xhat).mean(-1, keepdim=True)), xhat


def _block_sums(part, g, xhat, D):
    """The column sums of g xhat and g of each 64-row block."""
    for z in range(part.shape[0]):
        r = slice(64 * z, 64 * (z + 1))
        part[z, :D] = (g[r] * xhat[r]).sum(0)
        part[z, D:2 * D] = g[r].sum(0)


def _tc_gemm(p, n, f):
    nprob, lo, hi = n[:3]
    kinds = set()
    for i in range(nprob):
        pp = p[16 * i:16 * (i + 1)]
        (M, N, K, lda, ldb, ldc, a_mn, b_mn, act, ldpre, ldg, gact, ldr,
         mid, ksplit, row, ldx, ldlnx, mid2, ldpart, ldctx, H, cstride,
         sstride, kflush, tile) = n[3 + 26 * i:3 + 26 * (i + 1)]
        kinds.add((a_mn, b_mn, cstride > 0, row > 0, tile))
        # the tiles the library has: 128 or 64-row products, 64 or 32-row
        # row blocks; the inference ones with K-major weights and (row
        # blocks) a LayerNorm after the residual
        assert tile in ((0,) if cstride else (0, 64, 32) if row
                        else (0, 128, 64))
        if tile not in (0, 64 if row else 128):
            assert not b_mn and row in (0, 1)
        # each operand is read in 16-byte pieces along its contiguous
        # dimension; the epilogue writes pairs
        for mn, ptr, ld, dim in ((a_mn, pp[0], lda, M), (b_mn, pp[1], ldb, N)):
            assert (dim if mn else K) % 4 == 0 and ld % 4 == 0
            assert ptr % 16 == 0
        assert ksplit % 16 == 0 and N % 4 == 0 and ldc % 2 == 0
        A = (_view(pp[0], K, M, lda).T if a_mn else _view(pp[0], M, K, lda))
        B = (_view(pp[1], K, N, ldb).T if b_mn else _view(pp[1], N, K, ldb))
        if cstride:  # split-K partials of kflush rows, the column sums
            assert a_mn and b_mn and not any(pp[3:7]) and not row
            assert kflush % 16 == 0
            nsub = -(-ksplit // kflush)
            for z in range(-(-K // ksplit)):
                k0, k1 = z * ksplit, min(K, (z + 1) * ksplit)
                for s in range(nsub):  # zeros past the split's rows
                    r = slice(min(k1, k0 + s * kflush),
                              min(k1, k0 + (s + 1) * kflush))
                    _view(pp[2] + 4 * (z * nsub + s) * cstride, M, N,
                          ldc).copy_(_mm3(A[:, r], B[:, r].T))
                if pp[7]:
                    _vec(pp[7] + 4 * z * sstride, M).copy_(
                        A[:, k0:k1].double().sum(1))
            continue
        assert ksplit >= K and not pp[7]
        v = _mm3(A, B.T)
        if pp[3]:
            v = v + _vec(pp[3], N).double()
        if pp[4]:
            _view(pp[4], M, N, ldpre).copy_(v)
        v = _act(v, act)
        if pp[5]:
            v = v * _act_grad(_view(pp[5], M, N, ldg).double(), gact)
        if mid >= 0:
            v = v * _drop(lo, hi, f[0], mid, (M, N))
        if pp[6]:
            v = v + _view(pp[6], M, N, ldr).double()
        if row == 0:
            _view(pp[2], M, N, ldc).copy_(v)
            continue
        assert N <= 256 and N % 32 == 0
        if row == 1:  # the LayerNorm after the residual (and v itself)
            if pp[8]:
                _view(pp[8], M, N, ldx).copy_(v)
            _view(pp[2], M, N, ldc).copy_(F.layer_norm(
                v, (N,), _vec(pp[9], N).double(), _vec(pp[10], N).double(),
                1e-5))
        elif row == 2:  # a LayerNorm's backward for g = v
            dx, xhat = _ln_bwd_rows(_view(pp[11], M, N, ldlnx).double(),
                                    _vec(pp[9], N).double(), v)
            _view(pp[2], M, N, ldc).copy_(dx)
            if pp[12]:
                _view(pp[12], M, N, ldc).copy_(
                    dx * (_drop(lo, hi, f[0], mid2, (M, N))
                          if mid2 >= 0 else 1.0))
            if pp[13]:
                assert ldpart >= 2 * N
                _block_sums(_view(pp[13], -(-M // 64), 2 * N, ldpart), v,
                            xhat, N)
        else:  # delta = v . ctx per head
            _view(pp[2], M, N, ldc).copy_(v)
            ctx = _view(pp[14], M, N, ldctx).double()
            _view(pp[15], M, H, H).copy_(
                (v * ctx).reshape(M, H, N // H).sum(-1))
    assert len(kinds) == 1  # one layout and epilogue kind a launch


def _heads(t):
    """[B, S, H, Dh] -> [B, H, S, Dh]"""
    return t.permute(0, 2, 1, 3)


def _tc_attention(p, n, f):
    B, Sq, Nk, H, Dh, ldq, ldk, ldo, mid, lo, hi = n
    assert Dh in (16, 32, 48, 64) and ldo % 2 == 0 and p[4] % 8 == 0
    q, k, v, valid = _attn_views(p, n)
    s = _logits_of(_mm3(_heads(q), _heads(k).transpose(-1, -2)), valid, B,
                   Nk, f[0])
    prob = torch.softmax(s, -1)
    if mid >= 0:
        prob = prob * _drop(lo, hi, f[1], mid, (B, H, Sq, Nk))
    o = _mm3(prob, _heads(v)).transpose(1, 2)
    _view(p[4], B * Sq, H * Dh, ldo).copy_(o.reshape(B * Sq, H * Dh))
    _view(p[5], B * Sq, H, H).copy_(
        torch.logsumexp(s, -1).transpose(1, 2).reshape(B * Sq, H))


def _tc_masked_attention(p, n, f):
    B, Sq, Nk, H, Dh, ldq, ldk, ldo = n
    assert Dh % 16 == 0 and 16 <= Dh <= 128
    assert ldo % 2 == 0 and p[4] % 8 == 0
    q, k, v, valid = _attn_views(p, n)
    s = _logits_of(_mm3(_heads(q), _heads(k).transpose(-1, -2)), valid, B,
                   Nk, f[0])
    o = _mm3(torch.softmax(s, -1), _heads(v)).transpose(1, 2)
    _view(p[4], B * Sq, H * Dh, ldo).copy_(o.reshape(B * Sq, H * Dh))


def _logits_of(raw, valid, B, Nk, scale):
    """The kernels' logits from raw scores [B, H, Sq, Nk]."""
    s = raw * scale
    if valid is None:
        return s
    ok = valid.reshape(B, 1, 1, Nk) > 0.5
    s = torch.where(ok, s, torch.full_like(s, NEG))
    s[~ok.reshape(B, Nk).any(1)] = 0.0
    return s


def _tc_attention_bwd(p, n, f):
    B, Sq, Nk, H, Dh, ldq, ldk, ldd, lddk, mid, lo, hi = n
    q, k, v, valid = _attn_views(p, n)
    assert ldd % 4 == 0 and p[4] % 16 == 0 and lddk % 2 == 0
    assert p[8] % 8 == 0 and p[9] % 8 == 0
    D = H * Dh
    do = _heads(_view(p[4], B * Sq, D, ldd).double().reshape(B, Sq, H, Dh))
    lse = _view(p[5], B * Sq, H, H).double().reshape(B, Sq, H).transpose(1, 2)
    delta = _view(p[6], B * Sq, H, H).double().reshape(B, Sq, H).transpose(
        1, 2)
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    s = _logits_of(_mm3(qh, kh.transpose(-1, -2)), valid, B, Nk, f[0])
    prob = torch.exp(s - lse[..., None])
    keep = (_drop(lo, hi, f[1], mid, (B, H, Sq, Nk)) if mid >= 0 else 1.0)
    dp = _mm3(do, vh.transpose(-1, -2))
    ds = prob * (dp * keep - delta[..., None])
    dk = _mm3(ds.transpose(-1, -2), qh) * f[0]
    dv = _mm3((prob * keep).transpose(-1, -2), do)
    _view(p[8], B * Nk, D, lddk).copy_(dk.transpose(1, 2).reshape(B * Nk, D))
    _view(p[9], B * Nk, D, lddk).copy_(dv.transpose(1, 2).reshape(B * Nk, D))
    # key tile t's share of dq, one partial each
    for t in range(-(-Nk // 64)):
        kt = slice(64 * t, 64 * (t + 1))
        dq = _mm3(ds[..., kt], kh[:, :, kt]) * f[0]
        _view(p[7] + 4 * t * B * Sq * D, B * Sq, D, D).copy_(
            dq.transpose(1, 2).reshape(B * Sq, D))


def _cross_views(p, n, widest=128):
    B, S, L, H, Dh, ldq, ldkv = n[:7]
    D = H * Dh
    assert L <= 8 and Dh <= widest
    q = _view(p[0], B * S, D, ldq).double().reshape(B, S, H, Dh)
    kv = _view(p[1], B * L, 2 * D, ldkv).double()
    k = kv[:, :D].reshape(B, L, H, Dh)
    v = kv[:, D:].reshape(B, L, H, Dh)
    return q, k, v


def _tc_cross(p, n, f):
    B, S, L, H, Dh, ldq, ldkv, ldo, mid, lo, hi = n
    q, k, v = _cross_views(p, n)
    s = _logits(q, k, _vec(p[2], B * L), B, S, L, H, f[0])
    prob = torch.softmax(s, -1)
    if mid >= 0:
        prob = prob * _drop(lo, hi, f[1], mid, (B, H, S, L))
    o = torch.einsum("bhqk,bkhd->bqhd", prob, v)
    _view(p[3], B * S, H * Dh, ldo).copy_(o.reshape(B * S, H * Dh))
    if p[4]:  # the log-sum-exp (training)
        _view(p[4], B * S, H, H).copy_(
            torch.logsumexp(s, -1).transpose(1, 2).reshape(B * S, H))


def _tc_cross_bwd(p, n, f):
    B, S, L, H, Dh, ldq, ldkv, ldd, lddq, lddkv, mid, lo, hi = n
    D = H * Dh
    q, k, v = _cross_views(p, n, widest=64)
    s = _logits(q, k, _vec(p[2], B * L), B, S, L, H, f[0])
    do = _view(p[3], B * S, D, ldd).double().reshape(B, S, H, Dh)
    lse = _view(p[4], B * S, H, H).double().reshape(B, S, H).transpose(1, 2)
    delta = _view(p[5], B * S, H, H).double().reshape(B, S, H).transpose(
        1, 2)
    prob = torch.exp(s - lse[..., None])
    keep = _drop(lo, hi, f[1], mid, (B, H, S, L))
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = prob * (dp * keep - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * f[0]
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * f[0]
    dv = torch.einsum("bhqk,bqhd->bkhd", prob * keep, do)
    _view(p[6], B * S, D, lddq).copy_(dq.reshape(B * S, D))
    dkv = _view(p[7], B * L, 2 * D, lddkv)
    dkv[:, :D] = dk.reshape(B * L, D)
    dkv[:, D:] = dv.reshape(B * L, D)


def _tc_ln_bwd(p, n, f):
    M, D, ldx, ldg, lddx, ldpart, mid, lo, hi = n
    assert D % 32 == 0 and D <= 256 and ldpart >= 2 * D
    g = _view(p[2], M, D, ldg).double()
    dx, xhat = _ln_bwd_rows(_view(p[0], M, D, ldx).double(),
                            _vec(p[1], D).double(), g)
    _view(p[3], M, D, lddx).copy_(dx)
    if p[4]:
        _view(p[4], M, D, lddx).copy_(dx * _drop(lo, hi, f[0], mid, (M, D)))
    _block_sums(_view(p[5], -(-M // 64), 2 * D, ldpart), g, xhat, D)


def _tc_reduce(p, n, f):
    for i in range(n[0]):
        splits, pstride, rows, cols, ldo = n[1 + 5 * i:6 + 5 * i]
        assert ldo >= cols and (splits == 1 or pstride >= rows * cols)
        total = torch.zeros(rows * cols, dtype=torch.float32)
        for z in range(splits):  # in split order, in float32
            total += _view(p[2 * i] + 4 * z * pstride, 1, rows * cols,
                           rows * cols)[0]
        _view(p[2 * i + 1], rows, cols, ldo).copy_(total.reshape(rows, cols))


TC_ENTRY = {"f32l_gemm": _tc_gemm, "f32l_attention": _tc_attention,
            "f32l_attention_bwd": _tc_attention_bwd,
            "f32l_masked_attention": _tc_masked_attention,
            "f32l_cross_attention": _tc_cross,
            "f32l_cross_attention_bwd": _tc_cross_bwd,
            "f32l_ln_bwd": _tc_ln_bwd, "f32l_reduce": _tc_reduce}
_ENTRY = {"f32_linear": _linear, "f32_rownorm": _rownorm,
          "f32_attention": _attention, **TC_ENTRY}


@pytest.fixture
def emulated(monkeypatch):
    """``f32_layer``'s launches run the emulation; returns the launches
    made, by entry point."""
    from ladiff_torch.ops import f32_layer
    made = []

    def fake(lib, fn, device, ptrs, ints, floats=()):
        assert lib == ("f32_train_layer" if fn in TC_ENTRY else "f32_layer")
        _ENTRY[fn](list(ptrs), list(ints), list(floats))
        made.append(fn)

    monkeypatch.setattr(f32_layer, "launch", fake)
    return made
