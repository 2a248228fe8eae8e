"""The launches of ``csrc/f32_layer.cu`` emulated on the CPU, for the tests
of the float32 chains (``tests/test_torch_f32_layer.py``,
``tests/test_torch_f32_routes.py``; ``tests/test_torch_f32_train.py``
reads memory the same way).

The chains' kernels run on the card only.  The ``emulated`` fixture
replaces ``f32_layer.launch`` by an emulation of their C entry points that
reads and writes the very memory the pointers, row strides and ints name
(CPU tensors' addresses, through ``ctypes``), computing each kernel's
contract in float64 PyTorch, and checks the 16-byte alignment of the rows
the kernels read with cp.async: so the chains' pointers, strides, slices
and arguments are held on the CPU, the kernels' arithmetic on the card
(``chip_smoke.py`` ``kernels_f32``, ``tests/test_torch_cuda.py``).
"""
import ctypes

import pytest
import torch
import torch.nn.functional as F

NEG = -1e9


def _view(ptr, rows, cols, ld):
    """A [rows, cols] float32 view of the memory at ``ptr`` with row stride
    ``ld``."""
    n = (rows - 1) * ld + cols
    buf = torch.frombuffer((ctypes.c_float * n).from_address(ptr),
                           dtype=torch.float32)
    return buf.as_strided((rows, cols), (ld, 1))


def _vec(ptr, n):
    return None if not ptr else _view(ptr, 1, n, n)[0]


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


_ENTRY = {"f32_linear": _linear, "f32_rownorm": _rownorm,
          "f32_attention": _attention}


@pytest.fixture
def emulated(monkeypatch):
    """``f32_layer``'s launches run the emulation; returns the launches
    made, by entry point."""
    from ladiff_torch.ops import f32_layer
    made = []

    def fake(lib, fn, device, ptrs, ints, floats=()):
        assert lib == "f32_layer"
        _ENTRY[fn](list(ptrs), list(ints), list(floats))
        made.append(fn)

    monkeypatch.setattr(f32_layer, "launch", fake)
    return made
