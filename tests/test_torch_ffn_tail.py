"""The FFN tail's gates and launch geometry (kernels 5 and 9), on the CPU:
the wrappers' shape check refuses exactly the shapes the route gate sends
to plain ops, and ``ffn_geometry`` splits a block's hidden width over a
cluster only where the blocks alone cannot fill the card.  Pure Python:
nothing is launched or built.  The kernels' parity with the JAX package
is in test_torch_train.py and test_torch_md_routes.py, their agreement
with the plain versions on the card in test_torch_cuda.py.
"""
import pytest
import torch

from ladiff_torch.ops import cuda_common as cc
from ladiff_torch.ops.postnorm_ffn import (check_ffn_shape, ffn_geometry,
                                           postnorm_ffn_supported)

# CTAs of the tail that an H100 holds at once: one per SM
H100_SLOTS = 132


@pytest.mark.parametrize("Fd", [128, 192, 1024, 1152])
@pytest.mark.parametrize("D", [64, 96, 128, 160, 192, 256])
def test_shape_check_matches_the_route_gate(D, Fd):
    """``check_ffn_shape`` (kernels 5 and 9) raises exactly where
    ``postnorm_ffn_supported`` sends the tail to plain ops: D 96, 160 or
    224 has no instantiation of the 64-row body."""
    cc.reset_launch_counts()
    x = torch.zeros(3, D)
    p = {"w1": torch.zeros(Fd, D), "w2": torch.zeros(D, Fd)}
    for activation in ("relu", "gelu"):
        if postnorm_ffn_supported(D, Fd, activation):
            assert check_ffn_shape("k", x, p, activation) == Fd
        else:
            with pytest.raises(ValueError, match="unsupported shape"):
                check_ffn_shape("k", x, p, activation)
    assert not postnorm_ffn_supported(D, Fd, "silu")
    with pytest.raises(ValueError):
        check_ffn_shape("k", x, p, "silu")
    assert not any(cc.launch_counts().values())


@pytest.mark.parametrize("M", [26368, 25088, 2560, 640, 1000, 20])
def test_ffn_launch_geometry(M):
    """The blocks cover M in 64-row blocks; C is 1 where the blocks fill the
    card (the VAE's 128 x 206 and 128 x 196 rows), else the largest of 2 and
    4 whose CTAs still fit the slots at once; F / C stays a multiple of
    128; a requested C is taken where it splits F so."""
    blocks, C, ctas = ffn_geometry(M, 256, 1024, H100_SLOTS)
    assert blocks == -(-M // 64) and ctas == blocks * C
    assert C in (1, 2, 4) and 1024 // C % 128 == 0
    if M in (26368, 25088):
        assert C == 1 and blocks > H100_SLOTS
    if M in (2560, 640, 20):
        assert C > 1 and ctas <= H100_SLOTS
        assert C == 4 or 2 * ctas > H100_SLOTS  # the widest C that fits
    if M == 20:
        assert blocks == 1
    for Fd in (128, 256, 384, 512):
        _, c, _ = ffn_geometry(M, 256, Fd, H100_SLOTS)
        assert c <= Fd // 128 and Fd // c % 128 == 0
    assert ffn_geometry(M, 256, 1024, H100_SLOTS, cluster=2)[1] == 2
    with pytest.raises(ValueError):
        ffn_geometry(M, 256, 384, H100_SLOTS, cluster=2)
