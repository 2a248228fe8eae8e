"""The port's operator extras against the JAX package on the CPU: AdaIN
(instance-normalized, and both direct-weighting variants),
``split_adain_params`` / ``num_adain_params``, ``LinearBlock`` for each norm
(BatchNorm on its running statistics, LayerNorm at eps 1e-6, none) and
activation, ``ConvBlock`` for each pad and norm (AdaIN with a style,
affine instance norm, none), ``MLP``, and ``hessian_penalty`` with the JAX
Rademacher directions replayed, its value and its gradient through G's
parameters against ``jax.grad``.

The port's sequences are ``[B, C, T]``, the JAX package's channels-last.
Tolerance 1e-4 norm-wise (PERF.md section 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import extras_state_dict
from ladiff_torch.ops import extras as port
from ladiff_tpu.ops import extras as ref
from torch_alt_helpers import (TOL, jitted, loaded, noise_tree, relerr,
                               shapes, t)


def _seq(seed, B=3, T=9, C=6):
    return np.random.RandomState(seed).randn(B, T, C).astype(np.float32)


def _ct(a):
    return t(a).transpose(1, 2)


@pytest.mark.parametrize("direct,no_std", [(False, False), (True, False),
                                           (True, True)])
def test_adain_matches_jax(direct, no_std):
    x = _seq(0)
    rng = np.random.RandomState(1)
    w, b = (rng.randn(3, 6).astype(np.float32) for _ in range(2))
    want = ref.adaptive_instance_norm_1d(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b),
                                         direct_weighting=direct,
                                         no_std=no_std)
    got = port.adaptive_instance_norm_1d(_ct(x), t(w), t(b),
                                         direct_weighting=direct,
                                         no_std=no_std)
    assert relerr(got.transpose(1, 2).numpy(), want) <= 1e-6


def test_split_adain_params_matches_jax():
    sizes = (4, 6, 2)
    p = np.random.RandomState(2).randn(3, 24).astype(np.float32)
    assert port.num_adain_params(sizes) == ref.num_adain_params(sizes) == 24
    for (m, s), (mj, sj) in zip(port.split_adain_params(t(p), sizes),
                                ref.split_adain_params(jnp.asarray(p),
                                                       sizes)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("norm,acti", [("bn", "relu"), ("in", "lrelu"),
                                       ("none", "tanh"), ("none", "none")])
def test_linear_block_matches_jax(norm, acti):
    jm = ref.LinearBlock(7, norm=norm, acti=acti)
    x = np.random.RandomState(3).randn(5, 4).astype(np.float32)
    variables = noise_tree(shapes(jm, x), 4)
    want = jitted(jm)(variables, x)
    m = loaded(port.LinearBlock(4, 7, norm=norm, acti=acti),
               extras_state_dict(variables["params"],
                                 variables.get("batch_stats")))
    with torch.no_grad():
        got = m(t(x))
    assert relerr(got.numpy(), want) <= TOL
    if norm == "bn":  # the running statistics do not move in training mode
        before = m.norm.running_mean.clone()
        m.train()(t(x))
        assert torch.equal(m.norm.running_mean, before)


@pytest.mark.parametrize("pad", ["reflect", "replicate", "zero"])
@pytest.mark.parametrize("norm", ["adain", "in", "none"])
def test_conv_block_matches_jax(pad, norm):
    """Kernel 4 (pads 1 and 2), stride 1; stride 2 for the "none" norm."""
    x = _seq(5)
    stride = 2 if norm == "none" else 1
    style = None
    if norm == "adain":
        rng = np.random.RandomState(6)
        style = tuple(rng.randn(3, 8).astype(np.float32) for _ in range(2))
    jm = ref.ConvBlock(4, 8, stride=stride, pad_type=pad, norm=norm,
                       adain_style=None if style is None
                       else tuple(jnp.asarray(s) for s in style))
    params = noise_tree(shapes(jm, x), 7)["params"]
    want = jitted(jm)({"params": params}, x)
    m = loaded(port.ConvBlock(6, 4, 8, stride=stride, pad_type=pad,
                              norm=norm), extras_state_dict(params))
    with torch.no_grad():
        got = m(_ct(x), None if style is None else tuple(map(t, style)))
    assert got.shape == (3, 8, want.shape[1])
    assert relerr(got.transpose(1, 2).numpy(), want) <= TOL


def test_mlp_matches_jax():
    jm = ref.MLP(dims=(12, 16, 10), out_dim=5)
    x = np.random.RandomState(8).randn(4, 3, 4).astype(np.float32)
    params = noise_tree(shapes(jm, x), 9)["params"]
    want = jitted(jm)({"params": params}, x)
    m = loaded(port.MLP((12, 16, 10), 5), extras_state_dict(params))
    with torch.no_grad():
        got = m(t(x))
    assert relerr(got.numpy(), want) <= TOL


def test_hessian_penalty_matches_jax():
    """G a tanh ``LinearBlock`` with two outputs (the block's and its
    square); k 3 directions, the JAX draw replayed; the penalty and its
    gradient through G's parameters."""
    jm = ref.LinearBlock(6, acti="tanh")
    z = np.random.RandomState(10).randn(4, 5).astype(np.float32)
    params = noise_tree(shapes(jm, z), 11)["params"]
    key = jax.random.PRNGKey(12)

    def penalty(p):
        def G(v):
            y = jm.apply({"params": p}, v)
            return [y, y ** 2]
        return ref.hessian_penalty(G, jnp.asarray(z), key, k=3)

    want, grads = jax.jit(jax.value_and_grad(penalty))(params)
    dirs = jax.random.rademacher(key, (3, 4, 5), dtype=jnp.float32)
    m = loaded(port.LinearBlock(5, 6, acti="tanh"), extras_state_dict(params))

    def G(v):
        y = m(v)
        return [y, y ** 2]

    got = port.hessian_penalty(G, t(z), k=3, directions=t(dirs))
    got.backward()
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    gw = extras_state_dict(grads)
    for name, p in m.named_parameters():
        assert relerr(p.grad.numpy(), gw[name].numpy()) <= TOL, name
    drawn = port.hessian_penalty(G, t(z), k=3,
                                 generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn)
