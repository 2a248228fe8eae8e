"""Shared helpers of the alternate models' parity tests
(``tests/test_torch_{motionclip,mdiff,bert_text,vq,vit,extras}.py``): JAX
parameter trees from ``jax.eval_shape`` filled with seeded numpy noise,
jitted JAX calls, and the tolerances of PERF.md section 2."""
import jax
import numpy as np
import torch

from test_torch_slice import relerr  # noqa: F401  (re-exported)

# forwards and gradients, float32 on both sides: the same math with sums in
# another order
TOL = 1e-4


def shapes(module, *args, method=None, **kw):
    """The variables tree of ``module.init`` (every collection), as
    shapes only: nothing is initialized or compiled."""
    return jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method,
                            **kw))


def noise_tree(tree, seed: int):
    """Numpy float32 leaves of ``tree``'s shapes: weights ~ N(0, 1 /
    fan_in), LayerNorm / GroupNorm / BatchNorm scales 1 + N(0, 0.1), biases
    and vectors N(0, 0.05) (so zero-init projections contribute),
    BatchNorm variances in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(a.shape)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        if len(shape) <= 1:
            return (0.05 * rng.randn(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def jitted(module, method=None, **static):
    """``module.apply`` under ``jax.jit`` with the variables dict first."""
    def run(variables, *args):
        return module.apply(variables, *args, method=method, **static)
    return jax.jit(run)


def t(a, dtype=torch.float32) -> torch.Tensor:
    """numpy / JAX array -> torch tensor (float32 unless ``dtype``)."""
    return torch.from_numpy(np.array(a)).to(dtype)


def loaded(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    """``module`` with ``state`` loaded strictly, in eval mode."""
    module.load_state_dict(state, strict=True)
    return module.eval()


def flat_tree(tree, prefix=""):
    """A nested dict of arrays as {dotted path: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out
