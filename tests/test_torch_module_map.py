"""Every module of the JAX package has its counterpart in the port.

Walks ``ladiff_tpu/**/*.py`` as file paths (nothing is imported): each file
has a file of the same relative path under ``ladiff_torch/``, or an entry in
``COUNTERPARTS`` below, the same table as ROADMAP.md's module map.  A
kernel file's counterpart registers a kernel wrapper; an entry whose JAX
file is gone, or whose JAX file has a same-path counterpart after all, is
stale and fails too.
"""
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "ladiff_tpu")
PORT = os.path.join(REPO, "ladiff_torch")

# JAX file (relative to ladiff_tpu/) -> port file (relative to
# ladiff_torch/), or (None, why none is needed)
COUNTERPARTS = {
    "ops/pallas_attention.py": "ops/attention_kernel.py",
    "ops/pallas_clip_layer.py": "ops/clip_layer.py",
    "ops/pallas_decoder_layer.py": "ops/decoder_layer.py",
    "ops/pallas_fused_ffn.py": "ops/stylized_ffn.py",
    "ops/pallas_md_layer.py": "ops/md_layer.py",
    "ops/pallas_md_stack.py": "ops/md_stack.py",
    "ops/pallas_postnorm_ffn.py": "ops/postnorm_ffn.py",
    "ops/pallas_stylize.py": "ops/stylize.py",
    "ops/pallas_train_attention.py": "ops/train_attention.py",
    "ops/pallas_train_decoder_layer.py": "ops/train_decoder_layer.py",
    "ops/pallas_train_ffn.py": "ops/train_ffn.py",
    "ops/pallas_train_layer.py": "ops/train_layer.py",
    "ops/pallas_common.py": "ops/cuda_common.py",
    "ops/param_layers.py": (None, "DenseParams / LNParams are torch.nn's "
                                  "Linear / LayerNorm"),
    "utils/jax_cache.py": (None, "the XLA compile cache; the port's is the "
                                 "kernel build cache, build/kernels/, keyed "
                                 "by a hash of the sources "
                                 "(ops/cuda_common.py BUILD_DIR)"),
}


def _jax_files():
    out = []
    for root, _, files in os.walk(JAX_PKG):
        for name in files:
            if name.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, name),
                                           JAX_PKG).replace(os.sep, "/"))
    return sorted(out)


@pytest.mark.parametrize("rel", _jax_files())
def test_jax_module_has_a_counterpart(rel):
    if os.path.exists(os.path.join(PORT, rel)):
        assert rel not in COUNTERPARTS, f"stale entry: {rel} has a " \
                                        "same-path counterpart"
        return
    assert rel in COUNTERPARTS, f"ladiff_tpu/{rel} has no counterpart in " \
                                "ladiff_torch/ and no entry in the map"
    target = COUNTERPARTS[rel]
    if isinstance(target, tuple):
        assert target[0] is None and target[1]
        return
    path = os.path.join(PORT, target)
    assert os.path.exists(path), target
    if os.path.basename(rel).startswith("pallas_") and rel != \
            "ops/pallas_common.py":
        with open(path) as f:
            assert "@register_kernel(" in f.read(), target


def test_map_entries_name_existing_jax_files():
    files = set(_jax_files())
    assert set(COUNTERPARTS) <= files, sorted(set(COUNTERPARTS) - files)
    kernels = [r for r in files if os.path.basename(r).startswith("pallas_")
               and r != "ops/pallas_common.py"]
    assert len(kernels) == 12
