"""Kernel runtime shared by every hand-written CUDA kernel of the port
(counterpart of ``ladiff_tpu/ops/pallas_common.py``).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The build happens at first use, into
``build/kernels/`` at the repository root, keyed by a hash of the sources so
an edited kernel is rebuilt.  ``build_all`` starts one ``nvcc`` per source at
once.  Importing this module builds nothing: the CPU tests import every
module of the port on a machine without ``nvcc``.

Dispatch is by device only: a wrapper given CPU tensors runs the kernel's
plain PyTorch version; given CUDA tensors it launches the kernel or raises.
Which route a module takes is decided before any launch, from shapes (each
kernel's ``*_supported``) and from the compute type, per kernel
(``kernel_route(x, kernel)`` reads ``KERNEL_DTYPES``): K1, K2 and
kernels 5, 6, 7, 10 and 11 (the float32 routes of ``ops/f32_layer.py``)
and the training kernels 8, 9, 12 and 13, forward and backward (those of
``ops/f32_train.py``), take bf16 and float32; K3 and K4 take bf16 only,
so float32 compute on the card takes the plain route of CLIP; so does
every module inside a ``plain_routes()`` scope (the tensor-, sequence-
and pipeline-parallel layouts, where a kernel would see a shard of a layer:
the JAX package's ``no_pallas()``).
Every wrapper counts its launches (``launch_counts`` / ``reset_launch_counts``)
so a run can show that the main path went through the kernels.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["NEG_INF", "CSRC", "BUILD_DIR", "register_kernel", "launch_counts",
           "reset_launch_counts", "build_all", "library", "launch",
           "check_cuda_args", "require_no_grad", "draw_seed", "split_seed",
           "dropout_mask", "on_card", "kernel_compute", "kernel_route",
           "plain_routes", "KERNEL_DTYPES"]

NEG_INF = -1e9  # additive key mask; large finite keeps bf16 softmax safe

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("md_layer", "decoder_layer", "clip_layer", "postnorm_ffn",
           "train_ffn", "train_attention", "masked_attention", "md_stack",
           "stylized_ffn", "stylize", "train_layer", "train_decoder_layer",
           "f32_layer", "f32_train", "f32_train_layer")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_KERNELS: Dict[str, Callable] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def register_kernel(name: str):
    """Decorator: registers a kernel wrapper and gives it a launch count."""
    def deco(fn):
        fn.launches = 0
        _KERNELS[name] = fn
        return fn
    return deco


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (src.stem == name
                                              or src.suffix == ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    """Starts nvcc for one source; returns what ``_finish_build`` needs,
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    logf = open(log, "w")
    proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT)
    return proc, tmp, out, log, logf


def _finish_build(started) -> None:
    proc, tmp, out, log, logf = started
    rc = proc.wait()
    logf.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}) for {out.name}:\n"
                           + log.read_text()[-4000:])
    os.replace(tmp, out)


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Builds every kernel library in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    with _LOCK:
        started = [s for s in (_start_build(n) for n in names) if s]
        errors = []
        for s in started:  # wait for every nvcc before reporting a failure
            try:
                _finish_build(s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_logs() -> Dict[str, str]:
    """The compiler's output (registers, spills) of each built library."""
    return {n: _lib_path(n).with_suffix(".log").read_text()
            for n in SOURCES if _lib_path(n).with_suffix(".log").exists()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                lib.ladiff_error_string.argtypes = [ctypes.c_int]
                lib.ladiff_error_string.restype = ctypes.c_char_p
                _LIBS[name] = lib
    return lib


def launch(lib_name: str, fn_name: str, device: torch.device,
           ptrs: Sequence[int], ints: Sequence[int],
           floats: Sequence[float] = ()) -> None:
    """Calls ``int fn(const void** ptrs, const int* ints, const float*
    floats, void* stream)`` of a kernel library with ``device`` (the
    tensors' device) current, on PyTorch's current stream of that device,
    and raises on a non-zero ``cudaGetLastError()``."""
    lib = library(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    iarr = (ctypes.c_int * max(1, len(ints)))(*ints)
    farr = (ctypes.c_float * max(1, len(floats)))(*floats)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(parr, iarr, farr, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} "
                           f"({lib.ladiff_error_string(err).decode()})")


def on_card(device) -> bool:
    """Whether ``device`` is a CUDA device (where the kernels launch)."""
    return torch.device(device).type == "cuda"


# The compute types each kernel takes on the card, by wrapper name (a
# backward's registered name too: ``check_cuda_args`` reads the table by
# it): every kernel the JAX package runs in float32 takes float32 too, the
# inference K1, K2, 5, 6, 7, 10 and 11 and the training 8, 9, 12 and 13;
# K3 and K4, which the JAX package runs in 2-byte types only, are not named
# here and take bf16 only.
KERNEL_DTYPES: Dict[str, Tuple[torch.dtype, ...]] = {
    name: (torch.bfloat16, torch.float32)
    for name in ("fused_md_layer", "fused_decoder_layer",
                 "fused_postnorm_ffn", "fused_masked_attention",
                 "fused_stylized_ffn", "fused_broadcast_stylize",
                 "fused_md_stack", "train_self_attention",
                 "train_self_attention_bwd", "train_postnorm_ffn",
                 "train_postnorm_ffn_bwd", "train_encoder_layer",
                 "train_encoder_layer_bwd", "train_decoder_layer",
                 "train_decoder_layer_bwd")}


def kernel_dtypes(kernel: str) -> Tuple[torch.dtype, ...]:
    """The compute types ``kernel`` (a wrapper's name) takes on the card."""
    return KERNEL_DTYPES.get(kernel, (torch.bfloat16,))


def kernel_compute(dtype: torch.dtype, device, kernel: str) -> bool:
    """Whether compute in ``dtype`` on ``device`` may take ``kernel``'s
    route: a type the kernel takes (``KERNEL_DTYPES``), or any type off the
    card, where each wrapper is its kernel's plain version.  A type the
    kernel does not take sends the module to its plain route on the card;
    the wrapper itself raises on it (``check_cuda_args``)."""
    return dtype in kernel_dtypes(kernel) or not on_card(device)


_PLAIN = contextvars.ContextVar("ladiff_plain_routes", default=False)


@contextlib.contextmanager
def plain_routes():
    """Inside this scope every module takes its plain route: no kernel and
    no kernel wrapper is called (``kernel_route`` is false)."""
    tok = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(tok)


def plain_forward(module: torch.nn.Module) -> torch.nn.Module:
    """Every forward of ``module`` (its children's included) runs in a
    ``plain_routes()`` scope, entered and left by forward hooks: for a
    module whose weights no kernel can take whole, such as a layer with
    tensor-parallel shards.  The routes of the rest of the step are
    untouched.  Returns ``module``."""
    tokens = []

    def enter(mod, args):
        tokens.append(_PLAIN.set(True))

    def leave(mod, args, out):
        _PLAIN.reset(tokens.pop())

    module.register_forward_pre_hook(enter)
    module.register_forward_hook(leave, always_call=True)
    return module


def kernel_route(x: torch.Tensor, kernel: str) -> bool:
    """``kernel_compute`` of the activations ``x`` for ``kernel``: the dtype
    gate that every module checks beside its shape gate, before any launch;
    false throughout a ``plain_routes()`` scope."""
    return not _PLAIN.get() and kernel_compute(x.dtype, x.device, kernel)


def check_cuda_args(name: str, tensors: Dict[str, torch.Tensor],
                    f32: Sequence[str] = ()) -> None:
    """Device / dtype / contiguity / alignment checks before passing
    pointers to a kernel.  ``f32`` names the tensors that are float32
    whatever the compute type (masks, gradient outputs, workspaces); every
    other tensor has the compute type, the type of the first of them, which
    must be one that the kernel ``name`` takes (``KERNEL_DTYPES``)."""
    dev = compute = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, the other "
                             "inputs on a CUDA device")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        if key in f32:
            want = torch.float32
        elif compute is None:
            if t.dtype not in kernel_dtypes(name):
                raise TypeError(
                    f"{name}: the CUDA kernel takes "
                    f"{' or '.join(map(str, kernel_dtypes(name)))} for "
                    f"{key}, got {t.dtype}")
            want = compute = t.dtype
        else:
            want = compute
        if t.dtype != want:
            raise TypeError(f"{name}: the CUDA kernel takes {want} for "
                            f"{key}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{name}: {key} must be 32-byte aligned")


def require_no_grad(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """An inference kernel has no backward: raises when autograd is
    recording and an input or weight requires a gradient, instead of
    returning a result that is silently cut from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is an inference kernel without a backward; call it "
            "under torch.no_grad(), or use the training path "
            "(module.train()) where a gradient is required")


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One 64-bit dropout seed per kernel call from the caller's generator
    (the global CPU generator when None), without waiting for the device: a
    CUDA generator keeps its state (seed, Philox offset) on the host, so the
    seed is mixed from that state and the offset moved on by one draw."""
    if generator is None or generator.device.type != "cuda":
        return int(torch.randint(-2 ** 63, 2 ** 63 - 1, (1,),
                                 dtype=torch.int64, generator=generator))
    offset = generator.get_offset()
    generator.set_offset(offset + 4)  # Philox offsets move in fours
    mask = (1 << 64) - 1  # splitmix64 of (seed, offset)
    z = (generator.initial_seed() + 0x9E3779B97F4A7C15 * (offset + 1)) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


def split_seed(seed: int) -> Tuple[int, int]:
    """A 64-bit seed as the two signed 32-bit ints ``launch`` can carry."""
    def s32(v):
        return v - (1 << 32) if v >= (1 << 31) else v
    seed &= (1 << 64) - 1
    return s32(seed & 0xFFFFFFFF), s32(seed >> 32)


def dropout_mask(shape, rate: float, like: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """A keep-mask scaled by 1 / keep (0 or 1 / (1 - rate)) in ``like``'s
    type, drawn on ``like``'s device from ``generator``, which must live on
    that device (torch raises otherwise)."""
    keep = torch.rand(tuple(shape), generator=generator,
                      device=like.device) >= rate
    return keep.to(like.dtype) / (1.0 - rate)
