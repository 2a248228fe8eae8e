"""LADiff in PyTorch for NVIDIA Hopper (H100).

A port of ``ladiff_tpu`` (JAX) that keeps its module layout and names.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package is a
CUDA C++ kernel under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at
first use (see ``ops/cuda_common.py``).  ``python -m ladiff_torch.train``
and ``python -m ladiff_torch.demo`` are the entry points.  Entry points run on the GPU unless
the caller passes ``device="cpu"``; on a CPU tensor every kernel wrapper uses
its plain PyTorch version.
"""
