"""Why FSDP2 at world size 1 differs from the one-process step on the
card, at the published widths (``chip_smoke._parallel_system``: 9 + 9
layers, d 256, batch 4, lengths 16 / 60 / 123 / 196, dropout 0, bf16
unless named).  Needs an NVIDIA GPU and the port's kernels (built first):

    python3 scripts/fsdp_order.py

Each line compares two steps' gradients (``chip_smoke._grad_errs``): the
one-process stage-1 step (split route) against itself, against itself
while a side stream runs products, and with what ``torch.empty`` returns
filled with NaN (``torch.utils.deterministic.fill_uninitialized_memory``:
a kernel that read unwritten memory would change); FSDP2 and DDP at world
size 1 (NCCL) against it; FSDP2 against the one-process step carrying
FSDP2's identity autograd nodes (``parallel/fsdp.fsdp_autograd_graph``);
the same in float32 (no kernel) and for stage 2.  Imports no JAX."""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ladiff_torch.ops import cuda_common as cc  # noqa: E402
from ladiff_torch.parallel.mesh import make_mesh  # noqa: E402


def errs(a, b):
    """Step ``a``'s gradients against ``b``'s: the loss difference, the
    whole vector's norm-wise error, how many tensors differ at all, the
    eight largest per-tensor errors, and whether ``a`` holds a NaN."""
    e, flat = cs._grad_errs("fsdp_order", a[1], b[1])
    top = sorted(e.items(), key=lambda kv: -kv[1])[:8]
    return {"loss_diff": a[0] - b[0], "flat": flat,
            "n_nonzero": sum(1 for v in e.values() if v > 0), "n": len(e),
            "top": top,
            "nan": any(bool(torch.isnan(v).any()) for v in a[1].values())}


def main():
    t0 = time.perf_counter()
    print("build_s", cc.build_all(), flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}

    def single(stage, dtype=None, whole="0", graph=False):
        s = cs._parallel_system(dev, dtype, whole)
        return cs._single_process_step(
            s, stage, *cs._parallel_inputs(s, stage), fsdp_graph=graph)

    def layout(stage, name, mesh, dtype=None):
        s = cs._parallel_system(dev, dtype)
        return cs._layout_step(s, stage, name, *cs._parallel_inputs(s, stage),
                               mesh)

    a1 = single("vae")
    out["single_twice"] = errs(single("vae"), a1)
    side = torch.cuda.Stream()  # a side stream busy while the step runs
    big = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    with torch.cuda.stream(side):
        for _ in range(30):
            big @ big
    out["single_concurrent"] = errs(single("vae"), a1)
    torch.cuda.synchronize()
    del big
    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "s"), 1), rank=0,
        world_size=1)
    mesh = make_mesh(1, 1, device_type="cuda")
    f1 = layout("vae", "fsdp", mesh)
    out["fsdp_vs_single"] = errs(f1, a1)
    out["fsdp_vs_fsdp_graph"] = errs(f1, single("vae", graph=True))
    out["fsdp_twice"] = errs(layout("vae", "fsdp", mesh), f1)
    out["ddp_vs_single"] = errs(layout("vae", "dp", mesh), a1)
    # what torch.empty returns filled with NaN
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    out["single_filled"] = errs(single("vae"), a1)
    out["fsdp_filled_vs_single"] = errs(layout("vae", "fsdp", mesh), a1)
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = False
    f32 = layout("vae", "fsdp", mesh, torch.float32)
    out["fsdp_f32"] = errs(f32, single("vae", torch.float32))
    out["fsdp_f32_vs_fsdp_graph"] = errs(
        f32, single("vae", torch.float32, graph=True))
    fb = layout("diffusion", "fsdp", mesh)
    out["fsdp_diffusion"] = errs(fb, single("diffusion"))
    out["fsdp_diffusion_vs_fsdp_graph"] = errs(
        fb, single("diffusion", graph=True))
    dist.destroy_process_group()
    for k, v in out.items():
        print(k, json.dumps(v, default=str), flush=True)
    print("seconds", time.perf_counter() - t0)


if __name__ == "__main__":
    main()
