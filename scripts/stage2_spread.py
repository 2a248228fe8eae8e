"""The spread of stage 2's bf16 gradient errors on the card against the
plain bf16 CPU control's, over weight seeds, for the published
HumanML3D configuration and for each ablation switch of ``chip_smoke.py``
(``ABLATIONS``).  Needs an NVIDIA GPU and the port's kernels (built at
first use):

    python3 scripts/stage2_spread.py [--seeds 82,83,84,182]

For each switch and seed, at batch 4 with lengths 16 / 60 / 123 / 196 and
the draws handed in: the encode's latents (card and control against the
float32 CPU), then ``chip_smoke._held_to_control`` without holding the
gradients: the median and the largest of the card's error over the
control's across the denoiser's gradient tensors.  One line a pass,
starting ``# spread``; imports no JAX."""
import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="82,83,84,182")
    seeds = [int(s) for s in ap.parse_args().seeds.split(",")]
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# gpu {cs.phase_build()}", flush=True)
    cs.ABLATIONS["published"] = {}
    B = 4
    lengths = torch.tensor([16, 60, 123, 196])
    for name in cs.ABLATIONS:
        for seed in seeds:
            t0 = time.perf_counter()
            g = torch.Generator().manual_seed(seed + 1000)
            uncond = 0.1 * torch.randn(B, 1, 768, generator=g)
            batch = {"motion": torch.randn(B, 196, 263, generator=g),
                     "length": lengths,
                     "text_emb": torch.randn(B, 1, 768, generator=g)}
            cpu = cs._ablation_system(name, "cpu", torch.float32, seed=seed)
            state = cpu.state_dict()
            ctl = cs._ablation_system(name, "cpu", torch.bfloat16,
                                      torch.float32, state)
            gpu = cs._ablation_system(name, dev, None, torch.float32, state)
            n = cpu.n_latents
            n_eps = 7 if cpu.vae.mlp_dist else n
            draws = {"eps": torch.randn(B, n_eps, 256, generator=g),
                     "noise": torch.randn(B, n, 256, generator=g),
                     "timesteps": torch.randint(0, 1000, (B,), generator=g),
                     "cond_drop": torch.tensor([False, True, False,
                                                False]).reshape(B, 1, 1)}
            zs = {}
            with torch.no_grad():
                for who, s in (("cpu", cpu), ("ctl", ctl), ("gpu", gpu)):
                    d = s.device
                    zs[who] = s.vae.encode(
                        batch["motion"].to(d), lengths.to(d),
                        eps=draws["eps"].to(d))[0].float().cpu()
            run2 = lambda s: cs._loss_grads(s, lambda: s.diffusion_forward(
                batch, uncond[:1], train=True, **draws))
            with torch.enable_grad():
                rec = cs._held_to_control(f"spread {name} {seed}", run2, cpu,
                                          ctl, gpu, hold_grads=False)
            c = rec["card"]
            print("# spread", name, seed,
                  "z_err card %.3g ctl %.3g" % (
                      cs.relerr(zs["gpu"], zs["cpu"]),
                      cs.relerr(zs["ctl"], zs["cpu"])),
                  "median ratio %.3f" % c["ratio_to_control_median"],
                  "top", [[a, round(b, 3)]
                          for a, b in c["ratio_to_control_top"]],
                  "card worst %.3g ctl worst %.3g" % (
                      c["worst_grad_rel_err"],
                      rec["cpu_bf16_plain"]["worst_grad_rel_err"]),
                  "s %.1f" % (time.perf_counter() - t0), flush=True)
            del cpu, ctl, gpu


if __name__ == "__main__":
    main()
