"""Text-to-motion demo of the port (counterpart of the repository's
``demo.py``):

    python -m ladiff_torch.demo --cfg configs/config_ladiff_humanml3d.yaml \
        [--example prompts.txt] [--replication N] [--allinone] [--cpu]

Reads ``length text`` lines from the example file (or takes
``DEFAULT_EXAMPLES``), generates each motion from the newest checkpoint
under ``TEST.CHECKPOINTS`` (random weights, with a warning, when there is
none) and writes per sample ``sample_NNN.npy`` (joints [length, J, 3]) and
``sample_NNN.txt`` (the caption) to ``--out_dir`` or
``<experiment>/samples``; replication r > 0 adds a ``_rep{r}`` suffix, and
``--allinone`` also writes all replications as one
``<task>_all.npy`` [samples, replications, frames, J, 3].  Runs on the GPU;
``--cpu`` runs the plain PyTorch paths.  The ``text_motion`` task only:
``--latentwise_gen``, ``--plot_att_map`` and the other tasks raise
(ROADMAP.md Queue 1).
"""
from __future__ import annotations

import os
import sys
import time
from os.path import join as pjoin
from typing import List, Optional

DEFAULT_EXAMPLES = [
    (196, "a person walks forward and then turns around"),
    (120, "someone jumps twice and raises both arms"),
    (64, "a person sits down on a chair"),
]


def load_example_file(path):
    """`length text` per line (reference utils/demo_utils.py:6-21)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            length, text = line.split(" ", 1)
            out.append((int(length), text))
    return out


def main(argv: Optional[List[str]] = None, device=None, text_encoder=None,
         overrides: Optional[dict] = None) -> str:
    """Parses the command line (``argv``, default ``sys.argv[1:]``),
    generates and writes the samples; returns the output directory.
    ``overrides`` are merged over the configuration files; ``text_encoder``
    replaces the CLIP text tower."""
    import numpy as np
    import torch

    from ladiff_torch.config import parse_args
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.training.loop import (CaptionEmbedder,
                                           build_text_encoder)
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint)
    from ladiff_torch.utils.device import resolve_device
    from ladiff_torch.utils.logger import create_logger

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    cfg = parse_args("demo", argv, overrides)
    task = str(cfg.DEMO.get("TASK", "text_motion"))
    for key, on in (("--latentwise_gen", cfg.DEMO.get("LATENTWISE_GEN")),
                    ("--plot_att_map", cfg.DEMO.get("PLOT_ATT_MAP")),
                    (f"--task {task}", task != "text_motion")):
        if on:
            raise NotImplementedError(
                f"{key} is not ported to ladiff_torch yet (ROADMAP.md "
                "Queue 1: the demo's other options)")
    device = resolve_device(device)
    logger = create_logger(cfg, phase="demo")
    dm = get_datasets(cfg, phase="test")[0]
    seed = int(cfg.get("SEED_VALUE", 1234))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        system = LADiffSystem.from_cfg(cfg, nfeats=dm.nfeats,
                                       njoints=dm.njoints, mean=dm.mean,
                                       std=dm.std, device=device)

    example = cfg.DEMO.get("EXAMPLE")
    pairs = load_example_file(example) if example else DEFAULT_EXAMPLES
    lengths = torch.tensor([min(n, system.max_frames) for n, _ in pairs])
    texts = [t for _, t in pairs]

    ckpt_src = str(cfg.TEST.CHECKPOINTS)
    found = latest_checkpoint(ckpt_src)
    if found is not None:
        epoch, sd = load_checkpoint(found[1])
        system.load_state_dict(sd, strict=True)
        logger.info(f"loaded checkpoint epoch {epoch} from {found[1]}")
    else:
        logger.warning(f"no checkpoint under {ckpt_src}; using random init")

    embedder = CaptionEmbedder(text_encoder or build_text_encoder(cfg, device))
    cond = embedder(texts)
    uncond = embedder.uncond.expand_as(cond)
    reps = int(cfg.DEMO.get("REPLICATION", 1) or 1)
    outall = bool(cfg.DEMO.get("OUTALL", False))
    rep_joints = []
    t0 = time.time()
    for rep in range(reps):
        gen = torch.Generator(device=device).manual_seed(seed + rep)
        feats, _ = system.generate(cond, uncond, lengths, generator=gen)
        rep_joints.append(system.feats2joints(feats).cpu().numpy())
    dt = time.time() - t0
    logger.info(f"generated {len(texts) * reps} motions in {dt:.2f}s "
                f"({reps * int(lengths.sum()) / dt:.1f} fps overall)")

    out_dir = cfg.DEMO.get("OUT_DIR") or pjoin(cfg.get("FOLDER_EXP", "."),
                                               "samples")
    os.makedirs(out_dir, exist_ok=True)
    for rep, joints in enumerate(rep_joints):
        suffix = f"_rep{rep}" if rep else ""
        for i, text in enumerate(texts):
            np.save(pjoin(out_dir, f"sample_{i:03d}{suffix}.npy"),
                    joints[i, :int(lengths[i])])
            with open(pjoin(out_dir, f"sample_{i:03d}{suffix}.txt"),
                      "w") as f:
                f.write(text + "\n")
    if outall:
        # [samples, replications, frames <= the longest, J, 3], with the
        # lengths beside it so a reader can trim each sample
        combined = np.stack(rep_joints, axis=1)[:, :, :int(lengths.max())]
        np.save(pjoin(out_dir, f"{task}_all.npy"), combined)
        np.save(pjoin(out_dir, f"{task}_all_lengths.npy"), lengths.numpy())
        with open(pjoin(out_dir, f"{task}_all.txt"), "w") as f:
            for _ in range(reps):
                for text in texts:
                    f.write(text + "\n")
    logger.info(f"saved {len(texts) * reps} samples to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
