"""Text-to-motion demo of the port (counterpart of the repository's
``demo.py``):

    python -m ladiff_torch.demo --cfg configs/config_ladiff_humanml3d.yaml \
        [--example prompts.txt] [--task text_motion|random_latent|
        reconstruction] [--latentwise_gen fw|bw] [--plot_att_map]
        [--replication N] [--allinone] [--out_dir DIR] [--cpu]

Reads ``length text`` lines from the example file (or takes
``DEFAULT_EXAMPLES``) and makes one motion per line from the newest
checkpoint under ``TEST.CHECKPOINTS`` (random weights, with a warning,
when there is none); writes per sample ``sample_NNN.npy`` (joints [length,
J, 3]) and ``sample_NNN.txt`` (the caption) to ``--out_dir`` or
``<experiment>/samples``; replication r > 0 adds a ``_rep{r}`` suffix, and
``--allinone`` also writes all replications as one ``<task>_all.npy``
[samples, replications, frames, J, 3].

Tasks: ``text_motion`` generates from the captions (CFG sampling, token by
token where the configuration sets ``ARDIFF``, then the LA-VAE's decode;
with ``VAE_TYPE`` "no" the sampled frames are the features);
``random_latent`` decodes z ~ N(0, I) from the demo's generator, inactive
latent rows zeroed per length; ``reconstruction`` encodes the
features in the ``.npy`` beside the example's ``.txt`` (one clip
[frames, nfeats]) and decodes them.  ``--latentwise_gen fw|bw`` decodes
each sample MAX_IT times, keeping latent rows 0..i (fw) or the last i + 1
(bw) at repeat i, so a reader sees what each latent token adds;
``--plot_att_map`` writes each decoder layer's cross-attention weights of
the first sample as ``att_maps/block_{i}.png`` under the experiment
directory, first replication only (matplotlib, imported there only).  The
two flags need a VAE.  Runs on the GPU in the configuration's compute
type (float32 as published: the float32 K1, K2, kernels 5 and 10;
``TRAIN.MIXED_PRECISION`` bf16); ``--cpu`` runs the plain PyTorch paths.
"""
from __future__ import annotations

import os
import sys
import time
from os.path import join as pjoin
from typing import List, Optional

import numpy as np
import torch

from ladiff_torch.utils.masks import latent_valid_mask

TASKS = ("text_motion", "random_latent", "reconstruction")
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
    latentwise = cfg.DEMO.get("LATENTWISE_GEN")
    if task not in TASKS:
        raise ValueError(f"--task {task}: one of {TASKS}")
    if latentwise not in (None, "fw", "bw"):
        raise ValueError(f"--latentwise_gen {latentwise}: fw or bw")
    reps = int(cfg.DEMO.get("REPLICATION", 1) or 1)
    outall = bool(cfg.DEMO.get("OUTALL", False))
    if latentwise and (reps > 1 or outall):
        raise SystemExit("--latentwise_gen is incompatible with "
                         "--replication/--allinone (same as the reference)")
    device = resolve_device(device)
    logger = create_logger(cfg, phase="demo")
    dm = get_datasets(cfg, phase="test")[0]
    seed = int(cfg.get("SEED_VALUE", 1234))
    # the configuration's compute type, as ``build_system`` reads it: the
    # published float32 (the float32 kernels on the card) unless
    # ``TRAIN.MIXED_PRECISION`` asks for bf16
    mixed = bool(cfg.TRAIN.get("MIXED_PRECISION", False))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        system = LADiffSystem.from_cfg(
            cfg, nfeats=dm.nfeats, njoints=dm.njoints, mean=dm.mean,
            std=dm.std, device=device,
            dtype=torch.bfloat16 if mixed else torch.float32)
    if system.vae is None and (task != "text_motion" or latentwise
                               or cfg.DEMO.get("PLOT_ATT_MAP")):
        raise NotImplementedError(
            f"--task {task}, --latentwise_gen and --plot_att_map decode "
            f"latents: VAE_TYPE {system.vae_type!r} has no VAE")
    check_latent_tasks(system, task, latentwise)

    example = cfg.DEMO.get("EXAMPLE")
    if task == "reconstruction" and not example:
        raise ValueError("--task reconstruction reads the .npy beside "
                         "--example's .txt")
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

    cond = uncond = None
    if task == "text_motion":
        embedder = CaptionEmbedder(text_encoder
                                   or build_text_encoder(cfg, device))
        cond = embedder(texts)
        uncond = embedder.uncond.expand_as(cond)
    rep_joints, rep_lengths = [], []
    t0 = time.time()
    for rep in range(reps):
        gen = torch.Generator(device=device).manual_seed(seed + rep)
        joints, out_texts, out_lengths = _generate_once(
            cfg, system, gen, cond, uncond, texts, lengths, task,
            latentwise, logger, plot_att_allowed=rep == 0)
        rep_joints.append(joints)
        rep_lengths.append(out_lengths)
    dt = time.time() - t0
    logger.info(f"generated {len(texts) * reps} motions in {dt:.2f}s "
                f"({reps * int(lengths.sum()) / dt:.1f} fps overall)")

    out_dir = cfg.DEMO.get("OUT_DIR") or pjoin(cfg.get("FOLDER_EXP", "."),
                                               "samples")
    os.makedirs(out_dir, exist_ok=True)
    for rep, (joints, rep_len) in enumerate(zip(rep_joints, rep_lengths)):
        suffix = f"_rep{rep}" if rep else ""
        for i, text in enumerate(out_texts):
            np.save(pjoin(out_dir, f"sample_{i:03d}{suffix}.npy"),
                    joints[i, :int(rep_len[i])])
            with open(pjoin(out_dir, f"sample_{i:03d}{suffix}.txt"),
                      "w") as f:
                f.write(text + "\n")
    if outall:
        # [samples, replications, frames <= the longest, J, 3], with the
        # lengths beside it so a reader can trim each sample
        lengths = rep_lengths[0]
        combined = np.stack(rep_joints, axis=1)[:, :, :int(lengths.max())]
        np.save(pjoin(out_dir, f"{task}_all.npy"), combined)
        np.save(pjoin(out_dir, f"{task}_all_lengths.npy"), lengths.numpy())
        with open(pjoin(out_dir, f"{task}_all.txt"), "w") as f:
            for _ in range(reps):
                for text in out_texts:
                    f.write(text + "\n")
    logger.info(f"saved {len(out_texts) * reps} samples to {out_dir}")
    return out_dir


def check_latent_tasks(system, task: str, latentwise) -> None:
    """``random_latent`` and ``--latentwise_gen`` are ``max_it`` latents
    wide (the root demo.py's): with ``MAX_IT`` 0 (the fixed-size latent
    set) they have no latent position, and the JAX package no working
    path, so they raise."""
    if (task == "random_latent" or latentwise) and not system.max_it:
        raise ValueError(
            f"--task {task} / --latentwise_gen {latentwise}: with MAX_IT 0 "
            "there are no latent positions")


def latentwise_mask(lengths, n_samples: int, max_it: int,
                    frame_per_latent: int, mode: str):
    """[n_samples * max_it, max_it] bool: repeat i of a sample keeps latent
    rows 0..i ("fw") or max_it - 1 - i.. ("bw"), and only its active rows
    (``lengths`` already repeated)."""
    keep = torch.arange(max_it, device=lengths.device)[None, :]
    step = keep.T.repeat(n_samples, 1)
    mask = keep <= step if mode == "fw" else keep >= max_it - 1 - step
    return mask & latent_valid_mask(lengths, frame_per_latent, max_it)


@torch.no_grad()
def _generate_once(cfg, system, generator, cond, uncond, texts, lengths,
                   task, latentwise, logger, plot_att_allowed=True):
    """One replication of ``task``: joints [samples, max_frames, J, 3] (a
    numpy array), the captions and the lengths [samples] of what it made
    (``reconstruction`` makes one sample, ``latentwise`` max_it of each).
    Without a graph: the inference routes."""
    dev = system.device
    lengths = lengths.to(dev)
    if task == "text_motion" and system.vae is None:
        feats, _ = system.generate(cond, uncond, lengths, generator=generator)
        return system.feats2joints(feats).cpu().numpy(), texts, lengths.cpu()
    if task == "random_latent":
        # z ~ N(0, I), inactive rows zeroed (the reference's
        # "random_sampling" task)
        z = torch.randn((len(texts), system.max_it, system.latent_dim[-1]),
                        generator=generator, device=dev)
        z = torch.where(latent_valid_mask(lengths, system.frame_per_latent,
                                          system.max_it)[:, :, None], z,
                        torch.zeros((), device=dev))
    elif task == "reconstruction":
        # the clip beside the example's captions (the reference's
        # recon_from_motion), encoded in eval mode
        motion = str(cfg.DEMO.get("EXAMPLE", "")).replace(".txt", ".npy")
        feats_in = torch.from_numpy(np.load(motion)).float()[None].to(dev)
        lengths = torch.tensor([feats_in.shape[1]], device=dev)
        texts = ["reconstruction"]
        z, _, _, _ = system.vae.encode(feats_in, lengths, generator=generator)
    else:
        reverse = (system.diffusion_reverse_ar if system.ardiff
                   else system.diffusion_reverse)
        z = reverse(cond, uncond, lengths, generator=generator)
    if latentwise:
        n, M = z.shape[0], system.max_it
        z = z.repeat_interleave(M, dim=0)
        lengths = lengths.repeat_interleave(M)
        texts = [t for t in texts for _ in range(M)]
        mask = latentwise_mask(lengths, n, M, system.frame_per_latent,
                               latentwise)
        z = torch.where(mask[:, :, None], z, torch.zeros((), device=dev))
    plot_att = bool(cfg.DEMO.get("PLOT_ATT_MAP", False)) and plot_att_allowed
    feats = system.vae.decode(z.to(system.dtype), lengths, system.max_frames,
                              return_cross_weights=plot_att)
    if plot_att:
        feats, weights = feats
        _plot_attention(weights, pjoin(cfg.get("FOLDER_EXP", "."),
                                       "att_maps"), logger)
    return system.feats2joints(feats).cpu().numpy(), texts, lengths.cpu()


def _plot_attention(weights, att_dir: str, logger) -> None:
    """Each decoder layer's cross-attention weights of the first sample
    (frames x latents) as ``block_{i}.png`` in ``att_dir`` (the reference
    dumps these per layer, cross_attention.py:378-407)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(att_dir, exist_ok=True)
    for i, w in enumerate(weights):
        fig, ax = plt.subplots(figsize=(3, 6))
        ax.imshow(w[0].float().cpu().numpy(), aspect="auto", cmap="viridis")
        ax.set_xlabel("latents")
        ax.set_ylabel("frames")
        fig.savefig(pjoin(att_dir, f"block_{i}.png"), bbox_inches="tight",
                    dpi=120)
        plt.close(fig)
    logger.info(f"saved {len(weights)} attention maps to {att_dir}")


if __name__ == "__main__":
    main()
