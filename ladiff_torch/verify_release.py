"""Release-verification gate of the port (counterpart of
``scripts/verify_release.py``): populated deps/ -> benchmark -> paper
deltas, as one command.

    python -m ladiff_torch.verify_release --ckpt deps/ladiff_humanml3d.ckpt \\
        --expected scripts/paper_humanml3d.json
    python -m ladiff_torch.verify_release \\
        --cfg configs/config_ladiff_kit.yaml --ckpt deps/ladiff_kit.ckpt \\
        --expected scripts/paper_kit.json
    python -m ladiff_torch.verify_release --dry-run [--tiny] [--cpu]

Steps: audit the deps/ and datasets/ layout (prepare/*.sh fills it); load
the released Lightning checkpoint's ``state_dict`` (its ``vae.*`` and
``denoiser.*`` entries, which carry the port's names) into the system;
run the benchmark (``ladiff_torch.test.run_test``, the reference protocol:
``REPLICATION_TIMES`` passes, mean ± 1.96 σ / √n); print each metric with
its interval and, with ``--expected`` (a JSON table of the paper's numbers;
``"_"``-prefixed keys are provenance and skipped), its relative delta and
PASS / FAIL on |ΔFID| <= ``--fid-tolerance``.

``--dry-run`` runs the same pipeline on 400 synthetic clips with random
weights for one replication (no assets needed), so the gate itself is
testable; ``--tiny`` with it shrinks the model and the protocol to seconds.
Runs on the GPU; ``--cpu`` runs the plain PyTorch paths.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, any-of paths, providing script) — shared + per-dataset tables;
# the KIT evaluator release ships under Comp_v6_KLD005 (reference
# get_data.py:28-32)
DEPS_COMMON = [
    ("CLIP ViT-L/14 text tower",
     ["deps/clip-vit-large-patch14/model.safetensors",
      "deps/clip-vit-large-patch14/pytorch_model.bin"],
     "prepare/prepare_clip.sh"),
    ("GloVe word vectors", ["deps/glove/our_vab_data.npy"],
     "see prepare/README.md (HumanML3D release)"),
]
DEPS_BY_DATASET = {
    "humanml3d": [
        ("T2M evaluators", ["deps/t2m/t2m/text_mot_match/model/finest.tar"],
         "prepare/download_t2m_evaluators.sh"),
        ("evaluator norm stats",
         ["deps/t2m/t2m/Comp_v6_KLD01/meta/mean.npy"],
         "prepare/download_t2m_evaluators.sh"),
        ("HumanML3D dataset", ["datasets/humanml3d/Mean.npy"],
         "see prepare/README.md (EricGuo5513/HumanML3D pipeline)"),
    ],
    "kit": [
        ("KIT evaluators", ["deps/t2m/kit/text_mot_match/model/finest.tar"],
         "prepare/download_t2m_evaluators.sh"),
        ("evaluator norm stats",
         ["deps/t2m/kit/Comp_v6_KLD005/meta/mean.npy"],
         "prepare/download_t2m_evaluators.sh"),
        ("KIT-ML dataset", ["datasets/kit-ml/Mean.npy"],
         "see prepare/README.md (KIT-ML release)"),
    ],
}


def audit_deps(root: str, dataset: str = "humanml3d"):
    """Returns ([present labels], [(label, hint, expected_path) missing])."""
    present, missing = [], []
    table = DEPS_COMMON + DEPS_BY_DATASET.get(dataset,
                                              DEPS_BY_DATASET["humanml3d"])
    for label, paths, hint in table:
        if any(os.path.exists(os.path.join(root, p)) for p in paths):
            present.append(label)
        else:
            missing.append((label, hint, paths[0]))
    return present, missing


def release_state_dict(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """The ``vae.*`` and ``denoiser.*`` entries of a released stage-2
    checkpoint: the port's system keys, loadable with ``strict=True``."""
    from ladiff_torch.utils.checkpoint import load_checkpoint
    _, sd = load_checkpoint(ckpt_path)
    return {k: v for k, v in sd.items()
            if k.startswith(("vae.", "denoiser."))}


def compare(summary, expected, fid_tolerance):
    """Rows of (metric, got, conf, want, rel_delta); overall pass bool.

    Keys starting with "_" are provenance metadata (see the committed
    scripts/paper_*.json), not metrics — skipped."""
    rows, ok = [], True
    for key, want in sorted(expected.items()):
        if key.startswith("_"):
            continue
        if key not in summary:
            rows.append((key, None, None, want, None))
            ok = False
            continue
        got, conf = summary[key]
        rel = (got - want) / abs(want) if want else float("inf")
        rows.append((key, got, conf, want, rel))
        if key == "FID" and abs(rel) > fid_tolerance:
            ok = False
    return rows, ok


def main(argv: Optional[List[str]] = None, text_encoder=None) -> int:
    """Parses the command line (``argv``, default ``sys.argv[1:]``) and runs
    the gate; returns the exit code (0 pass or no table, 1 fail).
    ``text_encoder`` replaces the CLIP text tower."""
    ap = argparse.ArgumentParser(
        description="verify the released checkpoint against the paper table")
    ap.add_argument("--cfg", default=os.path.join(
        REPO, "configs", "config_ladiff_humanml3d.yaml"))
    ap.add_argument("--cfg_assets",
                    default=os.path.join(REPO, "configs", "assets.yaml"))
    ap.add_argument("--ckpt", default=None,
                    help="released stage-2 checkpoint (.ckpt)")
    ap.add_argument("--expected", default=None,
                    help="JSON file of paper metric values to diff against")
    ap.add_argument("--fid-tolerance", type=float, default=0.02,
                    help="relative |ΔFID| gate (north star: 2%%)")
    ap.add_argument("--replication", type=int, default=None,
                    help="override TEST.REPLICATION_TIMES (reference: 20)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override num_inference_timesteps (report at 50)")
    ap.add_argument("--dry-run", action="store_true",
                    help="synthetic data + random weights, 1 replication")
    ap.add_argument("--folder", default=None,
                    help="experiment output folder override (FOLDER)")
    ap.add_argument("--tiny", action="store_true",
                    help="with --dry-run: shrink the model/protocol so the "
                         "gate's plumbing runs in seconds")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch paths)")
    args = ap.parse_args(argv)
    if args.tiny and not args.dry_run:
        # --tiny overrides the architecture: real released weights would
        # not load into it
        ap.error("--tiny is a --dry-run companion (it overrides the model "
                 "architecture); combine it with --dry-run or drop it")
    device = "cpu" if args.cpu else None

    if args.dry_run:
        os.environ["LADIFF_SYNTHETIC_DATA"] = "1"
        # more than 32 test sequences (the R-precision group), so the T2M
        # metrics, FID included, compute as in the real gate
        os.environ.setdefault("LADIFF_SYNTHETIC_CLIPS", "400")

    from ladiff_torch.config import assemble_config
    from ladiff_torch.test import run_test
    from ladiff_torch.utils.logger import create_logger
    overrides: dict = {"DEBUG": False}
    if args.folder:
        overrides["FOLDER"] = args.folder
    if args.dry_run:
        overrides["TEST"] = {"REPLICATION_TIMES": 1}
        overrides["NAME"] = "verify_release_dryrun"
    if args.tiny:
        overrides["TEST"] = {**overrides.get("TEST", {}), "BATCH_SIZE": 8,
                             "MM_NUM_SAMPLES": 2, "MM_NUM_REPEATS": 12,
                             "MM_NUM_TIMES": 4, "DIVERSITY_TIMES": 5}
        layers = {"params": {"num_layers": 3}}
        overrides["model"] = {"num_layers": 3, "ff_size": 64,
                              "latent_dim": [7, 32], "motion_vae": layers,
                              "denoiser": layers,
                              "scheduler": {"num_inference_timesteps": 3}}
    if args.replication is not None:
        overrides.setdefault("TEST", {})["REPLICATION_TIMES"] = \
            args.replication
    if args.steps is not None:
        overrides.setdefault("model", {}).setdefault(
            "scheduler", {})["num_inference_timesteps"] = args.steps
    cfg = assemble_config(args.cfg, args.cfg_assets, overrides=overrides)
    logger = create_logger(cfg, phase="test")

    dataset = (list(cfg.TEST.DATASETS) or ["humanml3d"])[0]
    present, missing = audit_deps(os.getcwd(), dataset)
    for label in present:
        print(f"  [ok]      {label}")
    for label, hint, path in missing:
        print(f"  [MISSING] {label} (expected {path})  ->  {hint}")
    if missing and not args.dry_run:
        print("note: missing assets fall back to deterministic stand-ins; "
              "numbers below are then self-consistent, NOT paper-comparable")

    state_dict = None
    if args.ckpt:
        state_dict = release_state_dict(args.ckpt)
        print(f"loaded {args.ckpt}")
    elif args.dry_run:
        from ladiff_torch.data.datamodule import get_datasets
        from ladiff_torch.training.loop import build_system
        dm = get_datasets(cfg, phase="test")[0]
        state_dict = build_system(cfg, dm, device="cpu").state_dict()
    else:
        print("no --ckpt given: falling back to TEST.CHECKPOINTS "
              f"({cfg.TEST.CHECKPOINTS})")

    summary = run_test(cfg, logger, text_encoder=text_encoder,
                       state_dict=state_dict, device=device)

    print("\n==== benchmark ====")
    for k, (m, c) in sorted(summary.items()):
        print(f"{k:>24s}: {m:.4f} ± {c:.4f}")
    if not args.expected:
        return 0
    with open(args.expected) as f:
        expected = json.load(f)
    rows, ok = compare(summary, expected, args.fid_tolerance)
    print("\n==== vs expected ====")
    for key, got, conf, want, rel in rows:
        if got is None:
            print(f"{key:>24s}: MISSING (expected {want})")
        else:
            print(f"{key:>24s}: {got:.4f} vs {want:.4f} ({rel:+.2%})")
    print(f"\nFID gate (|Δ| <= {args.fid_tolerance:.0%}): "
          + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
