"""Experiment logging (the port's copy of ``ladiff_tpu/utils/logger.py``).

The reference LADiff's logger (``utils/logger.py:9-71``: file + console
logger, experiment dir ``experiments/<model>/<NAME>``, per-run config
snapshot) and its ProgressLogger epoch lines (``callback/progress.py:30-54``).
TensorBoard and WandB are optional sinks, used when importable (WandB runs
offline unless the configuration says otherwise).
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from os.path import join as pjoin
from typing import Dict, Optional

import yaml

__all__ = ["create_logger", "MetricsLogger", "resume_wandb_run_id",
           "apply_resume"]


def resume_wandb_run_id(resume_dir: str) -> Optional[str]:
    """Scan ``<resume_dir>/wandb`` for the newest ``run-*`` entry and return
    its run id, so a resumed training continues the same logical WandB run
    (reference src/train.py:44-50)."""
    wdir = pjoin(resume_dir, "wandb")
    if not os.path.isdir(wdir):
        return None
    for item in sorted(os.listdir(wdir), reverse=True):
        if "run-" in item:
            return item.split("-")[-1]
    return None


def apply_resume(cfg):
    """Reference resume semantics (src/train.py:26-53): when TRAIN.RESUME
    names a previous experiment dir, reload that run's config snapshot
    (keeping the current TRAIN section), point TRAIN.PRETRAINED at its
    newest checkpoint, and recover the WandB run id for continuity.
    Returns cfg (possibly replaced)."""
    resume = str(cfg.TRAIN.get("RESUME", "") or "")
    if not resume:
        return cfg
    if not os.path.exists(resume):
        raise ValueError(f"Resume path is not right: {resume}")
    from ladiff_torch.config import load_yaml, merge

    backcfg = cfg.TRAIN
    for item in sorted(os.listdir(resume), reverse=True):
        if item.endswith(".yaml"):
            cfg = merge(cfg, load_yaml(pjoin(resume, item)))
            cfg.TRAIN = backcfg
            break
    ckpt_dir = pjoin(resume, "checkpoints")
    if os.path.isdir(ckpt_dir):
        cfg.TRAIN.RESUME = ckpt_dir  # the loop restores the newest ckpt here
    run_id = resume_wandb_run_id(resume)
    if run_id:
        if "LOGGER" not in cfg:
            cfg["LOGGER"] = {}
        if "WANDB" not in cfg["LOGGER"]:
            cfg["LOGGER"]["WANDB"] = {}
        cfg["LOGGER"]["WANDB"]["RESUME_ID"] = run_id
    return cfg


def create_logger(cfg, phase: str = "train") -> logging.Logger:
    model_name = str(cfg.model.get("model_type", "ladiff"))
    name = str(cfg.get("NAME", "exp"))
    root = pjoin(str(cfg.get("FOLDER", "experiments")), model_name, name)
    os.makedirs(root, exist_ok=True)
    cfg["FOLDER_EXP"] = root

    # config snapshot (reference logger.py:37-71)
    stamp = time.strftime("%Y-%m-%dT%H-%M-%S")
    with open(pjoin(root, f"config_{phase}_{stamp}.yaml"), "w") as f:
        yaml.safe_dump(cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg),
                       f, sort_keys=False)

    logger = logging.getLogger(f"ladiff_torch.{name}.{phase}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    fh = logging.FileHandler(pjoin(root, f"{phase}_{stamp}.log"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricsLogger:
    """Scalar sink fan-out: jsonl always; TensorBoard and WandB when
    available/configured (reference src/train.py:64-83 builds the same
    logger list; WandB is optional-import — zero-egress images run with
    OFFLINE: true or without the package, falling back silently)."""

    def __init__(self, exp_dir: str, enable_tensorboard: bool = True,
                 wandb_project: Optional[str] = None,
                 wandb_offline: bool = True,
                 wandb_resume_id: Optional[str] = None,
                 run_name: Optional[str] = None,
                 wandb_module=None):
        self.exp_dir = exp_dir
        os.makedirs(exp_dir, exist_ok=True)
        self._jsonl = open(pjoin(exp_dir, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(pjoin(exp_dir, "tb"))
            except Exception:
                self._tb = None
        self._wandb = None
        if wandb_project:
            try:
                wandb = wandb_module
                if wandb is None:
                    import wandb  # type: ignore[no-redef]
                self._wandb = wandb.init(
                    project=str(wandb_project),
                    mode="offline" if wandb_offline else "online",
                    id=wandb_resume_id,
                    resume="must" if wandb_resume_id else None,
                    dir=exp_dir, name=run_name)
            except Exception:
                self._wandb = None

    @classmethod
    def from_cfg(cls, cfg, wandb_module=None) -> "MetricsLogger":
        lg = cfg.get("LOGGER", {}) or {}
        wb = lg.get("WANDB", {}) or {}
        return cls(str(cfg.get("FOLDER_EXP", ".")),
                   enable_tensorboard=bool(lg.get("TENSORBOARD", True)),
                   wandb_project=wb.get("PROJECT") or None,
                   wandb_offline=bool(wb.get("OFFLINE", True)),
                   wandb_resume_id=wb.get("RESUME_ID") or None,
                   run_name=str(cfg.get("NAME", "exp")),
                   wandb_module=wandb_module)

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = "") -> None:
        rec = {"step": step}
        for k, v in scalars.items():
            key = f"{prefix}{k}" if prefix else k
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if k != "step"},
                            step=step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
