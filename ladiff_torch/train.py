"""Training entry point of the port (counterpart of the repository's
``train.py``):

    python -m ladiff_torch.train --cfg configs/config_vae_humanml3d.yaml     # stage 1
    python -m ladiff_torch.train --cfg configs/config_ladiff_humanml3d.yaml  # stage 2

Runs on the GPU; ``--cpu`` runs the plain PyTorch paths on the CPU instead.
``TRAIN.MIXED_PRECISION: true`` computes in bf16 through the CUDA kernels;
the published configurations leave it false and train in float32, through
the plain PyTorch route on the GPU too.

Under ``torchrun`` it trains on every rank, data parallel by default, or in
the layout ``TRAIN.*`` names (``training/loop.py``):

    torchrun --standalone --nproc-per-node N -m ladiff_torch.train --cfg ...

each rank on ``cuda:LOCAL_RANK`` with NCCL, or with ``--cpu`` on the CPU
with gloo; rank 0 logs and writes the checkpoints.
``LADIFF_TRAIN_WHOLE_LAYER=1|enc|dec`` runs the VAE's training layers as
the whole-layer kernels 12 and 13; ``LADIFF_SYNTHETIC_DATA=1`` stands in a
synthetic dataset when the configured one is missing.
"""
from __future__ import annotations

import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None, device=None, text_encoder=None,
         max_epochs: Optional[int] = None,
         max_steps_per_epoch: Optional[int] = None,
         overrides: Optional[dict] = None) -> str:
    """Parses the command line (``argv``, default ``sys.argv[1:]``), trains
    the configured stage and returns the checkpoint directory.
    ``overrides`` are merged over the configuration files; the other
    keyword arguments are ``run_training``'s."""
    from ladiff_torch.config import parse_args
    import logging

    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.parallel.mesh import init_distributed, rank
    from ladiff_torch.training.loop import run_training
    from ladiff_torch.utils.logger import apply_resume, create_logger

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    # under torchrun: the process group and this rank's device
    device = init_distributed(device)
    cfg = parse_args("train", argv, overrides)
    # TRAIN.RESUME: that run's configuration snapshot and newest checkpoint
    cfg = apply_resume(cfg)
    logger = create_logger(cfg, phase="train")
    if rank() > 0:
        logger.setLevel(logging.WARNING)
    logger.info(f"experiment: {cfg.NAME} stage={cfg.TRAIN.STAGE}")
    dm = get_datasets(cfg, phase="train")[0]
    logger.info(f"dataset {dm.name}: nfeats={dm.nfeats} njoints={dm.njoints} "
                f"train={len(dm.dataset('train'))}")
    ckpt_dir = run_training(cfg, dm, logger, text_encoder=text_encoder,
                            max_epochs=max_epochs,
                            max_steps_per_epoch=max_steps_per_epoch,
                            device=device)
    logger.info(f"training done; checkpoints at {ckpt_dir}")
    return ckpt_dir


if __name__ == "__main__":
    main()
