"""The training loop and the evaluation under a process group, on the CPU:
``run_training`` at 2 ranks under FSDP and under TP writing checkpoints
that load strictly at 1 rank and resume there, and at 4 ranks under a
3-stage pipeline; ``run_test`` at 2 ranks
against 1 rank (every metric within 1e-6 relative, float32: each rank's rows
are the 1-rank run's, the movement encoder cropped to the whole batch's
longest length); ``dryrun_multiprocess`` at 2 and 3 ranks.

Ranks are spawned (``tests/torch_parallel_ranks.py``): one spawn of 2 ranks
runs both trainings and the evaluation.
"""
import logging
import os

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_TOL = 1e-6
LAYOUTS = {"fsdp": {"FSDP": True}, "tp": {"TENSOR_PARALLEL": 2}}
CFG = os.path.join(REPO, "configs", "config_vae_humanml3d.yaml")
EVAL_CFG = os.path.join(REPO, "configs", "config_ladiff_humanml3d.yaml")
ASSETS = os.path.join(REPO, "configs", "assets.yaml")


def _train_overrides(root, name, **train):
    from test_torch_entry import _small_overrides
    return _small_overrides(
        root, NAME=name, TRAIN={"END_EPOCH": 1, "BATCH_SIZE": 4,
                                "PREFETCH": 0, **train},
        LOGGER={"SACE_CHECKPOINT_EPOCH": 1},
        model={"latent_dim": [7, 32], "ff_size": 64})


def _eval_overrides(root):
    layers = {"params": {"num_layers": 3}}
    return {"DEBUG": False, "FOLDER": str(root / "experiments"),
            "NAME": "eval", "DATASET": {"HUMANML3D": {"ROOT":
                                                      str(root / "data")}},
            "TEST": {"BATCH_SIZE": 8, "REPLICATION_TIMES": 1,
                     "MM_NUM_SAMPLES": 3, "MM_NUM_REPEATS": 4,
                     "MM_NUM_TIMES": 2},
            "METRIC": {"TYPE": ["TemosMetric", "TM2TMetrics", "MRMetrics",
                                "UncondMetrics"]},
            "model": {"num_layers": 3, "ff_size": 64, "num_head": 2,
                      "latent_dim": [7, 32], "motion_vae": layers,
                      "denoiser": layers, "t2m_path": str(root / "t2m"),
                      "scheduler": {"num_inference_timesteps": 3}},
            "LOGGER": {"TENSORBOARD": False}}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of 2 ranks: ``run_training`` (stage vae, 2 steps) under
    each layout, then ``run_test`` of a tiny stage-2 system on the
    synthetic dataset (400 clips, so that R-precision's 32-way groups fill);
    and ``run_test`` of the same weights at 1 rank, here."""
    from ladiff_torch.config import assemble_config
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.data.synthetic import generate_synthetic_dataset
    from ladiff_torch.test import run_test
    from ladiff_torch.training.loop import build_system
    root = tmp_path_factory.mktemp("loop")
    generate_synthetic_dataset(str(root / "data"), n_clips=400, seed=0)
    over = _eval_overrides(root)
    cfg = assemble_config(EVAL_CFG, ASSETS, over)
    cfg["FOLDER_EXP"] = str(root / "one")
    os.makedirs(cfg.FOLDER_EXP)
    os.makedirs(root / "two")
    dm = get_datasets(cfg, phase="test")[0]
    g = torch.Generator().manual_seed(7)
    state = {k: torch.randn(v.shape, generator=g) * 0.2 for k, v in
             build_system(cfg, dm, device="cpu").state_dict().items()}
    jobs = [(name, "run_training_job", {
        "cfg": CFG, "assets": ASSETS, "steps": 2,
        "overrides": _train_overrides(root, name, **layout)})
        for name, layout in LAYOUTS.items()]
    jobs.append(("eval", "eval_test", {"cfg": EVAL_CFG, "assets": ASSETS,
                                       "overrides": over,
                                       "folder": str(root / "two")}))
    got = ranks.spawn(2, jobs, {"eval": {"state": {
        k: v.numpy() for k, v in state.items()}}}, root / "ranks")
    logger = logging.getLogger("eval_one")
    logger.setLevel(logging.WARNING)
    one = run_test(cfg, logger, text_encoder=ranks.text_features,
                   state_dict=state, device="cpu")
    return root, got, one


# -- the loop and the checkpoints -------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_checkpoint_at_2_ranks_loads_and_resumes_at_1(two_ranks, layout):
    """``run_training`` at 2 ranks under the layout writes a checkpoint of
    the whole parameters: it loads strictly into a 1-rank system, and a
    1-rank ``run_training`` (no layout: TP 2 needs 2 ranks) resumes from it
    and writes the next epoch."""
    from ladiff_torch.config import assemble_config
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.training.loop import build_system, run_training
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint, subtree)
    from ladiff_torch.utils.logger import create_logger
    root, got, _ = two_ranks
    ckpt_dir = str(got[layout]["ckpt_dir"])
    epoch, path = latest_checkpoint(ckpt_dir)
    assert epoch == 1
    _, sd = load_checkpoint(path)
    cfg = assemble_config(CFG, ASSETS, _train_overrides(root, layout))
    logger = create_logger(cfg, phase="train")
    logger.setLevel(logging.WARNING)
    dm = get_datasets(cfg)[0]
    system = build_system(cfg, dm, device="cpu")
    system.vae.load_state_dict(subtree(sd, "vae."), strict=True)
    fresh = build_system(cfg, dm, device="cpu").vae.state_dict()
    moved = [k for k, v in subtree(sd, "vae.").items()
             if not torch.equal(v, fresh[k])]
    assert len(moved) > len(fresh) // 2
    resume = assemble_config(CFG, ASSETS, _train_overrides(
        root, layout, RESUME="yes", END_EPOCH=2))
    create_logger(resume, phase="train").setLevel(logging.WARNING)
    run_training(resume, dm, logger, text_encoder=ranks.text_features,
                 max_steps_per_epoch=2, device="cpu")
    assert latest_checkpoint(ckpt_dir)[0] == 2


def test_pipeline_run_training_on_3_of_4_ranks(tmp_path):
    """``run_training`` stage 2 with ``PIPELINE_STAGES`` 3 at 4 ranks: the
    fourth rank takes no part, the first three take 2 steps on 2
    microbatches and rank 0 writes a checkpoint that loads strictly at 1
    rank, its denoiser moved and its VAE as booted."""
    from ladiff_torch.config import assemble_config
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.training.loop import build_system
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint)
    over = _train_overrides(tmp_path, "pp", STAGE="diffusion",
                            PRETRAINED_VAE="", PIPELINE_STAGES=3,
                            PIPELINE_MICROBATCHES=2)
    cfg_path = os.path.join(REPO, "configs", "config_ladiff_humanml3d.yaml")
    got = ranks.spawn(4, [("train", "run_training_job", {
        "cfg": cfg_path, "assets": ASSETS, "overrides": over, "steps": 2})],
        {}, tmp_path / "ranks")
    epoch, path = latest_checkpoint(str(got["train"]["ckpt_dir"]))
    assert epoch == 1
    _, sd = load_checkpoint(path)
    cfg = assemble_config(cfg_path, ASSETS, over)
    dm = get_datasets(cfg)[0]
    build_system(cfg, dm, device="cpu").load_state_dict(sd, strict=True)
    fresh = build_system(cfg, dm, device="cpu").state_dict()
    moved = [k for k in sd if k.startswith("denoiser.")
             and not torch.equal(sd[k], fresh[k])]
    assert len(moved) > 10
    assert all(torch.equal(sd[k], fresh[k]) for k in sd
               if k.startswith("vae."))


# -- evaluation ---------------------------------------------------------------

FAMILIES = {"temos": "APE_", "tm2t": "R_precision", "mr": "MPJPE",
            "uncond": "uncond_", "multimodality": "MultiModality"}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_test_at_2_ranks_matches_1(two_ranks, family):
    """Every metric of each family within 1e-6 relative (float32), and rank
    0 alone wrote the metrics file."""
    root, got, one = two_ranks
    two = got["eval"]
    names = [k for k in one if FAMILIES[family] in k]
    assert names, sorted(one)
    for k in names:
        w, g = np.asarray(one[k]), np.asarray(two[k])
        np.testing.assert_allclose(g, w, rtol=EVAL_TOL, atol=1e-7,
                                   err_msg=k)
    assert len([f for f in os.listdir(root / "two")
                if f.startswith("metrics_")]) == 1


# -- the dry run -------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multiprocess(tmp_path, n):
    """Every layout ``n`` ranks admit takes a finite step (the pipeline at
    3), and all of them agree on the loss of the same global batch and
    draws; the data-parallel eval batch comes back whole."""
    from ladiff_torch.parallel.dryrun import dryrun_multiprocess
    rec = dryrun_multiprocess(n, "cpu", workdir=str(tmp_path))
    steps = rec["steps"]
    want = {"dp_vae", "dp_diffusion", "fsdp_vae", "fsdp_diffusion", "tp_vae",
            "tp_diffusion", "sp_vae"} | ({"pp_diffusion"} if n >= 3 else set())
    assert set(steps) == want
    assert rec["backend"] == "gloo" and rec["skipped"] == []
    for stage in ("vae", "diffusion"):
        ref = steps[f"dp_{stage}"]
        for name, logs in steps.items():
            if name.endswith(stage):
                for k in ("total", "grad_norm"):
                    assert abs(logs[k] - ref[k]) <= 1e-4 * abs(ref[k]), name
    assert rec["eval_shapes"]["lat_rm"] == [2 * n, 512]
