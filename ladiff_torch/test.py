"""Benchmark evaluation entry point of the port (counterpart of the
repository's ``test.py``):

    python -m ladiff_torch.test --cfg configs/config_ladiff_humanml3d.yaml \
        [--replication N] [--cpu]

The reference protocol (test.py:39-170): ``TEST.REPLICATION_TIMES`` passes
of the T2M metric suite over the test split, each followed by a
MultiModality pass (``TEST.MM_NUM_SAMPLES`` captions, ``TEST.MM_NUM_REPEATS``
generations each), aggregated as mean ± 1.96 σ / √n and written to
``<experiment>/metrics_<time>.json``.  Restores the newest checkpoint under
``TEST.CHECKPOINTS`` (a stage-1 checkpoint takes the denoiser from a fresh
initialization); without the T2M evaluators' ``finest.tar`` under
``model.t2m_path`` the evaluators take random weights, with a warning, and
the metrics are then self-consistent only.  Runs on the GPU; ``--cpu`` runs
the plain PyTorch paths.

Each batch's initial latents (stage ``diffusion``) or encoder noise (stage
``vae``) come from one ``torch.Generator`` on the CPU seeded with
``SEED_VALUE`` (``draw_noise``), so a CPU run and a GPU run of one seed see
the same noise.

The action-conditioned benchmark (``METRIC.TYPE`` ``HUMANACTMetrics`` or
``UESTCMetrics``, the root ``test.py``'s ``_run_a2m_test``): per
replication one pass over the action dataset's test split
(``evaluation/a2m_eval.py``) with the HumanAct12 GRU classifier
(``model.humanact12_rec_path``, default
``deps/actionrecognition/humanact12_gru.tar``) or the UESTC ST-GCN
(``uestc_rot6d_stgcn.tar`` under ``model.uestc_rec_path``); a classifier
whose checkpoint is absent takes random weights from seed 0, with a
warning (the metrics are then self-consistent only), as the SMPL body is
synthetic where ``SMPL_NEUTRAL.pkl`` is absent.  Replication r draws its
noise from a CPU generator seeded r, as the JAX package's does from its
key r.
"""
from __future__ import annotations

import json
import os
import re
import sys
import time
from collections import defaultdict
from os.path import join as pjoin
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["run_test", "draw_noise", "main"]

A2M_METRICS = ("HUMANACTMetrics", "UESTCMetrics")


def _aggregate(values) -> Tuple[float, float]:
    """(mean, 1.96 σ / √n) with numpy's population σ (ddof 0)."""
    arr = np.asarray(values, dtype=np.float64)
    conf = 1.96 * arr.std() / max(np.sqrt(len(arr)), 1)
    return float(arr.mean()), float(conf)


def draw_noise(generator: torch.Generator, n: int, system) -> torch.Tensor:
    """One batch's noise [n, n_latents, D] (float32, on the CPU): the
    initial latents in stage ``diffusion``, the encoder's sample noise in
    ``vae``; with ``vae_type`` "no" the initial frames [n, max_frames,
    nfeats]."""
    shape = ((n, system.max_frames, system.nfeats) if system.vae is None
             else (n, system.n_latents, system.latent_dim[-1]))
    return torch.randn(shape, generator=generator)


def _host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


def _tensors(batch: dict, rows: int = 1) -> dict:
    """A collated numpy batch as tensors, each row repeated ``rows`` times."""
    out = {}
    for key in ("motion", "length", "word_embs", "pos_ohot", "text_len"):
        v = np.repeat(batch[key], rows, 0) if rows > 1 else batch[key]
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[key] = t.long() if key in ("length", "text_len") else t.float()
    return out


def _restore(system, cfg, state_dict, logger) -> None:
    """Loads the checkpoint (``state_dict``, or the newest file under
    ``TEST.CHECKPOINTS``) strictly; a checkpoint without a denoiser keeps
    the system's fresh one (test.py:55-57)."""
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint)
    if state_dict is None:
        src = str(cfg.TEST.CHECKPOINTS)
        found = latest_checkpoint(src)
        if found is None:
            raise FileNotFoundError(f"no checkpoint under {src}")
        epoch, state_dict = load_checkpoint(found[1])
        logger.info(f"loaded checkpoint epoch {epoch} from {found[1]}")
    if not any(k.startswith("denoiser.") for k in state_dict):
        fresh = {k: v for k, v in system.state_dict().items()
                 if k.startswith("denoiser.")}
        state_dict = {**state_dict, **fresh}
    system.load_state_dict(state_dict, strict=True)


def run_test(cfg, logger, text_encoder=None,
             state_dict: Optional[Dict[str, torch.Tensor]] = None,
             device=None) -> Dict[str, Tuple[float, float]]:
    """The benchmark on ``device`` (the GPU unless the caller names
    another); returns {metric: (mean, conf)}.  ``state_dict`` replaces the
    checkpoint restore; ``text_encoder`` the CLIP text tower.  Each
    replication's and each MultiModality pass's log record carries
    ``span`` ("replication" / "mm_pass") and ``seconds``."""
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.evaluation.t2m_eval import T2MEvaluator, eval_step
    from ladiff_torch.metrics.mm import MMMetrics
    from ladiff_torch.metrics.mr import MRMetrics
    from ladiff_torch.metrics.temos import TemosMetrics
    from ladiff_torch.metrics.tm2t import TM2TMetrics
    from ladiff_torch.metrics.uncond import UncondMetrics
    from ladiff_torch.training.loop import (CaptionEmbedder, build_system,
                                           build_text_encoder)
    from ladiff_torch.utils.device import resolve_device

    metric_types: List[str] = list(cfg.METRIC.TYPE)
    device = resolve_device(device)
    dm = get_datasets(cfg, phase="test")[0]
    if any(m in A2M_METRICS for m in metric_types):
        return _run_a2m_test(cfg, logger, dm, state_dict, device)
    system = build_system(cfg, dm, device=device)
    _restore(system, cfg, state_dict, logger)
    embedder = CaptionEmbedder(text_encoder
                               or build_text_encoder(cfg, device))

    t2m_path = str(cfg.model.get("t2m_path", "") or "")
    dataname = "t2m" if dm.name == "humanml3d" else dm.name
    fin = pjoin(t2m_path, dataname, "text_mot_match", "model", "finest.tar")
    evaluator = T2MEvaluator.from_checkpoint(fin, dm.nfeats, device)
    if evaluator is None:
        logger.warning(
            f"T2M evaluator weights not found at {fin}; using random-init "
            "evaluators (metrics are self-consistent only)")
        evaluator = T2MEvaluator.random_init(
            dm.nfeats, torch.Generator().manual_seed(0), device)

    stage = "vae" if str(cfg.TRAIN.STAGE) == "vae" else "diffusion"
    reps = int(cfg.TEST.REPLICATION_TIMES)
    bs = int(cfg.TEST.BATCH_SIZE)
    n_rep_mm = int(cfg.TEST.MM_NUM_REPEATS)
    gen = torch.Generator().manual_seed(int(cfg.get("SEED_VALUE", 1234)))
    uncond = embedder.uncond

    def step(batch, cond):
        noise = draw_noise(gen, len(cond), system)
        return eval_step(system, evaluator, batch, cond,
                         uncond.expand(len(cond), -1, -1), stage,
                         mean_eval=dm.mean_eval, std_eval=dm.std_eval,
                         **{"init_latents" if stage == "diffusion"
                            else "eps": noise})

    count_time = bool(cfg.TEST.get("COUNT_TIME", False))
    # TEST.SAVE_LATENTS (reference ladiff.py:1175-1191): each vae-stage
    # batch's encoded latents as <LATENTS_DIR>/latent_<n>.npy, n counting on
    # from the highest file there
    save_latents = bool(cfg.TEST.get("SAVE_LATENTS", False)) and \
        stage == "vae"
    latents_dir = str(cfg.TEST.get("LATENTS_DIR", "./datasets/latents"))
    if save_latents:
        os.makedirs(latents_dir, exist_ok=True)
        existing = [int(m.group(1)) for f in os.listdir(latents_dir)
                    if (m := re.fullmatch(r"latent_(\d+)\.npy", f))]
        latent_count = max(existing, default=-1) + 1

    all_metrics = defaultdict(list)
    times = []
    for rep in range(reps):
        tm2t = TM2TMetrics(diversity_times=min(
            int(cfg.TEST.DIVERSITY_TIMES), 300), seed=rep)
        temos = TemosMetrics(njoints=dm.njoints, jointstype=dm.name)
        mr = MRMetrics(njoints=dm.njoints)
        uncond_metric = UncondMetrics(seed=rep)
        t0 = time.perf_counter()
        n_seq = 0
        for batch in dm.loader("test", batch_size=bs, shuffle=True, seed=rep):
            cond = embedder(batch["text"])
            bt0 = time.perf_counter()
            out = _host(step(_tensors(batch), cond))
            if count_time:
                # reference TEST.COUNT_TIME: seconds per batch, times.txt
                # (ladiff.py:253-306)
                times.append(time.perf_counter() - bt0)
            if save_latents:
                np.save(pjoin(latents_dir, f"latent_{latent_count:06d}.npy"),
                        out["z"])
                latent_count += 1
            lengths = list(np.asarray(batch["length"]))
            n_seq += len(lengths)
            if "TM2TMetrics" in metric_types:
                tm2t.update(out["lat_t"], out["lat_rm"], out["lat_m"],
                            lengths)
            if "TemosMetric" in metric_types:
                temos.update(out["joints_rst"], out["joints_ref"], lengths)
            if "MRMetrics" in metric_types:
                mr.update(out["joints_rst"], out["joints_ref"], lengths)
            if "UncondMetrics" in metric_types:
                uncond_metric.update(out["lat_rm"], out["lat_m"], lengths)

        rep_metrics = {}
        if "TM2TMetrics" in metric_types and n_seq > tm2t.R_size:
            rep_metrics.update(tm2t.compute())
        if "TemosMetric" in metric_types:
            rep_metrics.update(temos.compute())
        if "MRMetrics" in metric_types:
            rep_metrics.update(mr.compute())
        if "UncondMetrics" in metric_types and uncond_metric.count_seq > 1:
            rep_metrics.update({f"uncond_{k}": v for k, v in
                                uncond_metric.compute().items()})

        # MultiModality pass (reference test.py:142-146)
        if "TM2TMetrics" in metric_types and stage != "vae":
            mt0 = time.perf_counter()
            mm = MMMetrics(mm_num_times=int(cfg.TEST.MM_NUM_TIMES), seed=rep)
            dm.mm_mode(True, int(cfg.TEST.MM_NUM_SAMPLES), seed=rep)
            for batch in dm.loader("test", batch_size=1, shuffle=False):
                cond = embedder(list(batch["text"]) * n_rep_mm)
                out = _host(step(_tensors(batch, n_rep_mm), cond))
                mm.update(out["lat_rm"][None], [1])
            dm.mm_mode(False)
            if mm.count_seq > int(cfg.TEST.MM_NUM_TIMES):
                rep_metrics.update(mm.compute())
            dt = time.perf_counter() - mt0
            logger.info(f"MultiModality pass {rep + 1}/{reps}: "
                        f"{mm.count_seq} captions x {n_rep_mm} in {dt:.1f}s",
                        extra={"span": "mm_pass", "seconds": dt})

        for k, v in rep_metrics.items():
            all_metrics[k].append(float(v))
        dt = time.perf_counter() - t0
        logger.info(f"replication {rep + 1}/{reps} done in {dt:.1f}s: "
                    + " ".join(f"{k}={v:.4f}" for k, v in
                               sorted(rep_metrics.items())),
                    extra={"span": "replication", "seconds": dt})

    if count_time and times:
        mean_t = float(np.mean(times))
        logger.info(f"mean eval-step latency: {mean_t * 1e3:.1f} ms/batch "
                    f"({mean_t / bs * 1e3:.2f} ms/sample)")
        with open(pjoin(cfg.get("FOLDER_EXP", "."), "times.txt"), "w") as f:
            f.write("\n".join(str(t) for t in times) + "\n")
    return _summarize(cfg, logger, all_metrics)


def _summarize(cfg, logger, all_metrics) -> Dict[str, Tuple[float, float]]:
    """{metric: (mean, conf)} over the replications, logged and written to
    ``<FOLDER_EXP>/metrics_<time>.json``."""
    summary = {k: _aggregate(v) for k, v in all_metrics.items()}
    lines = [f"{k:>24s}: {m:.4f} ± {c:.4f}" for k, (m, c) in
             sorted(summary.items())]
    logger.info("==== final metrics ====\n" + "\n".join(lines))
    stamp = time.strftime("%Y-%m-%dT%H-%M-%S")
    with open(pjoin(cfg.get("FOLDER_EXP", "."),
                    f"metrics_{stamp}.json"), "w") as f:
        json.dump({k: {"mean": m, "conf": c} for k, (m, c) in
                   summary.items()}, f, indent=2)
    return summary


def _a2m_classifier(cfg, num_labels: int, device, logger):
    """(classifier, kind): the UESTC ST-GCN where ``METRIC.TYPE`` names
    ``UESTCMetrics``, else the HumanAct12 GRU (24 x 3 SMPL joints in), with
    its released weights or, where the checkpoint is absent, random ones
    from seed 0 and a warning; float32, eval mode, frozen."""
    from ladiff_torch.models.classifiers import (
        STGCN, MotionDiscriminator, load_gru_classifier_checkpoint,
        load_stgcn_checkpoint)
    if "UESTCMetrics" in list(cfg.METRIC.TYPE):
        kind = "stgcn"
        path = pjoin(str(cfg.model.get("uestc_rec_path", "")
                         or "deps/actionrecognition"),
                     "uestc_rot6d_stgcn.tar")
        make = lambda: STGCN(in_channels=6, num_class=num_labels,
                             num_nodes=24)
        state = load_stgcn_checkpoint(path)
    else:
        kind = "gru"
        path = str(cfg.model.get("humanact12_rec_path", "")
                   or "deps/actionrecognition/humanact12_gru.tar")
        make = lambda: MotionDiscriminator(72, 128, 2, num_labels)
        state = load_gru_classifier_checkpoint(path)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        clf = make()
    if state is None:
        logger.warning(f"{kind} classifier checkpoint not found at {path}; "
                       "using random init (metrics are self-consistent "
                       "only)")
    else:
        clf.load_state_dict(state, strict=True)
    return clf.to(device).eval().requires_grad_(False), kind


def _run_a2m_test(cfg, logger, dm, state_dict, device
                  ) -> Dict[str, Tuple[float, float]]:
    """The action-conditioned benchmark (module docstring); returns
    {metric: (mean, conf)} and writes ``metrics_<time>.json``."""
    from ladiff_torch.evaluation.a2m_eval import run_a2m_eval
    from ladiff_torch.metrics.a2m import ActionClassifierMetrics
    from ladiff_torch.training.loop import build_system
    if not getattr(dm, "is_a2m", False):
        raise ValueError(f"METRIC.TYPE {list(cfg.METRIC.TYPE)} reads an "
                         f"action dataset (HumanAct12, UESTC), not {dm.name}")
    system = build_system(cfg, dm, device=device)
    _restore(system, cfg, state_dict, logger)
    num_labels = int(cfg.DATASET.get("NCLASSES", 12))
    clf, kind = _a2m_classifier(cfg, num_labels, system.device, logger)
    reps = int(cfg.TEST.REPLICATION_TIMES)
    dataset = dm.dataset("test")
    all_metrics = defaultdict(list)
    for rep in range(reps):
        t0 = time.perf_counter()
        metrics = ActionClassifierMetrics(num_labels=num_labels, seed=rep)
        out = run_a2m_eval(system, dataset, clf, metrics,
                           batch_size=int(cfg.TEST.BATCH_SIZE),
                           num_frames=dm.num_frames, classifier_kind=kind,
                           seed=rep)
        for k, v in out.items():
            all_metrics[k].append(float(v))
        dt = time.perf_counter() - t0
        logger.info(f"replication {rep + 1}/{reps} done in {dt:.1f}s: "
                    + " ".join(f"{k}={v:.4f}" for k, v in
                               sorted(out.items())),
                    extra={"span": "replication", "seconds": dt})
    return _summarize(cfg, logger, all_metrics)


def main(argv: Optional[List[str]] = None, device=None, text_encoder=None,
         overrides: Optional[dict] = None) -> Dict[str, Tuple[float, float]]:
    """Parses the command line (``argv``, default ``sys.argv[1:]``) and runs
    the benchmark; returns its summary.  ``overrides`` are merged over the
    configuration files; ``text_encoder`` replaces the CLIP text tower."""
    from ladiff_torch.config import parse_args
    from ladiff_torch.utils.logger import create_logger

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    cfg = parse_args("test", argv, overrides)
    logger = create_logger(cfg, phase="test")
    return run_test(cfg, logger, text_encoder=text_encoder, device=device)


if __name__ == "__main__":
    main()
