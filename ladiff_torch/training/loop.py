"""Training orchestration (counterpart of ``ladiff_tpu/training/loop.py``):
the two-stage loop with checkpoints and resume, on one device.

  * stage "vae": VAE reconstruction training (the LA-VAE, batch 64 in the
    published configuration; the ActorVae of the action family, batch
    128),
  * stage "diffusion": denoiser training with the stage-1 VAE frozen,
    booted from ``TRAIN.PRETRAINED_VAE`` (a checkpoint directory or a
    reference ``.ckpt``); feature-space diffusion (``VAE_TYPE`` "no", the
    novae family) has no VAE to boot and trains the denoiser alone, and
    runs no other stage,
  * stage "vae_diffusion": both trees at once,
  * stage "distill": progressive distillation (``training/distill.py``) of
    the stage-2 teacher named by ``TRAIN.PRETRAINED`` (a checkpoint
    directory, its newest file, or a reference ``.ckpt``, loaded by the
    reference's names with the frozen VAE from the same file) into a
    student that starts as a copy of it and shares no storage with it, on
    a grid of ``TRAIN.DISTILL_STEPS`` (half the inference steps unless
    set); the checkpoints carry the student as ``denoiser.*``,
  * periodic keep-all checkpoints (``utils/checkpoint.py``), newest-checkpoint
    resume, one loss line per epoch.

The step is ``training/trainer.py``'s; the batch pipeline runs on a
``HostPrefetcher`` thread (collate, pinned host tensors, asynchronous copies
on the current stream, which the step's kernels then follow in order).
Captions are embedded on the main thread by a ``CaptionEmbedder`` (frozen
CLIP once per unique caption, cached on the host), so no tensor is read on
one stream while another writes it.  The action family (``model.condition``
"action") has no text tower: its batches carry class ids ("action"), which
the denoiser embeds; it trains stages vae and diffusion (the joint stage
reads captions, and ``distill`` folds text guidance into the student, so
both refuse it, as in the JAX package).  Dropout and noise draw from one
``torch.Generator`` on the device, seeded from ``SEED_VALUE``, which also
seeds the parameters' initialisation.  ``TRAIN.RNG_IMPL`` is validated as in
the JAX package and has no effect here.

Under ``torchrun`` (a process group, ``parallel/mesh.py``) every rank loads
the same global batch, pads it to a multiple of the data width and trains
on its rows (``trainer.make_parallel_step``): data parallelism by default,
or the one layout the configuration names, checked as the JAX package
checks it (``check_layout``): ``TRAIN.FSDP`` (ZeRO-3 over the data dim),
``TRAIN.TENSOR_PARALLEL`` (Megatron over a ``model`` dim of that width),
``TRAIN.SEQUENCE_PARALLEL`` (the VAE's tokens over it; stage ``vae``),
``TRAIN.PIPELINE_STAGES`` (GPipe over the denoiser's MD stack on the first
that many ranks, ``TRAIN.PIPELINE_MICROBATCHES`` microbatches; stage
``diffusion``).  The step's draws come from a generator seeded alike on
every rank, each rank's dropout from one seeded by its data rank.  Logging
and checkpoint writes happen on rank 0; a checkpoint holds the whole
parameters under every layout, so it loads at any world size, and a resume
re-shards it.  Without a process group the loop runs on one device as
before.
"""
from __future__ import annotations

import copy
import inspect
import logging
import os
import queue
import signal
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ladiff_torch.data.datamodule import T2MDataModule
from ladiff_torch.models.ladiff import LADiffSystem
from ladiff_torch.parallel import mesh as pmesh
from ladiff_torch.training.trainer import (diffusion_train_step,
                                           distill_train_step,
                                           global_draws, make_optimizer,
                                           make_parallel_step,
                                           vae_diffusion_train_step,
                                           vae_train_step)
from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                           load_checkpoint, load_teacher,
                                           load_vae, save_checkpoint,
                                           subtree)
from ladiff_torch.utils.device import resolve_device

__all__ = ["CaptionEmbedder", "HostPrefetcher", "PreemptionGuard",
           "run_training", "build_system", "build_text_encoder",
           "check_layout"]

RNG_IMPLS = ("threefry", "threefry2x32", "rbg", "unsafe_rbg")


class HostPrefetcher:
    """Double-buffers the per-step host pipeline behind the device step.

    The reference hides input latency behind Lightning's NUM_WORKERS=8
    dataloader.  Here one background thread is enough: it runs ``prepare``
    (collate -> pinned host tensors -> asynchronous host-to-device copy) for
    batch N+1..N+depth while the device executes step N, so the step never
    waits on host work in steady state.  The main thread keeps the training
    generator, so results are bit-identical with prefetching on or off.

    Exceptions in the producer surface in the consumer (re-raised from
    ``__next__``); ``close()`` stops the producer early (preemption /
    max-steps break) without deadlocking on a full queue.
    """

    _DONE = object()

    def __init__(self, iterator, prepare, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        # a prepare(item, stop_event) signature opts into checking the
        # stop event between its pipeline stages, so close() doesn't have
        # to wait out a whole collate+embed+transfer chain
        try:
            self._pass_stop = len(
                inspect.signature(prepare).parameters) >= 2
        except (TypeError, ValueError):
            self._pass_stop = False
        self._thread = threading.Thread(
            target=self._run, args=(iterator, prepare), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, iterator, prepare):
        try:
            for item in iterator:
                if self._stop.is_set():
                    return
                out = (prepare(item, self._stop) if self._pass_stop
                       else prepare(item))
                # a stop-aware prepare may have bailed mid-pipeline
                if self._stop.is_set() or not self._put(out):
                    return
        except BaseException as e:  # surfaced in __next__
            self._exc = e
        finally:
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    # producer died without managing to enqueue the sentinel
                    item = self._DONE
                    break
        if item is self._DONE:
            self._thread.join()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        """Stop the producer and release queue slots; idempotent."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            # still blocked inside prepare(): it will exit at its next
            # stop-event check, but until then it is consuming the old
            # iterator — make that visible instead of silent
            logging.getLogger(__name__).warning(
                "HostPrefetcher.close(): producer thread still running "
                "after 5s join timeout (blocked inside prepare()); it will "
                "exit at the next stop check")


class PreemptionGuard:
    """Preemption-safe shutdown: SIGTERM/SIGINT set a flag the training loop
    polls between steps, triggering a checkpoint save + clean return.

    The reference has no preemption handling (resume from a directory
    only); on shared machines preemption is routine, so the loop
    checkpoints before dying instead of losing up to
    SACE_CHECKPOINT_EPOCH (200) epochs.  Use as a context manager; the
    previous handlers are restored on exit.  A second signal falls through
    to the previous handler (so ctrl-C twice still kills).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self.triggered = False
        self._prev = {}

    def _handler(self, signum, frame):
        if self.triggered:  # second signal: escalate to the old handler
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                raise KeyboardInterrupt
        self.triggered = True

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.getsignal(s)
            try:
                signal.signal(s, self._handler)
            except ValueError:  # not the main thread — run unguarded
                self._prev.pop(s, None)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            # getsignal() returns None for handlers installed by non-Python
            # code; signal.signal(s, None) would raise, so fall back to the
            # default disposition
            signal.signal(s, signal.SIG_DFL if prev is None else prev)
        return False


class CaptionEmbedder:
    """caption strings -> pooled text features [B, 1, dim] (float32, on the
    CPU), each unique caption through the text encoder once."""

    def __init__(self, text_encoder):
        self.text_encoder = text_encoder
        self._cache: Dict[str, torch.Tensor] = {}

    def __call__(self, texts) -> torch.Tensor:
        missing = sorted({t for t in texts if t not in self._cache})
        if missing:
            embs = torch.as_tensor(self.text_encoder(missing))
            for t, e in zip(missing, embs.float().cpu()):
                self._cache[t] = e
        return torch.stack([self._cache[t] for t in texts])

    @property
    def uncond(self) -> torch.Tensor:
        return self([""])  # [1, 1, dim]


def _ram_pct() -> Optional[float]:
    """Host RAM usage in percent, dependency-free (/proc/meminfo) — the
    per-epoch RAM readout of the reference's ProgressLogger
    (callback/progress.py:30-54, psutil there)."""
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                info[k] = int(v.strip().split()[0])
        return 100.0 * (1.0 - info["MemAvailable"] / info["MemTotal"])
    except Exception:  # non-Linux host: skip the readout
        return None


def build_system(cfg, dm: T2MDataModule, device=None,
                 train_whole_layer: Optional[str] = None) -> LADiffSystem:
    """The configured system with float32 parameters on ``device`` (the GPU
    unless the caller names another).  ``TRAIN.MIXED_PRECISION`` selects
    bf16 compute, through the CUDA kernels on a GPU; without it (the
    published configurations) the system computes in float32 on any
    device, as the JAX package does, and on a GPU through the kernels'
    float32 chains: K1, K2, kernels 5 and 10 at inference, the training
    kernels 8 and 9 (12 and 13 on the whole-layer route), forward and
    backward; only CLIP's K3 and K4 and kernels 6, 7 and 11 take bf16
    alone, and their modules run plain in float32.  ``train_whole_layer``
    (None: the environment's ``LADIFF_TRAIN_WHOLE_LAYER``, default "0") runs
    the VAE's training layers as kernels 12 and 13, in either type."""
    mixed = bool(cfg.TRAIN.get("MIXED_PRECISION", False))
    device = resolve_device(device)
    if train_whole_layer is None:
        train_whole_layer = os.environ.get("LADIFF_TRAIN_WHOLE_LAYER", "0")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(cfg.get("SEED_VALUE", 1234)))
        return LADiffSystem.from_cfg(
            cfg, nfeats=dm.nfeats, njoints=dm.njoints, mean=dm.mean,
            std=dm.std, train_whole_layer=str(train_whole_layer),
            device=device,
            dtype=torch.bfloat16 if mixed else torch.float32,
            param_dtype=torch.float32)


def check_layout(cfg, stage: str, system: LADiffSystem, n_avail: int
                 ) -> Dict[str, int]:
    """The parallel layout the configuration names, checked as the JAX
    package's loop checks it for a world of ``n_avail`` ranks: the widths
    are at least 1, ``TENSOR_PARALLEL`` and ``SEQUENCE_PARALLEL`` divide the
    world, at most one non-DP layout, sequence parallelism for stage
    ``vae`` only, the pipeline for stage ``diffusion`` on the non-AR
    ``MD_TRANS`` denoiser and no wider than the world; ``RNG_IMPL`` is one
    the JAX package knows.  Returns {"kind": "dp" | "fsdp" | "tp" | "sp" |
    "pp", "n_model", "n_seq", "n_pipe"}."""
    n_model = int(cfg.TRAIN.get("TENSOR_PARALLEL", 1) or 1)
    if n_model < 1 or n_avail % n_model != 0:
        raise ValueError(
            f"TRAIN.TENSOR_PARALLEL={n_model} must divide the device count "
            f"({n_avail})")
    fsdp = bool(cfg.TRAIN.get("FSDP", False))
    n_seq = int(cfg.TRAIN.get("SEQUENCE_PARALLEL", 1) or 1)
    n_pipe = int(cfg.TRAIN.get("PIPELINE_STAGES", 1) or 1)
    for name, n in (("SEQUENCE_PARALLEL", n_seq),
                    ("PIPELINE_STAGES", n_pipe)):
        if n < 1:
            raise ValueError(f"TRAIN.{name}={n} must be >= 1")
    axes_on = [name for name, on in [
        ("TENSOR_PARALLEL", n_model > 1), ("FSDP", fsdp),
        ("SEQUENCE_PARALLEL", n_seq > 1), ("PIPELINE_STAGES", n_pipe > 1)]
        if on]
    if len(axes_on) > 1:
        raise ValueError(
            f"TRAIN.{' and TRAIN.'.join(axes_on)} are mutually exclusive "
            "(pick one non-DP parallelism layout)")
    if n_seq > 1:
        if stage != "vae":
            raise ValueError(
                "TRAIN.SEQUENCE_PARALLEL shards the VAE token axis; it is "
                f"supported for TRAIN.STAGE=vae only (got {stage!r})")
        if n_avail % n_seq != 0:
            raise ValueError(
                f"TRAIN.SEQUENCE_PARALLEL={n_seq} must divide the device "
                f"count ({n_avail})")
    if n_pipe > 1:
        if stage != "diffusion":
            raise ValueError(
                "TRAIN.PIPELINE_STAGES pipelines the denoiser MD stack; it "
                f"is supported for TRAIN.STAGE=diffusion only (got {stage!r})")
        if system.ardiff or not system.md_trans:
            raise ValueError(
                "TRAIN.PIPELINE_STAGES needs the MD_TRANS denoiser "
                "(non-AR): the pipeline program covers the MD skip stack")
        if n_pipe > n_avail:
            raise ValueError(
                f"TRAIN.PIPELINE_STAGES={n_pipe} exceeds the device count "
                f"({n_avail})")
    impl = str(cfg.TRAIN.get("RNG_IMPL", "threefry"))
    if impl not in RNG_IMPLS:
        raise ValueError(f"TRAIN.RNG_IMPL={impl!r} is not recognized; "
                         f"expected one of {sorted(RNG_IMPLS)}")
    kind = ("tp" if n_model > 1 else "fsdp" if fsdp else "sp" if n_seq > 1
            else "pp" if n_pipe > 1 else "dp")
    return {"kind": kind, "n_model": n_model, "n_seq": n_seq,
            "n_pipe": n_pipe}


def build_text_encoder(cfg, device):
    """The frozen CLIP text tower of the configuration (``model.clip_path``;
    random weights from a seed where it has none) on ``device``: in bf16
    on a GPU with ``TRAIN.MIXED_PRECISION`` (kernels K3 and K4), else in
    float32, as the JAX package's tower, through their plain versions."""
    from ladiff_torch.models.clip_text import ClipTextEncoder
    mixed = bool(cfg.TRAIN.get("MIXED_PRECISION", False))
    return ClipTextEncoder(
        modelpath=str(cfg.model.get("clip_path", "") or "") or None,
        device=device, dtype=None if mixed else torch.float32)


def run_training(cfg, dm: T2MDataModule, logger, text_encoder=None,
                 max_epochs: Optional[int] = None,
                 max_steps_per_epoch: Optional[int] = None,
                 device=None) -> str:
    """Trains the configured stage on ``device`` (the GPU unless the caller
    names another; under a process group, this rank's device); returns the
    checkpoint directory."""
    stage = str(cfg.TRAIN.STAGE)
    if stage not in ("vae", "diffusion", "vae_diffusion", "distill"):
        raise ValueError(f"unsupported stage {stage}")
    teacher_src = str(cfg.TRAIN.get("PRETRAINED", "") or "")
    action = str(cfg.model.get("condition", "text")) == "action"
    if action and stage == "vae_diffusion":
        raise ValueError("TRAIN.STAGE=vae_diffusion reads captions: the "
                         "action condition trains stages vae and diffusion")
    if stage == "distill":
        if str(cfg.model.get("condition", "text")) != "text":
            raise ValueError("TRAIN.STAGE=distill supports the text "
                             "condition only")
        if not teacher_src:
            raise ValueError("TRAIN.STAGE=distill needs TRAIN.PRETRAINED "
                             "(the stage-2 teacher checkpoint)")
    system = build_system(cfg, dm, device=device)
    layout = check_layout(cfg, stage, system, pmesh.world_size())
    if system.vae is None and stage not in ("diffusion", "distill"):
        raise NotImplementedError(
            f"TRAIN.STAGE={stage} with VAE_TYPE {system.vae_type!r}: "
            "feature-space diffusion has no VAE and trains stages diffusion "
            "and distill only (the JAX package has no such path)")
    dev = system.device
    seed = int(cfg.get("SEED_VALUE", 1234))
    gen = torch.Generator(device=dev).manual_seed(seed)
    ckpt_dir = os.path.join(str(cfg.get("FOLDER_EXP", ".")), "checkpoints")
    parallel = pmesh.is_distributed()
    main_rank = pmesh.rank() == 0

    embedder = uncond = teacher = student_steps = None
    if stage == "vae":
        trained = system.vae
    else:
        if stage == "distill":
            # the student is the system's denoiser, booted from the teacher
            epoch, path = load_teacher(system, teacher_src)
            logger.info(f"loaded teacher epoch {epoch} from {path}")
            teacher = copy.deepcopy(system.denoiser).requires_grad_(False)
            student_steps = int(cfg.TRAIN.get(
                "DISTILL_STEPS", max(1, system.num_inference_timesteps // 2)))
            trained = system.denoiser
        elif stage == "diffusion":
            trained = system.denoiser
            vae_src = str(cfg.TRAIN.get("PRETRAINED_VAE", "") or "")
            if vae_src and system.vae is None:
                logger.warning(f"VAE_TYPE {system.vae_type!r} has no VAE: "
                               f"PRETRAINED_VAE {vae_src} is not loaded")
            elif vae_src:
                epoch, path = load_vae(system.vae, vae_src)
                logger.info(f"loaded VAE epoch {epoch} from {path}")
        else:
            trained = system
        if not action:
            embedder = CaptionEmbedder(text_encoder
                                       or build_text_encoder(cfg, dev))
            uncond = embedder.uncond.to(dev)

    start_epoch = 0
    if str(cfg.TRAIN.get("RESUME", "") or ""):
        found = latest_checkpoint(ckpt_dir)
        if found:
            # into the whole system: a layout re-shards it below
            start_epoch, sd = load_checkpoint(found[1])
            if stage == "vae":
                system.vae.load_state_dict(subtree(sd, "vae."), strict=True)
            else:
                system.load_state_dict(sd, strict=True)
            logger.info(f"resumed from epoch {start_epoch}")

    lr = float(cfg.TRAIN.OPTIM.LR)
    pad_multiple = 1
    parallel_step = pp_step = group = None
    if not parallel:
        optimizer = make_optimizer(trained.parameters(), lr)
    elif layout["kind"] == "pp":
        from ladiff_torch.parallel.pp import (make_pipe_group,
                                              make_pp_diffusion_train_step)
        group = make_pipe_group(layout["n_pipe"])
        if pmesh.rank() >= layout["n_pipe"]:
            # as make_pipe_mesh(n_pipe) leaves the other devices unused
            logger.info(f"rank {pmesh.rank()} takes no part in the "
                        f"{layout['n_pipe']}-stage pipeline")
            return ckpt_dir
        pad_multiple = int(cfg.TRAIN.get("PIPELINE_MICROBATCHES",
                                         layout["n_pipe"]) or layout["n_pipe"])
        pp_step = make_pp_diffusion_train_step(system, group=group,
                                               n_micro=pad_multiple)
        optimizer = make_optimizer(trained.parameters(), lr)
    else:
        width = layout["n_model"] * layout["n_seq"]
        mesh = pmesh.make_mesh(n_model=width,
                               device_type="cuda" if dev.type == "cuda"
                               else "cpu")
        pad_multiple = pmesh.world_size() // width
        parallel_step, optimizer, _ = make_parallel_step(
            system, stage, layout["kind"], mesh,
            optimizer_factory=lambda ps: make_optimizer(ps, lr),
            uncond_emb=uncond, teacher=teacher, student_steps=student_steps)
        logger.info(f"layout {layout['kind']} on a {pad_multiple} x {width} "
                    f"(data x model) mesh of {pmesh.world_size()} ranks")
    # dropout draws differ over the ranks that split the batch and agree
    # over those that compute the same rows (model dim, pipeline stages)
    data_rank = (pmesh.rank() // (layout["n_model"] * layout["n_seq"])
                 if parallel and layout["kind"] != "pp" else 0)
    drop_gen = (torch.Generator(device=dev).manual_seed(seed + 1 + data_rank)
                if parallel else gen)

    def save(epoch_mark: int) -> str:
        # the stage-2 checkpoints carry the frozen VAE too, as the
        # reference's stage-2 checkpoints do; every layout writes the whole
        # parameters (a collective: every rank gathers, rank 0 writes)
        sd = pmesh.full_state_dict(system) if parallel else system.state_dict()
        if stage == "vae":
            sd = {k: v for k, v in sd.items() if k.startswith("vae.")}
        path = os.path.join(ckpt_dir, f"epoch_{epoch_mark}.ckpt")
        return save_checkpoint(ckpt_dir, epoch_mark, sd) if main_rank \
            else path

    def step(batch):
        if stage != "vae" and not action:
            batch["text_emb"] = embedder(batch.pop("text")).to(dev)
        if parallel_step is not None:
            return parallel_step(batch, gen, drop_gen)
        if pp_step is not None:
            draws = global_draws(system, stage, len(batch["motion"]), gen,
                                 frames=batch["motion"].shape[1])
            return pp_step(optimizer, batch, uncond, drop_gen, **draws)
        if stage == "vae":
            return vae_train_step(system, optimizer, batch, gen)
        if stage == "distill":
            return distill_train_step(system, teacher, optimizer, batch,
                                      uncond, student_steps, gen)
        fn = (diffusion_train_step if stage == "diffusion"
              else vae_diffusion_train_step)
        return fn(system, optimizer, batch, uncond, gen)

    pin = dev.type == "cuda"

    def prepare_batch(batch: dict, stop=None):
        """The per-step host pipeline (on the prefetch thread): the global
        batch padded to split evenly over the ranks, numpy -> pinned host
        tensors -> asynchronous copies to the device on the current stream.
        Returns None without copying once ``stop`` (the prefetcher's stop
        event) is set."""
        if stop is not None and stop.is_set():
            return None
        batch = pmesh.pad_batch(batch, pad_multiple)
        out = {}
        keys = ("motion", "length") + (
            ("action",) if action and stage != "vae" else ())
        for key in keys:
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            if key != "motion":
                t = t.long()
            out[key] = (t.pin_memory() if pin else t).to(dev,
                                                          non_blocking=True)
        if stage != "vae" and not action:
            out["text"] = list(batch["text"])
        return out

    from ladiff_torch.utils.logger import MetricsLogger
    metrics_sink = MetricsLogger.from_cfg(cfg) if main_rank else None
    end_epoch = (max_epochs if max_epochs is not None
                 else int(cfg.TRAIN.END_EPOCH))
    save_every = int(cfg.LOGGER.get("SACE_CHECKPOINT_EPOCH", 200))
    bs = int(cfg.TRAIN.BATCH_SIZE)
    prefetch = int(cfg.TRAIN.get("PREFETCH", 2))
    buckets = cfg.TRAIN.get("LENGTH_BUCKETS", None)
    buckets = tuple(buckets) if buckets else None

    def stop_requested(guard) -> bool:
        """The preemption flag, true on every rank once any rank got it."""
        if not parallel:
            return guard.triggered
        flag = torch.tensor([float(guard.triggered)], device=dev)
        # the pipeline's group: the ranks past its stages have returned
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX,
                                     group=group)
        return bool(flag.item())

    def close_sink():
        if metrics_sink is not None:
            metrics_sink.close()

    with PreemptionGuard() as guard:
        for epoch in range(start_epoch, end_epoch):
            t0 = time.time()
            losses = []
            loader = dm.loader("train", batch_size=bs, seed=epoch,
                               buckets=buckets)
            batches = (HostPrefetcher(loader, prepare_batch, depth=prefetch)
                       if prefetch > 0 else map(prepare_batch, loader))
            stopped = False
            try:
                for i, batch in enumerate(batches):
                    if max_steps_per_epoch and i >= max_steps_per_epoch:
                        break
                    if stop_requested(guard):
                        stopped = True
                        break
                    losses.append(step(batch))
            finally:
                if isinstance(batches, HostPrefetcher):
                    batches.close()
            if stopped or (not parallel and guard.triggered):
                # mark the checkpoint with the current epoch, so a resume
                # runs this epoch again from its start
                path = save(epoch)
                logger.info(f"preemption signal: saved {path} mid-epoch "
                            f"{epoch}, exiting cleanly")
                close_sink()
                return ckpt_dir
            if losses and main_rank:
                # one device-to-host copy for the epoch's scalars
                keys = sorted(losses[0])
                host = torch.stack([torch.stack([l[k].float() for k in keys])
                                    for l in losses]).cpu().numpy()
                mean_logs = dict(zip(keys, map(float, host.mean(axis=0))))
                dt = time.time() - t0
                ram = _ram_pct()
                logger.info(
                    f"epoch {epoch} [{stage}] "
                    + " ".join(f"{k}={v:.5f}" for k, v in mean_logs.items())
                    + f" ({dt:.1f}s"
                    + (f", RAM {ram:.0f}%)" if ram is not None else ")"))
                metrics_sink.log(epoch, mean_logs, prefix=f"train/{stage}/")
            if (epoch + 1) % save_every == 0 or (epoch + 1) == end_epoch:
                path = save(epoch + 1)
                if main_rank:
                    logger.info(f"saved checkpoint {path}")
    close_sink()
    return ckpt_dir
