"""Training orchestration (counterpart of ``ladiff_tpu/training/loop.py``):
the two-stage loop with checkpoints and resume, on one device.

  * stage "vae": LA-VAE reconstruction training (batch 64 in the published
    configuration),
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
one stream while another writes it.  Dropout and noise draw from one
``torch.Generator`` on the device, seeded from ``SEED_VALUE``, which also
seeds the parameters' initialisation.  ``TRAIN.RNG_IMPL`` is validated as in
the JAX package and has no effect here.  One device only: the parallel
layouts (``TENSOR_PARALLEL``, ``FSDP``, ``SEQUENCE_PARALLEL``,
``PIPELINE_STAGES`` above 1) raise.
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
from ladiff_torch.training.trainer import (diffusion_train_step,
                                           distill_train_step,
                                           make_optimizer,
                                           vae_diffusion_train_step,
                                           vae_train_step)
from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                           load_checkpoint, load_teacher,
                                           load_vae, save_checkpoint,
                                           subtree)
from ladiff_torch.utils.device import resolve_device

__all__ = ["CaptionEmbedder", "HostPrefetcher", "PreemptionGuard",
           "run_training", "build_system", "build_text_encoder"]

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
    device, as the JAX package does, and on a GPU every module takes its
    plain route (the kernels take bf16 only).  ``train_whole_layer``
    (None: the environment's ``LADIFF_TRAIN_WHOLE_LAYER``, default "0") runs
    the VAE's training layers as kernels 12 and 13 in bf16."""
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


def _single_device(cfg, stage: str) -> None:
    for name in ("TENSOR_PARALLEL", "SEQUENCE_PARALLEL", "PIPELINE_STAGES"):
        n = int(cfg.TRAIN.get(name, 1) or 1)
        if n < 1:
            raise ValueError(f"TRAIN.{name}={n} must be >= 1")
        if n > 1:
            raise NotImplementedError(
                f"TRAIN.{name}={n}: ladiff_torch trains on one device "
                "(ROADMAP.md Queue 1: parallelism)")
    if bool(cfg.TRAIN.get("FSDP", False)):
        raise NotImplementedError(
            "TRAIN.FSDP: ladiff_torch trains on one device (ROADMAP.md "
            "Queue 1: parallelism)")
    impl = str(cfg.TRAIN.get("RNG_IMPL", "threefry"))
    if impl not in RNG_IMPLS:
        raise ValueError(f"TRAIN.RNG_IMPL={impl!r} is not recognized; "
                         f"expected one of {sorted(RNG_IMPLS)}")


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
    names another); returns the checkpoint directory."""
    stage = str(cfg.TRAIN.STAGE)
    if stage not in ("vae", "diffusion", "vae_diffusion", "distill"):
        raise ValueError(f"unsupported stage {stage}")
    _single_device(cfg, stage)
    teacher_src = str(cfg.TRAIN.get("PRETRAINED", "") or "")
    if stage == "distill":
        if str(cfg.model.get("condition", "text")) != "text":
            raise ValueError("TRAIN.STAGE=distill supports the text "
                             "condition only")
        if not teacher_src:
            raise ValueError("TRAIN.STAGE=distill needs TRAIN.PRETRAINED "
                             "(the stage-2 teacher checkpoint)")
    system = build_system(cfg, dm, device=device)
    if system.vae is None and stage not in ("diffusion", "distill"):
        raise NotImplementedError(
            f"TRAIN.STAGE={stage} with VAE_TYPE {system.vae_type!r}: "
            "feature-space diffusion has no VAE and trains stages diffusion "
            "and distill only (the JAX package has no such path)")
    dev = system.device
    gen = torch.Generator(device=dev).manual_seed(
        int(cfg.get("SEED_VALUE", 1234)))
    ckpt_dir = os.path.join(str(cfg.get("FOLDER_EXP", ".")), "checkpoints")

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
        embedder = CaptionEmbedder(text_encoder
                                   or build_text_encoder(cfg, dev))
        uncond = embedder.uncond.to(dev)
    optimizer = make_optimizer(trained.parameters(),
                               float(cfg.TRAIN.OPTIM.LR))

    start_epoch = 0
    if str(cfg.TRAIN.get("RESUME", "") or ""):
        found = latest_checkpoint(ckpt_dir)
        if found:
            start_epoch, sd = load_checkpoint(found[1])
            if stage == "vae":
                system.vae.load_state_dict(subtree(sd, "vae."), strict=True)
            else:
                system.load_state_dict(sd, strict=True)
            logger.info(f"resumed from epoch {start_epoch}")

    def save(epoch_mark: int) -> str:
        # the stage-2 checkpoints carry the frozen VAE too, as the
        # reference's stage-2 checkpoints do
        sd = system.state_dict()
        if stage == "vae":
            sd = {k: v for k, v in sd.items() if k.startswith("vae.")}
        return save_checkpoint(ckpt_dir, epoch_mark, sd)

    def step(batch):
        if stage == "vae":
            return vae_train_step(system, optimizer, batch, gen)
        batch["text_emb"] = embedder(batch.pop("text")).to(dev)
        if stage == "distill":
            return distill_train_step(system, teacher, optimizer, batch,
                                      uncond, student_steps, gen)
        fn = (diffusion_train_step if stage == "diffusion"
              else vae_diffusion_train_step)
        return fn(system, optimizer, batch, uncond, gen)

    pin = dev.type == "cuda"

    def prepare_batch(batch: dict, stop=None):
        """The per-step host pipeline (on the prefetch thread): numpy ->
        pinned host tensors -> asynchronous copies to the device on the
        current stream.  Returns None without copying once ``stop`` (the
        prefetcher's stop event) is set."""
        if stop is not None and stop.is_set():
            return None
        out = {}
        for key in ("motion", "length"):
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            if key == "length":
                t = t.long()
            out[key] = (t.pin_memory() if pin else t).to(dev,
                                                          non_blocking=True)
        if stage != "vae":
            out["text"] = list(batch["text"])
        return out

    from ladiff_torch.utils.logger import MetricsLogger
    metrics_sink = MetricsLogger.from_cfg(cfg)
    end_epoch = (max_epochs if max_epochs is not None
                 else int(cfg.TRAIN.END_EPOCH))
    save_every = int(cfg.LOGGER.get("SACE_CHECKPOINT_EPOCH", 200))
    bs = int(cfg.TRAIN.BATCH_SIZE)
    prefetch = int(cfg.TRAIN.get("PREFETCH", 2))
    buckets = cfg.TRAIN.get("LENGTH_BUCKETS", None)
    buckets = tuple(buckets) if buckets else None

    with PreemptionGuard() as guard:
        for epoch in range(start_epoch, end_epoch):
            t0 = time.time()
            losses = []
            loader = dm.loader("train", batch_size=bs, seed=epoch,
                               buckets=buckets)
            batches = (HostPrefetcher(loader, prepare_batch, depth=prefetch)
                       if prefetch > 0 else map(prepare_batch, loader))
            try:
                for i, batch in enumerate(batches):
                    if max_steps_per_epoch and i >= max_steps_per_epoch:
                        break
                    if guard.triggered:
                        break
                    losses.append(step(batch))
            finally:
                if isinstance(batches, HostPrefetcher):
                    batches.close()
            if guard.triggered:
                # mark the checkpoint with the current epoch, so a resume
                # runs this epoch again from its start
                path = save(epoch)
                logger.info(f"preemption signal: saved {path} mid-epoch "
                            f"{epoch}, exiting cleanly")
                metrics_sink.close()
                return ckpt_dir
            if losses:
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
                logger.info(f"saved checkpoint {save(epoch + 1)}")
    metrics_sink.close()
    return ckpt_dir
