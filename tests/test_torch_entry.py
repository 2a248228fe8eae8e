"""The PyTorch port's training entry point on the CPU: configuration, data,
loop, checkpoints, ``ladiff_torch.train`` and ``ladiff_torch.demo``.

  * ``assemble_config`` gives the JAX package's tree for every published
    ``configs/config_*.yaml``; the synthetic dataset and the loader's
    batches (with and without length buckets) are the JAX package's;
  * ``run_training(device="cpu")`` at a 3-layer, d-128 configuration writes
    ``epoch_N.ckpt`` files that load with ``strict=True``; a resume starts
    at the saved epoch; stage 2 boots its VAE from them and keeps it frozen;
  * ``demo.main`` writes the samples;
  * the ``HostPrefetcher`` / ``PreemptionGuard`` cases of
    ``tests/test_prefetch.py`` and ``tests/test_preemption.py``, run against
    the port, and training is bit-identical with prefetching on or off;
  * the port's entry modules import without JAX.
"""
import glob
import logging
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ladiff_torch.config import assemble_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, "configs", "config_*.yaml")))


def _cfg(name, **over):
    return assemble_config(os.path.join(REPO, "configs", name),
                           os.path.join(REPO, "configs", "assets.yaml"),
                           overrides=over or None)


def _small_overrides(tmp_path, **over):
    """Overrides that cut a published configuration to 3 layers, d 128,
    ff 256, 2 heads on the synthetic dataset under tmp_path (made here),
    with ``over`` merged on top."""
    from ladiff_torch.config import merge
    from ladiff_torch.data.synthetic import generate_synthetic_dataset
    data = str(tmp_path / "data")
    if not os.path.isdir(data):
        generate_synthetic_dataset(data, n_clips=40, seed=0)
    layers = {"params": {"num_layers": 3}}
    return merge({"DEBUG": False, "FOLDER": str(tmp_path / "experiments"),
                  "NAME": "cli", "TRAIN": {"BATCH_SIZE": 8},
                  "DATASET": {"HUMANML3D": {"ROOT": data}},
                  "model": {"num_layers": 3, "ff_size": 256, "num_head": 2,
                            "latent_dim": [7, 128], "motion_vae": layers,
                            "denoiser": layers},
                  "LOGGER": {"TENSORBOARD": False}}, over).to_dict()


def _small(tmp_path, name="config_vae_humanml3d.yaml", exp="exp", model=None,
           **train):
    """A published configuration cut by ``_small_overrides``, 2 epochs, a
    checkpoint per epoch; ``train`` goes into its TRAIN section, ``model``
    (narrower widths) into its model section."""
    return _cfg(name, **_small_overrides(
        tmp_path, NAME=exp, TRAIN={"END_EPOCH": 2, **train},
        LOGGER={"SACE_CHECKPOINT_EPOCH": 1}, model=model or {}))


def _logger(cfg):
    from ladiff_torch.utils.logger import create_logger
    logger = create_logger(cfg, phase="train")
    logger.setLevel(logging.WARNING)
    return logger


def _text_encoder(texts):
    """Pooled text features of each caption from a hash of it."""
    out = [np.random.RandomState(abs(hash(t)) % 2 ** 31).randn(1, 768)
           for t in texts]
    return torch.as_tensor(np.stack(out).astype(np.float32))


# -- configuration and data -------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_assemble_config_matches_jax(name):
    from ladiff_tpu.config import assemble_config as jax_assemble
    want = jax_assemble(os.path.join(REPO, "configs", name),
                        os.path.join(REPO, "configs", "assets.yaml"))
    assert _cfg(name).to_dict() == want.to_dict()


def test_loss_weights_from_cfg_match_jax():
    from ladiff_torch.losses.mld import LossWeights
    from ladiff_tpu.losses.mld import LossWeights as JW
    for name in ("config_vae_humanml3d.yaml", "config_ladiff_kit.yaml"):
        got, want = LossWeights.from_cfg(_cfg(name)), JW.from_cfg(_cfg(name))
        assert got.__dict__ == want.__dict__
    with pytest.raises(ValueError, match="LAMBDA_PRIOR"):
        LossWeights.from_cfg(_cfg("config_vae_humanml3d.yaml",
                                  LOSS={"LAMBDA_PRIOR": 1.0}))


def test_synthetic_dataset_matches_jax(tmp_path):
    from ladiff_torch.data.synthetic import generate_synthetic_dataset
    from ladiff_tpu.data.synthetic import generate_synthetic_dataset as jgen
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    generate_synthetic_dataset(a, n_clips=12, seed=3)
    jgen(b, n_clips=12, seed=3)
    files = sorted(os.path.relpath(p, a) for p in glob.glob(f"{a}/**/*.*",
                                                             recursive=True))
    assert files == sorted(os.path.relpath(p, b) for p in glob.glob(
        f"{b}/**/*.*", recursive=True))
    for f in files:
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(a, f)),
                                          np.load(os.path.join(b, f)))
        else:
            assert open(os.path.join(a, f)).read() == \
                open(os.path.join(b, f)).read()


@pytest.mark.parametrize("buckets", [None, (64, 128, 196)])
def test_loader_batches_match_jax(tmp_path, buckets):
    """One synthetic dataset, the same seed: the same batches, key by key,
    from the port's loader and the JAX package's."""
    from ladiff_torch.data.datamodule import T2MDataModule
    from ladiff_torch.data.synthetic import generate_synthetic_dataset
    from ladiff_torch.data.word_vectorizer import HashWordVectorizer
    from ladiff_tpu.data.datamodule import T2MDataModule as JDM
    from ladiff_tpu.data.word_vectorizer import HashWordVectorizer as JHW
    root = generate_synthetic_dataset(str(tmp_path / "d"), n_clips=40,
                                      seed=1)
    got = list(T2MDataModule("humanml3d", root, HashWordVectorizer(),
                             batch_size=8).loader("train", seed=4,
                                                  buckets=buckets))
    want = list(JDM("humanml3d", root, JHW(), batch_size=8).loader(
        "train", seed=4, buckets=buckets))
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def test_get_datasets_synthetic_stand_in(tmp_path, monkeypatch):
    """``LADIFF_SYNTHETIC_DATA=1`` stands in a synthetic HumanML3D of
    ``LADIFF_SYNTHETIC_CLIPS`` clips; without it a missing dataset raises;
    an action dataset stands in a synthetic HumanAct12 (150 features, 25
    joints, 12 classes)."""
    from ladiff_torch.data.datamodule import get_datasets
    monkeypatch.chdir(tmp_path)
    cfg = _cfg("config_vae_humanml3d.yaml")
    monkeypatch.delenv("LADIFF_SYNTHETIC_DATA", raising=False)
    with pytest.raises(FileNotFoundError, match="LADIFF_SYNTHETIC_DATA"):
        get_datasets(cfg)
    monkeypatch.setenv("LADIFF_SYNTHETIC_DATA", "1")
    monkeypatch.setenv("LADIFF_SYNTHETIC_CLIPS", "24")
    dm = get_datasets(cfg)[0]
    assert dm.data_root == os.path.join("datasets", "synthetic_humanml3d_24")
    assert (dm.nfeats, dm.njoints) == (263, 22) == (cfg.DATASET.NFEATS,
                                                    cfg.DATASET.NJOINTS)
    action_cfg = _cfg("config_vae_humanact12.yaml")
    action = get_datasets(action_cfg)[0]
    assert action.is_a2m and action._ds.dataname == "humanact12"
    assert os.path.isfile(os.path.join("datasets", "synthetic_humanact12",
                                       "humanact12poses.pkl"))
    assert (action.nfeats, action.njoints, action.num_classes) == (
        150, 25, 12) == (action_cfg.DATASET.NFEATS, action_cfg.DATASET.NJOINTS,
                         action_cfg.DATASET.NCLASSES)


# -- the system and the loop's options --------------------------------------

def test_build_system_options(tmp_path, monkeypatch):
    """float32 compute on the GPU (TRAIN.MIXED_PRECISION false) builds a
    float32 system there, as on the CPU; LADIFF_TRAIN_WHOLE_LAYER is read
    here; the parameters are float32 and seeded from SEED_VALUE;
    unsupported configurations raise."""
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.training import loop
    from ladiff_torch.training.loop import build_system
    cfg = _small(tmp_path)
    dm = get_datasets(cfg)[0]
    seen = {}
    with monkeypatch.context() as m:
        # no card here: the device is taken as named and nothing is built
        m.setattr(loop, "resolve_device", torch.device)
        m.setattr(LADiffSystem, "from_cfg",
                  classmethod(lambda cls, c, **kw: seen.update(kw)))
        build_system(cfg, dm, device="cuda")
    assert seen["device"] == torch.device("cuda")
    assert (seen["dtype"], seen["param_dtype"]) == (torch.float32,
                                                    torch.float32)
    monkeypatch.setenv("LADIFF_TRAIN_WHOLE_LAYER", "enc")
    a = build_system(cfg, dm, device="cpu")
    assert a.vae.encoder.middle_block.whole_layer
    assert not a.vae.decoder.middle_block.whole_layer
    monkeypatch.delenv("LADIFF_TRAIN_WHOLE_LAYER")
    b = build_system(cfg, dm, device="cpu")
    assert not b.vae.encoder.middle_block.whole_layer
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a.vae.final_layer.weight.dtype == torch.float32
    assert a.dtype == torch.float32 and a.weights.lambda_kl == 1e-4
    novae = _cfg("config_novae_humanml3d.yaml")
    c = LADiffSystem.from_cfg(novae, nfeats=263, njoints=22, device="cpu")
    assert c.vae is None and not c.md_trans
    assert not any(k.startswith("vae.") for k in c.state_dict())


@pytest.mark.parametrize("name,train,match", [
    ("config_vae_humanml3d.yaml", {"TENSOR_PARALLEL": 3}, "must divide"),
    ("config_ladiff_humanml3d.yaml", {"SEQUENCE_PARALLEL": 2},
     "vae only"),
    ("config_vae_humanml3d.yaml", {"PIPELINE_STAGES": 2}, "diffusion only"),
    ("config_vae_humanml3d.yaml", {"FSDP": True, "TENSOR_PARALLEL": 2},
     "mutually exclusive"),
    ("config_novae_humanml3d.yaml", {"PIPELINE_STAGES": 2}, "MD_TRANS"),
    ("config_vae_humanml3d.yaml", {"STAGE": "distill"},
     "distill needs TRAIN.PRETRAINED"),
    ("config_vae_humanml3d.yaml", {"RNG_IMPL": "philox"}, "RNG_IMPL")])
def test_run_training_refuses_what_it_does_not_run(tmp_path, monkeypatch,
                                                    name, train, match):
    """The JAX package's refusals for the same configuration, in a world of
    two ranks (``TENSOR_PARALLEL`` 3 does not divide it)."""
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.parallel import mesh
    from ladiff_torch.training.loop import run_training
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    cfg = _small(tmp_path, name, **train)
    dm = get_datasets(cfg)[0]
    with pytest.raises((NotImplementedError, ValueError), match=match):
        run_training(cfg, dm, _logger(cfg), text_encoder=_text_encoder,
                     device="cpu")


# -- training, checkpoints, resume, stage 2, demo ---------------------------

def test_training_checkpoints_resume_and_stage2(tmp_path, caplog):
    """Stage 1 for 2 epochs writes epoch_1.ckpt and epoch_2.ckpt (``vae.*``
    only, loading strictly); the resume runs only epoch 2 and writes
    epoch_3.ckpt; stage 2 boots the VAE from the directory, keeps it frozen
    and saves both trees; ``train.main`` runs the same from the command
    line."""
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.training.loop import run_training
    from ladiff_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint, subtree)
    cfg = _small(tmp_path)
    dm = get_datasets(cfg)[0]
    ckpt_dir = run_training(cfg, dm, _logger(cfg), max_steps_per_epoch=2,
                            device="cpu")
    assert sorted(os.listdir(ckpt_dir)) == ["epoch_1.ckpt", "epoch_2.ckpt"]
    epoch, sd = load_checkpoint(os.path.join(ckpt_dir, "epoch_2.ckpt"))
    assert epoch == 2 and all(k.startswith("vae.") for k in sd)
    fresh = LADiffSystem.from_cfg(cfg, nfeats=263, njoints=22, device="cpu")
    fresh.vae.load_state_dict(subtree(sd, "vae."), strict=True)
    _, sd1 = load_checkpoint(os.path.join(ckpt_dir, "epoch_1.ckpt"))
    assert not all(torch.equal(sd[k], sd1[k]) for k in sd)

    cfg = _small(tmp_path, RESUME="yes", END_EPOCH=3)
    logger = _logger(cfg)
    logger.setLevel(logging.INFO)
    logger.addHandler(caplog.handler)
    run_training(cfg, dm, logger, max_steps_per_epoch=1, device="cpu")
    log = caplog.text
    assert "resumed from epoch 2" in log
    assert "epoch 2 [vae]" in log and "epoch 1 [vae]" not in log
    assert latest_checkpoint(ckpt_dir)[0] == 3

    cfg2 = _small(tmp_path, "config_ladiff_humanml3d.yaml", exp="stage2",
                  PRETRAINED_VAE=ckpt_dir, END_EPOCH=1)
    ck2 = run_training(cfg2, get_datasets(cfg2)[0], _logger(cfg2),
                       text_encoder=_text_encoder, max_steps_per_epoch=2,
                       device="cpu")
    _, sd2 = load_checkpoint(latest_checkpoint(ck2)[1])
    _, sd3 = load_checkpoint(latest_checkpoint(ckpt_dir)[1])
    assert all(torch.equal(sd2[k], v) for k, v in sd3.items())
    full = LADiffSystem.from_cfg(cfg2, nfeats=263, njoints=22, device="cpu")
    full.load_state_dict(sd2, strict=True)
    assert any(k.startswith("denoiser.") for k in sd2)


def test_train_and_demo_entry_points(tmp_path):
    """``ladiff_torch.train.main`` trains stage 2 from the command line;
    ``ladiff_torch.demo.main`` loads its newest checkpoint and writes per
    sample finite joints [length, 22, 3] and the caption, with
    ``--replication 2 --allinone`` the grouped file too; ``--latentwise_gen``
    and ``--plot_att_map`` run from the same checkpoint."""
    from ladiff_torch import demo, train
    cfg = os.path.join(REPO, "configs", "config_ladiff_humanml3d.yaml")
    ckpt_dir = train.main(
        ["--cfg", cfg, "--cpu"], text_encoder=_text_encoder,
        max_steps_per_epoch=1, overrides=_small_overrides(
            tmp_path, TRAIN={"END_EPOCH": 1, "PRETRAINED_VAE": ""}))
    assert os.listdir(ckpt_dir) == ["epoch_1.ckpt"]
    over = _small_overrides(
        tmp_path, TEST={"CHECKPOINTS": ckpt_dir},
        model={"scheduler": {"num_inference_timesteps": 3}})
    out = demo.main(["--cfg", cfg, "--cpu", "--replication", "2",
                     "--allinone", "--out_dir", str(tmp_path / "samples")],
                    text_encoder=_text_encoder, overrides=over)
    for i, (n, text) in enumerate(demo.DEFAULT_EXAMPLES):
        for rep in ("", "_rep1"):
            joints = np.load(os.path.join(out, f"sample_{i:03d}{rep}.npy"))
            assert joints.shape == (n, 22, 3) and np.isfinite(joints).all()
            assert open(os.path.join(out, f"sample_{i:03d}{rep}.txt")
                        ).read() == text + "\n"
    assert np.load(os.path.join(out, "text_motion_all.npy")).shape == \
        (3, 2, 196, 22, 3)
    for flag in (["--latentwise_gen", "fw"], ["--plot_att_map"]):
        out = demo.main(["--cfg", cfg, "--cpu", *flag, "--out_dir",
                         str(tmp_path / flag[0][2:])],
                        text_encoder=_text_encoder, overrides=over)
        n = len(demo.DEFAULT_EXAMPLES) * (5 if "fw" in flag else 1)
        assert sorted(os.listdir(out)) == sorted(
            f"sample_{i:03d}.{ext}" for i in range(n) for ext in ("npy",
                                                                  "txt"))


# -- HostPrefetcher and PreemptionGuard (tests/test_prefetch.py and
#    tests/test_preemption.py against the port) -----------------------------

def test_prefetcher_preserves_order_and_values():
    from ladiff_torch.training.loop import HostPrefetcher
    items = list(range(57))
    pf = HostPrefetcher(iter(items), lambda x: x * 2, depth=3)
    assert list(pf) == [x * 2 for x in items]


@pytest.mark.parametrize("where", ["iterator", "prepare"])
def test_prefetcher_propagates_errors(where):
    from ladiff_torch.training.loop import HostPrefetcher

    def gen():
        yield 1
        raise RuntimeError("boom")

    def prep(x):
        if x == 3:
            raise ValueError("bad batch")
        return x

    if where == "iterator":
        pf, err = HostPrefetcher(gen(), lambda x: x, depth=2), RuntimeError
    else:
        pf, err = HostPrefetcher(iter(range(10)), prep, depth=2), ValueError
    out = []
    with pytest.raises(err):
        for v in pf:
            out.append(v)
    assert out[:1] == [1] if where == "iterator" else out == [0, 1, 2]


def test_prefetcher_close_midstream_does_not_deadlock():
    from ladiff_torch.training.loop import HostPrefetcher
    pf = HostPrefetcher(iter(range(1000)), lambda x: x, depth=1)
    assert next(pf) == 0
    t0 = time.time()
    pf.close()
    assert time.time() - t0 < 5.0
    assert not pf._thread.is_alive()


def test_prefetcher_stop_aware_prepare_exits_promptly():
    from ladiff_torch.training.loop import HostPrefetcher
    entered = []

    def prep(x, stop):
        entered.append(x)
        for _ in range(100):
            if stop.is_set():
                return None
            time.sleep(0.02)
        return x

    pf = HostPrefetcher(iter(range(100)), prep, depth=1)
    assert pf._pass_stop
    time.sleep(0.1)
    t0 = time.time()
    pf.close()
    assert time.time() - t0 < 1.0
    assert not pf._thread.is_alive()
    assert entered[0] == 0
    one = HostPrefetcher(iter(range(5)), lambda x: x + 1, depth=2)
    assert not one._pass_stop and list(one) == [1, 2, 3, 4, 5]


def test_training_identical_with_and_without_prefetch(tmp_path):
    """Two stage-1 runs of 2 epochs x 2 steps (3 layers, d 64, ff 128),
    with prefetching off and at depth 2, end with equal parameters."""
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.training.loop import run_training
    from ladiff_torch.utils.checkpoint import latest_checkpoint, \
        load_checkpoint
    states = []
    for prefetch in (0, 2):
        cfg = _small(tmp_path, exp=f"pf{prefetch}", PREFETCH=prefetch,
                     model={"latent_dim": [7, 64], "ff_size": 128})
        ckpt = run_training(cfg, get_datasets(cfg)[0], _logger(cfg),
                            max_steps_per_epoch=2, device="cpu")
        states.append(load_checkpoint(latest_checkpoint(ckpt)[1])[1])
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


def test_guard_sets_flag_and_restores_handler():
    from ladiff_torch.training.loop import PreemptionGuard
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered
    assert signal.getsignal(signal.SIGTERM) is prev


def test_sigterm_checkpoints_and_exits(tmp_path):
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.training.loop import run_training
    cfg = _small(tmp_path, exp="preempt", END_EPOCH=500)
    cfg.LOGGER.SACE_CHECKPOINT_EPOCH = 500
    dm = get_datasets(cfg)[0]
    stop = threading.Event()

    def send_once_guarded():
        while not stop.is_set():
            h = signal.getsignal(signal.SIGTERM)
            if getattr(h, "__self__", None).__class__.__name__ == \
                    "PreemptionGuard":
                os.kill(os.getpid(), signal.SIGTERM)
                return
            stop.wait(0.2)

    sender = threading.Thread(target=send_once_guarded, daemon=True)
    sender.start()
    try:
        ckpt_dir = run_training(cfg, dm, _logger(cfg), max_steps_per_epoch=2,
                                device="cpu")
    finally:
        stop.set()
        sender.join(timeout=5)
    epochs = [int(n[len("epoch_"):-len(".ckpt")])
              for n in os.listdir(ckpt_dir)]
    assert epochs and max(epochs) < 500


def test_entry_modules_import_without_jax():
    """The port's entry modules in a fresh interpreter where importing jax
    or ladiff_tpu fails."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'ladiff_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import ladiff_torch.train, ladiff_torch.demo\n"
        "import ladiff_torch.training.loop, ladiff_torch.data.datamodule\n"
        "import ladiff_torch.ops.train_layer, "
        "ladiff_torch.ops.train_decoder_layer\n"
        "assert not any(m.split('.')[0] in ('jax', 'ladiff_tpu') "
        "for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
