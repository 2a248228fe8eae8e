"""The port's T2M evaluation protocol against the JAX package's on the CPU:
``eval_step`` against ``make_eval_step`` and ``run_test`` (the port's
through its entry point ``ladiff_torch.test.main``) against the root
``test.py``'s, in both stages, on 400 synthetic clips (46 test clips, more
than the 32 of an R-precision group: batches of 30 and 16) with a 3-layer
d-64 system, DDIM-5, the same converted weights, the same evaluators (one
``finest.tar`` and one set of evaluator stats that both packages load),
the same caption features, and the JAX package's noise replayed on the
port's side.

Tolerances: embeddings, joints and latents 1e-4 norm-wise; the metrics
FID 1e-2 relative, other continuous metrics 1e-3 relative, the rank
metrics (R-precision) equal.  Also the ``COUNT_TIME`` / ``SAVE_LATENTS``
files, the release gate's dry run and the refusals."""
import hashlib
import importlib.util
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ladiff_torch.test as port_test
from ladiff_torch.convert import system_state_dict
from ladiff_torch.utils.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, BS, N_REP_MM, D, STEPS = 1234, 30, 6, 64, 5
EMB_TOL, FID_TOL, METRIC_TOL = 1e-4, 1e-2, 1e-3
RANK_METRICS = ("R_precision", "gt_R_precision")


def relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class CaptionFeatures:
    """A deterministic stand-in for CLIP: each caption -> [1, 768]."""

    def __call__(self, texts):
        out = np.zeros((len(texts), 1, 768), np.float32)
        for i, t in enumerate(texts):
            seed = int.from_bytes(hashlib.sha256(t.encode()).digest()[:4],
                                  "little")
            out[i, 0] = np.random.RandomState(seed).randn(768)
        return out


def randomize(tree, seed):
    """Non-trivial params of the tree's shapes: the zero-initialized
    projections would otherwise make every generated motion alike."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name, shape = str(path[-1].key), np.shape(a)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name in ("bias", "in_proj_bias"):
            return (0.05 * rng.randn(*shape)).astype(np.float32)
        if name == "pe":
            return rng.rand(*shape).astype(np.float32)
        fan_in = shape[0] if len(shape) == 2 else 1
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_run_test():
    """``run_test`` of the root ``test.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "ladiff_tpu_test_entry", os.path.join(REPO, "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_test


def overrides(root, stage, **test):
    layers = {"params": {"num_layers": 3}}
    return {"DEBUG": False, "FOLDER": str(root / "experiments"),
            "NAME": f"eval_{stage}",
            "DATASET": {"HUMANML3D": {"ROOT": str(root / "data")}},
            "TEST": {"BATCH_SIZE": BS, "REPLICATION_TIMES": 2,
                     "MM_NUM_SAMPLES": 5, "MM_NUM_REPEATS": N_REP_MM,
                     "MM_NUM_TIMES": 4,
                     "CHECKPOINTS": str(root / f"ckpt_{stage}"), **test},
            "METRIC": {"TYPE": ["TemosMetric", "TM2TMetrics", "MRMetrics",
                                "UncondMetrics"]},
            "model": {"num_layers": 3, "ff_size": 128, "num_head": 2,
                      "latent_dim": [7, D], "motion_vae": layers,
                      "denoiser": layers, "t2m_path": str(root / "t2m"),
                      "scheduler": {"num_inference_timesteps": STEPS}},
            "LOGGER": {"TENSORBOARD": False}}


def cfg_name(stage):
    return ("config_vae_humanml3d.yaml" if stage == "vae"
            else "config_ladiff_humanml3d.yaml")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Data, evaluator assets and weights shared by both packages: the
    system's params randomized at the JAX package's shapes; the
    evaluators' ``finest.tar`` (the reference's names, PyTorch's default
    initialization) and feature stats, which both packages load."""
    from ladiff_torch.data.synthetic import generate_synthetic_dataset
    from ladiff_torch.evaluation.t2m_eval import T2MEvaluator
    from ladiff_tpu.config import assemble_config
    from ladiff_tpu.data.datamodule import get_datasets
    from ladiff_tpu.training.loop import build_system

    root = tmp_path_factory.mktemp("eval")
    generate_synthetic_dataset(str(root / "data"), n_clips=400, seed=0)
    model_dir = root / "t2m" / "t2m" / "text_mot_match" / "model"
    meta = root / "t2m" / "t2m" / "Comp_v6_KLD01" / "meta"
    os.makedirs(model_dir)
    os.makedirs(meta)
    ev = T2MEvaluator.random_init(263, torch.Generator().manual_seed(5),
                                  "cpu")
    torch.save({"text_encoder": ev.text.state_dict(),
                "movement_encoder": ev.movement.state_dict(),
                "motion_encoder": ev.motion.state_dict()},
               str(model_dir / "finest.tar"))
    rng = np.random.RandomState(6)
    np.save(meta / "mean.npy", (0.1 * rng.randn(263)).astype(np.float32))
    np.save(meta / "std.npy", (0.8 + 0.4 * rng.rand(263)).astype(np.float32))

    cfg = assemble_config(os.path.join(REPO, "configs", cfg_name("diffusion")),
                          os.path.join(REPO, "configs", "assets.yaml"),
                          overrides(root, "diffusion"))
    dm = get_datasets(cfg, phase="test")[0]
    system = build_system(cfg, dm)
    params = randomize(jax.eval_shape(system.init_params,
                                      jax.random.PRNGKey(0)), 1)
    sd = system_state_dict(params)
    save_checkpoint(str(root / "ckpt_diffusion"), 3, sd)
    # a stage-1 checkpoint: the VAE only
    save_checkpoint(str(root / "ckpt_vae"), 2,
                    {k: v for k, v in sd.items() if k.startswith("vae.")})
    return {"root": root, "params": params, "jdm": dm, "jsystem": system,
            "finest": str(model_dir / "finest.tar")}


def noise_replay(stage):
    """The JAX ``run_test``'s noise chain: ``SEED_VALUE`` split once per
    batch, drawn at the padded batch (``TEST.BATCH_SIZE``; the
    MultiModality pass's ``MM_NUM_REPEATS`` rows are not padded), trimmed to
    the batch's rows."""
    state = {"rng": jax.random.PRNGKey(SEED), "calls": []}

    def draw(generator, n, system):
        state["rng"], key = jax.random.split(state["rng"])
        if stage == "diffusion":
            key = jax.random.split(key)[0]
        rows = n if n == N_REP_MM else BS
        state["calls"].append(n)
        z = jax.random.normal(key, (rows, system.max_it,
                                    system.latent_dim[-1]), jnp.float32)
        return torch.from_numpy(np.asarray(z)[:n].copy())

    return draw, state


def port_system(cfg_stage, env):
    from ladiff_torch.config import assemble_config
    from ladiff_torch.data.datamodule import get_datasets
    from ladiff_torch.training.loop import build_system
    cfg = assemble_config(
        os.path.join(REPO, "configs", cfg_name(cfg_stage)),
        os.path.join(REPO, "configs", "assets.yaml"),
        overrides(env["root"], cfg_stage))
    dm = get_datasets(cfg, phase="test")[0]
    system = build_system(cfg, dm, device="cpu")
    system.load_state_dict(system_state_dict(env["params"]), strict=True)
    return system, dm


@pytest.mark.parametrize("stage", ["diffusion", "vae"])
def test_eval_step_matches_jax(env, stage):
    """One batch of 14 with lengths from the test split (1 to 5 valid
    latents): the JAX noise passed in (``init_latents`` / ``eps``)."""
    from ladiff_torch.evaluation.t2m_eval import T2MEvaluator, eval_step
    from ladiff_tpu.evaluation.t2m_eval import T2MEvaluator as JaxEvaluator
    from ladiff_tpu.evaluation.t2m_eval import make_eval_step

    system, dm = port_system(stage, env)
    batch = next(iter(dm.loader("test", batch_size=14, shuffle=True,
                                seed=0)))
    feats = CaptionFeatures()
    cond = feats(list(batch["text"]))
    uncond = np.repeat(feats([""]), len(cond), 0)
    key = jax.random.PRNGKey(21)
    jdm = env["jdm"]
    jev = JaxEvaluator.from_checkpoint(env["finest"], 263)
    step = make_eval_step(env["jsystem"], jev, jdm.mean_eval,
                          jdm.std_eval, stage=stage)
    jb = {k: jnp.asarray(batch[k]) for k in ("motion", "length",
                                             "word_embs", "pos_ohot",
                                             "text_len")}
    want = jax.device_get(step(env["params"], jb, jnp.asarray(cond),
                               jnp.asarray(uncond), key))
    shape = (len(cond), 5, D)
    if stage == "diffusion":
        noise = {"init_latents": jax.random.normal(
            jax.random.split(key)[0], shape, jnp.float32)}
    else:
        noise = {"eps": jax.random.normal(key, shape, jnp.float32)}
    tev = T2MEvaluator.from_checkpoint(env["finest"], 263, "cpu")
    got = eval_step(system, tev, port_test._tensors(batch),
                    torch.from_numpy(cond), torch.from_numpy(uncond), stage,
                    mean_eval=dm.mean_eval, std_eval=dm.std_eval,
                    **{k: torch.from_numpy(np.array(v))
                       for k, v in noise.items()})
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(dm.mean_eval, jdm.mean_eval)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert relerr(got[k].numpy(), want[k]) <= EMB_TOL, k
    assert relerr(got["lat_rm"].numpy(), got["lat_m"].numpy()) > 1e-2


@pytest.fixture(scope="module", params=["diffusion", "vae"])
def both_runs(request, env):
    """Both packages' ``run_test`` at 2 replications on one stage, with
    ``COUNT_TIME`` and ``SAVE_LATENTS`` on."""
    from ladiff_tpu.config import assemble_config
    stage, root = request.param, env["root"]
    mp = pytest.MonkeyPatch()
    try:
        extra = {"COUNT_TIME": True, "SAVE_LATENTS": True}
        cfg = assemble_config(
            os.path.join(REPO, "configs", cfg_name(stage)),
            os.path.join(REPO, "configs", "assets.yaml"),
            overrides(root, stage, LATENTS_DIR=str(root / f"jlat_{stage}"),
                      **extra))
        cfg["FOLDER_EXP"] = str(root / f"jout_{stage}")
        os.makedirs(cfg.FOLDER_EXP)
        logger = logging.getLogger(f"jax_eval_{stage}")
        want = jax_run_test()(cfg, logger, text_encoder=CaptionFeatures(),
                              params=env["params"])
        draw, state = noise_replay(stage)
        mp.setattr(port_test, "draw_noise", draw)
        over = overrides(root, stage, LATENTS_DIR=str(root / f"lat_{stage}"),
                         **extra)
        over["NAME"] = f"port_{stage}"
        got = port_test.main(
            ["--cfg", os.path.join(REPO, "configs", cfg_name(stage)),
             "--cpu", "--replication", "2"],
            text_encoder=CaptionFeatures(), overrides=over)
    finally:
        mp.undo()
    out_dir = root / "experiments" / "ladiff" / f"port_{stage}"
    return {"stage": stage, "want": want, "got": got, "calls": state["calls"],
            "out_dir": out_dir, "root": root}


def test_run_test_matches_jax(both_runs):
    want, got = both_runs["want"], both_runs["got"]
    assert sorted(got) == sorted(want)
    assert "FID" in got and "Matching_score" in got and "MPJPE" in got
    assert ("MultiModality" in got) == (both_runs["stage"] == "diffusion")
    for key, (w, wc) in want.items():
        g, gc = got[key]
        assert np.isfinite(g) and np.isfinite(gc), key
        if key.startswith(RANK_METRICS):
            assert g == w and gc == wc, (key, g, w)
        else:
            tol = FID_TOL if "FID" in key else METRIC_TOL
            # KID's σ over subsets that are each the whole split is zero
            # but for rounding: it is held at the scale of KID's mean
            scale = abs(want["uncond_KID_mean"][0] if key ==
                        "uncond_KID_std" else w)
            assert abs(g - w) <= tol * scale, (key, g, w)


def test_run_test_noise_and_files(both_runs):
    """One noise draw per batch: 2 replications x (30 + 16 rows), then
    (stage ``diffusion``) 5 MultiModality captions x 6 repeats each; the
    per-batch seconds in ``times.txt``, the vae stage's latents as
    ``latent_<n>.npy`` equal to the JAX package's, ``metrics_<stamp>.json``
    with the summary."""
    stage, root = both_runs["stage"], both_runs["root"]
    per_rep = [30, 16] if stage == "vae" else [30, 16] + [N_REP_MM] * 5
    assert sorted(both_runs["calls"]) == sorted(per_rep * 2)
    with open(both_runs["out_dir"] / "times.txt") as f:
        times = [float(line) for line in f]
    assert len(times) == 4 and all(t > 0 for t in times)
    [path] = [p for p in os.listdir(both_runs["out_dir"])
              if p.startswith("metrics_")]
    with open(both_runs["out_dir"] / path) as f:
        saved = json.load(f)
    assert {k: (v["mean"], v["conf"]) for k, v in saved.items()} == \
        both_runs["got"]
    lat = root / f"lat_{stage}"
    if stage == "diffusion":
        assert not lat.exists()
        return
    names = sorted(os.listdir(lat))
    assert names == [f"latent_{i:06d}.npy" for i in range(4)]
    for name in names:
        z, zj = np.load(lat / name), np.load(root / f"jlat_{stage}" / name)
        assert z.shape == zj.shape and z.shape[1:] == (5, D)
        assert relerr(z, zj) <= EMB_TOL


def test_verify_release_dry_run(tmp_path, monkeypatch, capsys):
    """``python -m ladiff_torch.verify_release --dry-run --tiny --cpu``
    against the paper's table: the deps audit, 400 synthetic clips, random
    weights, one replication, a row per paper metric and the FID gate's
    verdict (FAIL for random weights: exit code 1)."""
    from ladiff_torch import verify_release
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LADIFF_SYNTHETIC_DATA", "1")
    monkeypatch.setenv("LADIFF_SYNTHETIC_CLIPS", "400")
    expected = os.path.join(REPO, "scripts", "paper_humanml3d.json")
    rc = verify_release.main(
        ["--dry-run", "--tiny", "--cpu", "--expected", expected,
         "--folder", str(tmp_path / "exp")], text_encoder=CaptionFeatures())
    out = capsys.readouterr().out
    assert rc == 1
    assert "[MISSING] T2M evaluators" in out
    with open(expected) as f:
        keys = [k for k in json.load(f) if not k.startswith("_")]
    for key in keys:
        assert f"{key:>24s}: " in out.split("==== vs expected ====")[1]
    assert "FID gate (|Δ| <= 2%): FAIL" in out
    rows, ok = verify_release.compare({"FID": (0.1131, 0.0)},
                                      {"FID": 0.113, "_note": "x"}, 0.02)
    assert ok and len(rows) == 1


def test_release_checkpoint_loads_by_name(env, tmp_path):
    """A released Lightning checkpoint (``state_dict`` with ``vae.*``,
    ``denoiser.*`` and other entries) gives the system's keys."""
    from ladiff_torch import verify_release
    sd = system_state_dict(env["params"])
    path = str(tmp_path / "released.ckpt")
    torch.save({"state_dict": {**sd, "text_encoder.w": torch.zeros(1)},
                "epoch": 1999}, path)
    system, _ = port_system("diffusion", env)
    got = verify_release.release_state_dict(path)
    assert set(got) == set(system.state_dict())
    system.load_state_dict(got, strict=True)


def test_refusals(env):
    """The action-conditioned metrics read an action dataset: on a text
    dataset they raise, naming it; feature-space diffusion has no stage
    ``vae``."""
    from ladiff_torch.config import assemble_config
    from ladiff_torch.evaluation.t2m_eval import eval_step
    cfg = assemble_config(
        os.path.join(REPO, "configs", cfg_name("diffusion")),
        os.path.join(REPO, "configs", "assets.yaml"),
        {**overrides(env["root"], "diffusion"),
         "METRIC": {"TYPE": ["HUMANACTMetrics"]}})
    with pytest.raises(ValueError, match="action dataset.*humanml3d"):
        port_test.run_test(cfg, logging.getLogger("a2m"), device="cpu")

    class FeatureSpace:
        vae_type, vae = "no", None

    with pytest.raises(NotImplementedError, match="no VAE"):
        eval_step(FeatureSpace(), None, {}, None, None, "vae", mean_eval=0,
                  std_eval=1)
