"""The port's training layouts (``training/trainer.py``
``make_parallel_step``, ``parallel/pp.py``) against the JAX package's
single-device step, on the CPU: data parallelism (``DistributedDataParallel``
over the ``data`` dim) in every stage (vae, diffusion, vae_diffusion,
distill), one autoregressive and one action-family stage-2 step, each at 2
and at 4 ranks; FSDP2 at 2 ranks (its gradients against the one-process
backward in FSDP2's order, and a 3-step AdamW trajectory with each rank's
share of the shards and moments); Megatron TP on a 2 x 2 mesh (and
its table against ``ladiff_tpu.parallel.tp.tp_spec_for``); sequence
parallelism on a 2 x 2 mesh; the pipeline over 3 stages.

The ranks are spawned processes (``tests/torch_parallel_ranks.py``, gloo,
a file-store rendezvous, one intra-op thread each); the JAX side runs here.
Dropout 0, one SGD(1.0) step, so the parameter delta is the gradient; the
port's ranks take their rows of the global batch and of the JAX step's
draws.  Tolerances: the loss within 1e-5 relative (a forward, the same sums
in another order); the gradient norm within 1e-4 relative (the joint
stage's gradient through the joints' integration carries a few 1e-5 of
float32 rounding between the two packages on one device already); the
parameter delta within 5e-4 absolute + 1e-4 relative, the JAX package's own
bound for resharded sums.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_ranks as ranks
from ladiff_torch.convert import flax_state_dict, system_state_dict
from test_torch_modules import randomize

D, H, FF, LAYERS, NFEATS, T, B = 32, 2, 64, 3, 263, 24, 4
LENGTHS = np.array([24, 10, 17, 5], np.int32)
ACTIONS = np.array([[3], [0], [11], [3]], np.int32)
LOSS_TOL, NORM_TOL = 1e-5, 1e-4
ATOL, RTOL = 5e-4, 1e-4
STUDENT_STEPS = 2
ADAM_STEPS = 3
TEXT = dict(nfeats=NFEATS, njoints=22, max_frames=T, latent_dim=[7, D],
            ff_size=FF, num_layers=LAYERS, num_heads=H, frame_per_latent=8,
            num_inference_timesteps=4, guidance_uncondp=0.4)
ACTION = dict(nfeats=150, njoints=25, max_frames=T, latent_dim=[1, D],
              ff_size=FF, num_layers=LAYERS, num_heads=H, max_it=0,
              lad=False, num_inference_timesteps=3, guidance_uncondp=0.5,
              vae_type="actor", md_trans=False, condition="action",
              nclasses=12, vae_num_layers=2)
# case: (stage, system keyword arguments, JAX key)
CASES = {"vae": ("vae", TEXT, 5), "diffusion": ("diffusion", TEXT, 4),
         "vae_diffusion": ("vae_diffusion", TEXT, 4),
         "distill": ("distill", TEXT, 7),
         "ar": ("diffusion", dict(TEXT, ardiff=True), 1),
         "action": ("diffusion", ACTION, 26)}


def t_np(a):
    return np.asarray(a)


def _normal(key, shape):
    return t_np(jax.random.normal(key, shape, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_system(kind):
    """(JAX system, randomized params, the port's keyword arguments)."""
    from ladiff_tpu.models.ladiff import LADiffSystem
    kw = dict(ACTION if kind == "action" else
              dict(TEXT, ardiff=True) if kind == "ar" else TEXT)
    kw["latent_dim"] = tuple(kw["latent_dim"])
    rng = np.random.RandomState(11)
    nf = kw["nfeats"]
    mean = (0.1 * rng.randn(nf)).astype(np.float32) if nf == NFEATS \
        else np.zeros(nf, np.float32)
    std = (0.5 + rng.rand(nf)).astype(np.float32) if nf == NFEATS \
        else np.ones(nf, np.float32)
    extra = {}
    port = dict(kw, latent_dim=list(kw["latent_dim"]), mean=mean.tolist(),
                std=std.tolist())
    if kind == "action":
        from ladiff_tpu.smpl.body_model import SMPLModel
        from ladiff_tpu.transforms.rotation2xyz import Rotation2xyz
        extra["rot2xyz"] = Rotation2xyz(SMPLModel.synthetic(n_verts=32))
        port["synthetic_smpl"] = 32
    jsys = LADiffSystem(dropout=0.0, mean=jnp.asarray(mean),
                        std=jnp.asarray(std), **kw, **extra)
    params = randomize(jax.eval_shape(jsys.init_params,
                                      jax.random.PRNGKey(0)), 21)
    return jsys, params, port


def _batch(kind):
    rng = np.random.RandomState(3)
    nf = 150 if kind == "action" else NFEATS
    motion = (0.5 * rng.randn(B, T, nf)).astype(np.float32)
    if kind == "action":
        mask = np.arange(T)[None] < LENGTHS[:, None]
        return {"motion": motion * mask[:, :, None], "length": LENGTHS,
                "action": ACTIONS, "mask": mask}
    return {"motion": motion, "length": LENGTHS,
            "text_emb": rng.randn(B, 1, 768).astype(np.float32)}


def _diffusion_draws(key, n_lat=5):
    enc, t_k, n_k, cfg_k, _ = jax.random.split(key, 5)
    return {"eps": _normal(enc, (B, n_lat, D)),
            "noise": _normal(n_k, (B, n_lat, D)),
            "timesteps": t_np(jax.random.randint(t_k, (B,), 0, 1000)),
            "cond_drop": t_np(jax.random.bernoulli(cfg_k, 0.4, (B, 1, 1)))}


def _draws(kind, key, jsys, params):
    """The JAX step's draws from ``key``, by the port's names."""
    if kind == "vae":
        return {"eps": _normal(jax.random.split(key, 3)[0], (B, 5, D))}
    if kind == "diffusion":
        return _diffusion_draws(key)
    if kind == "vae_diffusion":
        vae_k, diff_k, gen_k = jax.random.split(key, 3)
        return {"eps": _normal(jax.random.split(vae_k, 3)[0], (B, 5, D)),
                "diffusion_draws": _diffusion_draws(diff_k),
                "init_latents": _normal(jax.random.split(gen_k)[0],
                                        (B, 5, D))}
    if kind == "distill":
        enc, i_k, n_k, _ = jax.random.split(key, 4)
        return {"i": t_np(jax.random.randint(i_k, (B,), 0, STUDENT_STEPS)),
                "noise": _normal(n_k, (B, 5, D)),
                "eps": _normal(enc, (B, 5, D))}
    if kind == "ar":
        enc, t_k, n_k, cfg_k, _, idx_k, coin_k = jax.random.split(key, 7)
        return {"eps": _normal(enc, (B, 5, D)),
                "noise": _normal(n_k, (B, 1, D)),
                "timesteps": t_np(jax.random.randint(t_k, (B,), 0, 1000)),
                "cond_drop": t_np(jax.random.bernoulli(cfg_k, 0.4,
                                                       (B, 1, 1))),
                "latent_u": t_np(jax.random.uniform(idx_k, (B,))),
                "coin": t_np(jax.random.uniform(coin_k, ()) < 1.0 / 3.0)}
    from test_torch_action import cond_drop_key
    enc, t_k, n_k, cfg_k, _ = jax.random.split(key, 5)
    drop = jax.random.bernoulli(cond_drop_key(
        jsys.denoiser, params["denoiser"], cfg_k), 0.5, (B, 1))
    return {"eps": _normal(enc, (B, D))[:, None],
            "noise": _normal(n_k, (B, 1, D)),
            "timesteps": t_np(jax.random.randint(t_k, (B,), 0, 1000)),
            "cond_drop": t_np(drop).reshape(B, 1, 1)}


def _jax_step(kind):
    """The JAX single-device step's loss, gradient norm and the trained
    tree's parameters after one SGD(1.0) step, by the port's names; the
    port's inputs."""
    from ladiff_tpu.training.distill import distill_forward
    stage, _, seed = CASES[kind]
    jsys, params, port = _jax_system("action" if kind == "action" else
                                     "ar" if kind == "ar" else "text")
    batch = _batch(kind)
    jb = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(seed)
    uncond = np.random.RandomState(4).randn(1, 1, 768).astype(np.float32)
    un = jnp.asarray(uncond)
    if stage == "vae":
        tree, prefix = params["vae"], "vae."
        loss = lambda p: jsys.vae_forward(p, jb, key, train=True)[0]
    elif stage == "diffusion":
        tree, prefix = params["denoiser"], "denoiser."
        fwd = jsys.diffusion_forward_ar if kind == "ar" else \
            jsys.diffusion_forward
        loss = lambda p: fwd(p, params["vae"], jb, key, un, train=True)[0]
    elif stage == "vae_diffusion":
        tree, prefix = params, ""
        loss = lambda p: jsys.vae_diffusion_forward(p, jb, key, un,
                                                    train=True)[0]
    else:
        tree, prefix = params["denoiser"], "denoiser."
        loss = lambda p: distill_forward(jsys, p, params["denoiser"],
                                         params["vae"], jb, key, un,
                                         STUDENT_STEPS)[0]
    total, grads = jax.jit(jax.value_and_grad(loss))(tree)
    new = jax.tree.map(lambda p, g: p - g, tree, grads)
    want = {"total": float(total),
            "grad_norm": float(optax.global_norm(grads)),
            "params": {k: v.numpy() for k, v in
                       flax_state_dict(new, prefix).items()},
            "start": {k: v.numpy() for k, v in
                      flax_state_dict(tree, prefix).items()}}
    if kind == "action":
        batch = dict(batch, action=batch["action"])
    inputs = {"state": {k: v.numpy() for k, v in
                        system_state_dict(params).items()},
              "batch": batch, "draws": {"0": _draws(kind, key, jsys, params)}}
    if kind != "action":
        inputs["uncond"] = uncond
    spec = {"stage": stage, "layout": "dp", "system": port,
            "student_steps": STUDENT_STEPS}
    return want, inputs, spec


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """The JAX step of every case; the port's DDP step of every case at 2
    and at 4 ranks, its FSDP steps (3 AdamW steps beside DDP's, and the
    gradients against the one-process backward in FSDP2's order) at 2,
    its TP and SP steps on a 2 x 2 mesh and its pipelined stage-2 step over
    3 of 4 ranks (one spawn per world size)."""
    jax_side, inputs, jobs = {}, {}, []
    for kind in CASES:
        jax_side[kind], inputs[kind], spec = _jax_step(kind)
        jobs.append((kind, "train_step", spec))
    jobs2, jobs4 = list(jobs), list(jobs)
    for kind in ("vae", "diffusion"):
        spec = dict(jobs[list(CASES).index(kind)][2])
        inputs[f"fsdp_{kind}"] = inputs[f"tp_{kind}"] = inputs[kind]
        jobs2.append((f"fsdp_{kind}", "train_step", dict(spec,
                                                         layout="fsdp")))
        jobs4.append((f"tp_{kind}", "train_step",
                      dict(spec, layout="tp", n_model=2, routes=True)))
    inputs["sp_vae"], inputs["pp_diffusion"] = inputs["vae"], \
        inputs["diffusion"]
    jobs4 += [("sp_vae", "train_step", dict(jobs[0][2], layout="sp",
                                            n_model=2)),
              ("pp_diffusion", "pp_step", dict(jobs[1][2], stages=3,
                                               n_micro=2))]
    adam = dict(inputs["vae"], draws={str(i): inputs["vae"]["draws"]["0"]
                                      for i in range(ADAM_STEPS)})
    inputs["fsdp_adamw"] = inputs["dp_adamw"] = adam
    spec = dict(jobs[0][2], opt="adamw", steps=ADAM_STEPS)
    jobs2 += [("fsdp_adamw", "train_step", dict(spec, layout="fsdp")),
              ("dp_adamw", "train_step", dict(spec, fsdp_graph=True))]
    for kind in ("vae", "diffusion"):
        inputs[f"fsdp_graph_{kind}"] = inputs[kind]
        jobs2.append((f"fsdp_graph_{kind}", "fsdp_graph",
                      jobs[list(CASES).index(kind)][2]))
    runs = {2: ranks.spawn(2, jobs2, inputs, tmp_path_factory.mktemp("w2")),
            4: ranks.spawn(4, jobs4, inputs, tmp_path_factory.mktemp("w4"))}
    return jax_side, runs


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", list(CASES))
def test_ddp_step_matches_jax(step_runs, kind, world):
    """Loss and gradient norm as the JAX step's (logs all-reduced over the
    ranks), every trained parameter after the step by name."""
    got = step_runs[1][world][kind]
    assert int(got["world"]) == world
    _step_matches(got, step_runs[0][kind])


def _step_matches(got, want):
    """One SGD(1.0) step: the loss, the global gradient norm and every
    parameter (gathered whole) as the JAX step's."""
    logs = got["logs"]["0"]
    for k, tol in (("total", LOSS_TOL), ("grad_norm", NORM_TOL)):
        assert abs(float(logs[k]) - want[k]) <= tol * abs(want[k]), k
    assert set(got["params"]) == set(want["params"])
    for name, w in want["params"].items():
        delta = got["params"][name] - want["start"][name]
        np.testing.assert_allclose(delta, w - want["start"][name],
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    moved = [n for n, w in want["params"].items()
             if np.abs(w - want["start"][n]).max() > 0]
    assert len(moved) > len(want["params"]) // 2


@pytest.mark.parametrize("run,world,kind", [
    ("fsdp_vae", 2, "vae"), ("fsdp_diffusion", 2, "diffusion"),
    ("tp_vae", 4, "vae"), ("tp_diffusion", 4, "diffusion"),
    ("sp_vae", 4, "vae"), ("pp_diffusion", 4, "diffusion")])
def test_layout_step_matches_jax(step_runs, run, world, kind):
    """FSDP2 at 2 ranks, TP and SP on a 2 x 2 mesh, the pipeline over 3
    stages and 2 microbatches: the global gradient norm (shards' squares
    summed over their dim) and the whole parameters after one step."""
    _step_matches(step_runs[1][world][run], step_runs[0][kind])


def test_fsdp_adamw_trajectory_and_shards(step_runs):
    """Three AdamW steps (lr 1e-3) under FSDP at 2 ranks, so that the loss
    sees the second update, the first that reads the moments: the first
    loss as the JAX step's within 1e-5; every loss, both moments of every
    leaf (gathered whole) and every parameter after the steps equal, bit
    for bit, to DDP's with FSDP2's autograd nodes on the same layers
    (``fsdp_autograd_graph``; without them the backward sums some
    gradients in another order, ``test_fsdp_gradients_in_fsdp_order``).
    Rank 0 holds at most half of the rows of every parameter and of both
    its moments (dim 0, padded), and at least 40 % of each of 64 elements
    or more."""
    got, ddp = step_runs[1][2]["fsdp_adamw"], step_runs[1][2]["dp_adamw"]
    want = step_runs[0]["vae"]["total"]
    assert abs(float(got["logs"]["0"]["total"]) - want) <= LOSS_TOL * want
    for i in range(ADAM_STEPS):
        assert float(got["logs"][str(i)]["total"]) == float(
            ddp["logs"][str(i)]["total"]), i
    assert set(got["moments"]) == set(ddp["moments"])
    assert len(ddp["moments"]) == 2 * len(ddp["params"])
    for name, w in ddp["moments"].items():
        np.testing.assert_array_equal(got["moments"][name], w, err_msg=name)
    for name, w in ddp["params"].items():
        np.testing.assert_array_equal(got["params"][name], w, err_msg=name)
    local, full = got["local_numel"], got["full_numel"]
    assert len(local) == 3 * len(ddp["params"])   # each leaf, both moments
    for name, n in full.items():
        rows = int(got["rows"][name])
        assert int(local[name]) <= -(-rows // 2) * (int(n) // rows), name
    big = [k for k in full if int(full[k]) >= 64]
    assert all(int(local[k]) / int(full[k]) >= 0.4 for k in big)


@pytest.mark.parametrize("kind", ["vae", "diffusion"])
def test_fsdp_gradients_in_fsdp_order(step_runs, kind):
    """FSDP2's gradients at 2 ranks are the one-process backward's of each
    rank's rows, averaged, bit for bit, once that backward carries the
    identity nodes FSDP2 puts on each wrapped layer's inputs
    (``fsdp_autograd_graph``): the layout changes the order of the sums,
    nothing else."""
    got = step_runs[1][2][f"fsdp_graph_{kind}"]
    assert bool(got["same_names"]) and int(got["n"]) > 100
    assert float(got["graph_max_abs"]) == 0.0
    assert int(got["graph_n_differ"]) == 0


def test_tp_plain_routes_in_sharded_layers_only(step_runs):
    """Under TP in stage 2 every module that holds a shard runs on the
    plain routes (``kernel_route`` false as its forward starts), while
    the frozen VAE's encode and the denoiser's modules outside the
    sharded layers keep the kernel routes (on the CPU each kernel wrapper
    is its plain version; on the card the encode launches kernels 5 and
    10)."""
    got = step_runs[1][4]["tp_diffusion"]
    routes = {k: bool(v) for k, v in got["kernel_route"].items()}
    sharded = {k.rsplit(".", 1)[0] for k in got["tp_dim"]}
    assert sharded and sharded <= set(routes)
    assert not any(routes[k] for k in sharded)
    vae = [k for k in routes if k.startswith("vae.")]
    assert "vae.encoder.middle_block" in vae and all(routes[k] for k in vae)
    assert routes["denoiser"] and routes["denoiser.time_embedding"]


def test_tp_table_matches_jax(step_runs):
    """The leaves the port shards over the ``model`` dim, and on which dim,
    are ``tp_spec_for``'s for the same parameters (a torch ``Linear`` weight
    is the JAX kernel transposed): at least 4 per layer of each tree."""
    from jax.tree_util import tree_flatten_with_path

    from ladiff_tpu.parallel.tp import tp_spec_for
    _, params, _ = _jax_system("text")
    for kind, prefix in (("vae", "vae."), ("diffusion", "denoiser.")):
        want = {}
        for path, leaf in tree_flatten_with_path(params[prefix[:-1]])[0]:
            spec = tp_spec_for(path, leaf, 2)
            if any(s is not None for s in spec):
                dim = [i for i, s in enumerate(spec) if s is not None][0]
                # the leaf alone in its nesting, for its torch name
                names = [getattr(k, "key", str(k)) for k in path]
                sub = node = {}
                for n in names[:-1]:
                    node = node.setdefault(n, {})
                node[names[-1]] = np.asarray(leaf)
                (name,) = flax_state_dict(sub, prefix).keys()
                # the JAX kernel [in, out] is the torch weight transposed
                want[name] = 1 - dim if np.ndim(leaf) == 2 else dim
        got = {k: int(v) for k, v in
               step_runs[1][4][f"tp_{kind}"]["tp_dim"].items()}
        assert got == want
        assert len(got) >= 4 * LAYERS
