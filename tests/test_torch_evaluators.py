"""The port's T2M evaluator encoders (``ladiff_torch/models/evaluators.py``,
``evaluation/t2m_eval.py`` ``T2MEvaluator``) against the JAX package's on
the CPU: the same weights (the JAX params through
``convert.evaluator_state_dict``, or one ``finest.tar`` with the
reference's names loaded by both packages) and the same inputs give the
same embeddings within 1e-4 norm-wise (float32 on both sides; the GRU's
sums run in another order).  Lengths 1, ragged and full, with padded frames
that are not zero, as renormed padding is not."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import evaluator_state_dict
from ladiff_torch.evaluation.t2m_eval import T2MEvaluator
from ladiff_torch.models.evaluators import (MotionEncoderBiGRUCo,
                                            MovementConvEncoder,
                                            TextEncoderBiGRUCo,
                                            load_t2m_checkpoint)
from ladiff_tpu.evaluation.t2m_eval import T2MEvaluator as JaxEvaluator

NFEATS, T, TOL = 263, 196, 1e-4
LENGTHS = {"one": [1, 1, 1], "ragged": [196, 1, 57, 6, 123],
           "full": [196, 196], "short": [3, 2, 1]}


def relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    """JAX evaluators with PyTorch's default initialization (through the
    JAX package's ``finest.tar`` loader), and the port's loaded from their
    params through ``convert.evaluator_state_dict``."""
    from ladiff_tpu.models.evaluators import \
        load_t2m_checkpoint as jax_load
    src = T2MEvaluator.random_init(NFEATS, torch.Generator().manual_seed(3),
                                   "cpu")
    path = str(tmp_path_factory.mktemp("evaluators") / "finest.tar")
    torch.save({"text_encoder": src.text.state_dict(),
                "movement_encoder": src.movement.state_dict(),
                "motion_encoder": src.motion.state_dict()}, path)
    jev = JaxEvaluator(nfeats=NFEATS, params=jax_load(path))
    tev = T2MEvaluator(NFEATS, device="cpu")
    for name, sd in evaluator_state_dict(jev.params).items():
        getattr(tev, name).load_state_dict(sd, strict=True)
        for key, v in getattr(src, name).state_dict().items():
            assert torch.equal(sd[key], v), (name, key)
    return jev, tev


def motion_batch(lengths, seed=0):
    """Renormed-looking features: padded frames hold a non-zero constant."""
    rng = np.random.RandomState(seed)
    x = np.tile(rng.randn(1, 1, NFEATS), (len(lengths), T, 1))
    for i, n in enumerate(lengths):
        x[i, :n] = rng.randn(n, NFEATS)
    return x.astype(np.float32), np.asarray(lengths, np.int32)


def text_batch(lengths, seed=1, width=22):
    rng = np.random.RandomState(seed)
    B = len(lengths)
    return (rng.randn(B, width, 300).astype(np.float32),
            rng.rand(B, width, 15).astype(np.float32),
            np.asarray(lengths, np.int32))


def test_converted_state_dicts_load_strict(evaluators):
    _, tev = evaluators
    sds = evaluator_state_dict(evaluators[0].params)
    assert set(sds["movement"]) == {"main.0.weight", "main.0.bias",
                                    "main.3.weight", "main.3.bias",
                                    "out_net.weight", "out_net.bias"}
    assert "gru.weight_hh_l0_reverse" in sds["motion"]
    assert sds["text"]["pos_emb.weight"].shape == (300, 15)
    assert sds["motion"]["hidden"].shape == (2, 1, 1024)
    for name in ("text", "movement", "motion"):
        assert set(sds[name]) == set(getattr(tev, name).state_dict())


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_encode_motion_matches_jax(evaluators, case):
    """The whole motion path (batch-max crop, conv, BiGRU over
    max(length // 4, 1) steps), and the movement encoder alone where its
    rows are consumed."""
    jev, tev = evaluators
    x, lengths = motion_batch(LENGTHS[case])
    want = np.asarray(jev.encode_motion(jnp.asarray(x),
                                        jnp.asarray(lengths)))
    got = tev.encode_motion(torch.from_numpy(x),
                            torch.from_numpy(lengths)).numpy()
    assert got.shape == (len(lengths), 512)
    assert relerr(got, want) <= TOL

    lmax = int(lengths.max())
    mov_j = np.asarray(jev.movement.apply(
        {"params": jev.params["movement"]}, jnp.asarray(x[..., :-4]),
        valid_length=lmax))
    mov_t = tev.movement(torch.from_numpy(x[..., :-4]),
                         valid_length=lmax).detach().numpy()
    n = max(lmax // 4, 1)
    assert relerr(mov_t[:, :n], mov_j[:, :n]) <= TOL


@pytest.mark.parametrize("case", ["one", "ragged", "full"])
def test_encode_text_matches_jax(evaluators, case):
    jev, tev = evaluators
    lengths = [min(n, 22) for n in LENGTHS[case]]
    w, p, n = text_batch(lengths)
    want = np.asarray(jev.encode_text(jnp.asarray(w), jnp.asarray(p),
                                      jnp.asarray(n)))
    got = tev.encode_text(torch.from_numpy(w), torch.from_numpy(p),
                          torch.from_numpy(n)).numpy()
    assert relerr(got, want) <= TOL


def test_motion_encoder_module_matches_jax(evaluators):
    """``MotionEncoderBiGRUCo`` alone on unsorted lengths (packed with
    ``enforce_sorted=False``; h0 the learned ``hidden``)."""
    jev, tev = evaluators
    rng = np.random.RandomState(5)
    x = rng.randn(4, 12, 512).astype(np.float32)
    lens = np.array([3, 12, 1, 7])
    want = np.asarray(jev.motion.apply({"params": jev.params["motion"]},
                                       jnp.asarray(x), jnp.asarray(lens)))
    with torch.no_grad():
        got = tev.motion(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    assert relerr(got, want) <= TOL


def test_finest_tar_loads_in_both_packages(tmp_path):
    """A ``finest.tar`` with the reference's names and layout (the three
    state dicts of the reference modules), written here, loads in both
    ``load_t2m_checkpoint``s; both give the same embeddings."""
    from ladiff_tpu.models.evaluators import \
        load_t2m_checkpoint as jax_load

    torch.manual_seed(9)
    mods = {"movement_encoder": MovementConvEncoder(NFEATS - 4),
            "motion_encoder": MotionEncoderBiGRUCo(),
            "text_encoder": TextEncoderBiGRUCo()}
    path = str(tmp_path / "finest.tar")
    torch.save({k: m.state_dict() for k, m in mods.items()}, path)
    assert load_t2m_checkpoint(str(tmp_path / "missing.tar")) is None
    assert T2MEvaluator.from_checkpoint(str(tmp_path / "missing.tar"),
                                        NFEATS, "cpu") is None

    tev = T2MEvaluator.from_checkpoint(path, NFEATS, device="cpu")
    jev = JaxEvaluator(nfeats=NFEATS, params=jax_load(path))
    assert torch.equal(tev.motion.hidden, mods["motion_encoder"].hidden)
    x, lengths = motion_batch(LENGTHS["ragged"], seed=2)
    got = tev.encode_motion(torch.from_numpy(x), torch.from_numpy(lengths))
    want = jev.encode_motion(jnp.asarray(x), jnp.asarray(lengths))
    assert relerr(got.numpy(), np.asarray(want)) <= TOL
    w, p, n = text_batch([22, 4, 9])
    got = tev.encode_text(torch.from_numpy(w), torch.from_numpy(p),
                          torch.from_numpy(n))
    want = jev.encode_text(jnp.asarray(w), jnp.asarray(p), jnp.asarray(n))
    assert relerr(got.numpy(), np.asarray(want)) <= TOL


def test_random_init_is_seeded_by_the_generator():
    a = T2MEvaluator.random_init(NFEATS, torch.Generator().manual_seed(1),
                                 "cpu")
    b = T2MEvaluator.random_init(NFEATS, torch.Generator().manual_seed(1),
                                 "cpu")
    c = T2MEvaluator.random_init(NFEATS, torch.Generator().manual_seed(2),
                                 "cpu")
    assert not a.training and not any(p.requires_grad
                                      for p in a.parameters())
    assert torch.equal(a.text.hidden, b.text.hidden)
    assert not torch.equal(a.text.hidden, c.text.hidden)
