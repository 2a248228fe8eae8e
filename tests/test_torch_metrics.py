"""The port's benchmark metrics (``ladiff_torch/metrics``, numpy copies)
against the JAX package's on the same numpy features and the same seeds:
every class and function within 1e-10 (the same code on the same inputs:
the RandomState draws must match, not just the statistics)."""
import numpy as np
import pytest

from ladiff_torch.metrics import mm, mr, temos, tm2t, uncond
from ladiff_torch.metrics import utils as mu
from ladiff_tpu.metrics import mm as jmm
from ladiff_tpu.metrics import mr as jmr
from ladiff_tpu.metrics import temos as jtemos
from ladiff_tpu.metrics import tm2t as jtm2t
from ladiff_tpu.metrics import uncond as juncond
from ladiff_tpu.metrics import utils as jmu

TOL = 1e-10


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def same_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k])


def embeddings(seed, n=70, d=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, d).astype(np.float32) for _ in range(3)]


def joints(seed, B=3, T=50, J=22):
    rng = np.random.RandomState(seed)
    base = np.cumsum(rng.randn(B, T, J, 3) * 0.02, axis=1)
    base[..., 1] += 1.0
    return [(base + rng.randn(B, T, J, 3) * 0.05).astype(np.float32),
            base.astype(np.float32)]


@pytest.mark.parametrize("name", ["euclidean_distance_matrix",
                                  "calculate_top_k", "activation_statistics",
                                  "calculate_frechet_distance",
                                  "calculate_diversity",
                                  "calculate_multimodality", "calculate_kid",
                                  "calc_mpjpe", "calc_accel", "calc_pampjpe",
                                  "l2_norm", "variance"])
def test_metric_functions_match_jax(name):
    a, b, _ = embeddings(0)
    pr, gt = joints(1)
    if name == "euclidean_distance_matrix":
        close(mu.euclidean_distance_matrix(a, b),
              jmu.euclidean_distance_matrix(a, b))
    elif name == "calculate_top_k":
        order = np.argsort(mu.euclidean_distance_matrix(a[:32], b[:32]), 1)
        close(mu.calculate_top_k(order, 3), jmu.calculate_top_k(order, 3))
    elif name == "activation_statistics":
        for g, w in zip(mu.calculate_activation_statistics(a),
                        jmu.calculate_activation_statistics(a)):
            close(g, w)
    elif name == "calculate_frechet_distance":
        sa, sb = (mu.calculate_activation_statistics(x) for x in (a, b))
        close(mu.calculate_frechet_distance(*sa, *sb),
              jmu.calculate_frechet_distance(*sa, *sb))
        close(mu._sqrtm_product(sa[1], sb[1]),
              jmu._sqrtm_product(sa[1], sb[1]))
    elif name == "calculate_diversity":
        close(mu.calculate_diversity(a, 20, np.random.RandomState(3)),
              jmu.calculate_diversity(a, 20, np.random.RandomState(3)))
    elif name == "calculate_multimodality":
        act = a.reshape(7, 10, -1)
        close(mu.calculate_multimodality(act, 4, np.random.RandomState(3)),
              jmu.calculate_multimodality(act, 4, np.random.RandomState(3)))
    elif name == "calculate_kid":
        close(mu.calculate_kid(a, b, 5, 30, np.random.RandomState(3)),
              jmu.calculate_kid(a, b, 5, 30, np.random.RandomState(3)))
    elif name in ("calc_mpjpe", "calc_accel", "calc_pampjpe"):
        close(getattr(mu, name)(pr[0], gt[0]), getattr(jmu, name)(pr[0],
                                                                  gt[0]))
    elif name == "l2_norm":
        close(mu.l2_norm(a, b, 1), jmu.l2_norm(a, b, 1))
    else:
        close(mu.variance(a, 70, 0), jmu.variance(a, 70, 0))


def test_sqrtm_fallback_without_scipy_matches_jax(monkeypatch):
    """``_sqrtm_product``'s eigendecomposition branch (scipy absent)."""
    import builtins
    real_import = builtins.__import__

    def no_scipy(name, *args, **kw):
        if name == "scipy" or name.startswith("scipy."):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    a, b, _ = embeddings(4)
    sa, sb = (mu.calculate_activation_statistics(x) for x in (a, b))
    monkeypatch.setattr(builtins, "__import__", no_scipy)
    got = mu.calculate_frechet_distance(*sa, *sb)
    want = jmu.calculate_frechet_distance(*sa, *sb)
    close(got, want)


@pytest.mark.parametrize("n_seq", [40, 70, 330])
def test_tm2t_metrics_match_jax(n_seq):
    """R_size 32 groups, FID, and (above DIVERSITY_TIMES) the diversity
    draws, fed in three ragged batches, seed = replication."""
    t, r, g = embeddings(5, n=n_seq)
    got = tm2t.TM2TMetrics(diversity_times=300, seed=1)
    want = jtm2t.TM2TMetrics(diversity_times=300, seed=1)
    cuts = [0, n_seq // 3, n_seq // 2, n_seq]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        lengths = list(range(40, 40 + hi - lo))
        got.update(t[lo:hi], r[lo:hi], g[lo:hi], lengths)
        want.update(t[lo:hi], r[lo:hi], g[lo:hi], lengths)
    out = got.compute()
    same_dict(out, want.compute())
    assert ("Diversity" in out) == (n_seq > 300)


def test_temos_metrics_match_jax():
    pr, gt = joints(6)
    lengths = [50, 31, 12]
    got, want = temos.TemosMetrics(22, "humanml3d"), jtemos.TemosMetrics(
        22, "humanml3d")
    for obj in (got, want):
        obj.update(pr, gt, lengths)
        obj.update(pr[:2] * 1.1, gt[:2], lengths[:2])
    same_dict(got.compute(), want.compute())
    close(temos.rifke_canonicalize(pr[0])[0],
          jtemos.rifke_canonicalize(pr[0])[0])


@pytest.mark.parametrize("kind", ["TemosMetricsBest", "TemosMetricsWorst"])
def test_temos_trial_selection_matches_jax(kind):
    trials = [joints(s) for s in (7, 8, 9)]
    lengths = [[50, 31, 12]] * 3
    got, want = getattr(temos, kind)(), getattr(jtemos, kind)()
    for obj in (got, want):
        obj.update([t[0] for t in trials], [t[1] for t in trials], lengths)
    same_dict(got.compute(), want.compute())


def test_mr_metrics_match_jax():
    pr, gt = joints(10)
    got, want = mr.MRMetrics(22), jmr.MRMetrics(22)
    for obj in (got, want):
        obj.update(pr, gt, [50, 31, 12])
    same_dict(got.compute(), want.compute())


def test_mm_metrics_match_jax():
    rng = np.random.RandomState(11)
    got, want = mm.MMMetrics(mm_num_times=10, seed=2), jmm.MMMetrics(
        mm_num_times=10, seed=2)
    for _ in range(12):
        emb = rng.randn(1, 30, 16).astype(np.float32)
        got.update(emb, [1])
        want.update(emb, [1])
    same_dict(got.compute(), want.compute())


@pytest.mark.parametrize("n_seq", [40, 320])
def test_uncond_metrics_match_jax(n_seq):
    _, r, g = embeddings(12, n=n_seq)
    got, want = uncond.UncondMetrics(seed=3), juncond.UncondMetrics(seed=3)
    for obj in (got, want):
        obj.update(r, g, list(range(n_seq)))
    same_dict(got.compute(), want.compute())
