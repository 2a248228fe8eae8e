"""Metric math utilities (numpy; run once per eval epoch on the host): the
port's copy of ``ladiff_tpu/metrics/utils.py``, the same code, so the same
seed gives the same ``RandomState`` draws and the same numbers.

Rebuild of the reference ladiff/models/metrics/utils.py:8-607:
distance matrices, top-k retrieval, FID (Frechet) statistics, KID
(polynomial MMD), diversity/multimodality sampling, and the MPJPE family
(incl. Procrustes-aligned PA-MPJPE).  These are host-side epoch-end
reductions in the reference as well (the per-batch encoders run on the
device).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "euclidean_distance_matrix", "calculate_top_k",
    "calculate_activation_statistics", "calculate_frechet_distance",
    "calculate_diversity", "calculate_multimodality", "calculate_kid",
    "calc_mpjpe", "calc_pampjpe", "calc_accel", "l2_norm", "variance",
]


def euclidean_distance_matrix(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """dist[i, j] = ||m1[i] - m2[j]|| (reference utils.py:44-59)."""
    d1 = -2 * m1 @ m2.T
    d2 = np.sum(m1 ** 2, axis=1, keepdims=True)
    d3 = np.sum(m2 ** 2, axis=1)
    sq = np.maximum(d1 + d2 + d3, 0.0)
    return np.nan_to_num(np.sqrt(sq))


def calculate_top_k(argsort_mat: np.ndarray, top_k: int) -> np.ndarray:
    """[N, N] argsorted distances -> [N, top_k] cumulative hit booleans
    (reference utils.py:62-75)."""
    size = argsort_mat.shape[0]
    gt = np.arange(size)[:, None]
    bool_mat = argsort_mat == gt
    out = np.zeros((size, top_k), dtype=bool)
    correct = np.zeros(size, dtype=bool)
    for i in range(top_k):
        correct = correct | bool_mat[:, i]
        out[:, i] = correct
    return out


def calculate_activation_statistics(act: np.ndarray):
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def _sqrtm_product(sigma1: np.ndarray, sigma2: np.ndarray) -> np.ndarray:
    """sqrtm(sigma1 @ sigma2); scipy when available, eigendecomposition of
    the PSD-symmetrized product otherwise."""
    try:
        from scipy import linalg
        out = linalg.sqrtm(sigma1 @ sigma2)
        return out[0] if isinstance(out, tuple) else out
    except ImportError:
        w = np.linalg.eigvals(sigma1 @ sigma2)
        return np.diag(np.sqrt(np.maximum(w.real, 0.0)))


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """Stable FID (reference utils.py:161-227, Sutherland formulation)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm_product(sigma1, sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm_product(sigma1 + offset, sigma2 + offset)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    tr_covmean = np.trace(covmean)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * tr_covmean)


def calculate_diversity(act: np.ndarray, diversity_times: int,
                        rng: np.random.RandomState | None = None) -> float:
    """Mean pairwise distance over sampled index pairs (utils.py:230-244)."""
    assert act.ndim == 2 and act.shape[0] > diversity_times
    rng = rng or np.random
    n = act.shape[0]
    first = rng.choice(n, diversity_times, replace=False)
    second = rng.choice(n, diversity_times, replace=False)
    return float(np.linalg.norm(act[first] - act[second], axis=1).mean())


def calculate_multimodality(act: np.ndarray, multimodality_times: int,
                            rng: np.random.RandomState | None = None) -> float:
    """[n_texts, n_repeats, D] -> mean distance among same-text generations
    (utils.py:247-261)."""
    assert act.ndim == 3 and act.shape[1] > multimodality_times
    rng = rng or np.random
    n = act.shape[1]
    first = rng.choice(n, multimodality_times, replace=False)
    second = rng.choice(n, multimodality_times, replace=False)
    return float(np.linalg.norm(act[:, first] - act[:, second], axis=2).mean())


def calculate_kid(real: np.ndarray, gen: np.ndarray, n_subsets: int = 100,
                  subset_size: int = 1000,
                  rng: np.random.RandomState | None = None):
    """Polynomial-kernel MMD^2 (KID), mean +- std over subsets
    (reference utils.py KID path used by UncondMetrics)."""
    rng = rng or np.random
    d = real.shape[1]
    subset_size = min(subset_size, real.shape[0], gen.shape[0])

    def mmd2(x, y):
        kxx = (x @ x.T / d + 1) ** 3
        kyy = (y @ y.T / d + 1) ** 3
        kxy = (x @ y.T / d + 1) ** 3
        m = x.shape[0]
        sum_kxx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
        sum_kyy = (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
        return sum_kxx + sum_kyy - 2 * kxy.mean()

    vals = []
    for _ in range(n_subsets):
        xi = real[rng.choice(real.shape[0], subset_size, replace=False)]
        yi = gen[rng.choice(gen.shape[0], subset_size, replace=False)]
        vals.append(mmd2(xi, yi))
    return float(np.mean(vals)), float(np.std(vals))


# ---------------------------------------------------------------------------
# MPJPE family (reference utils.py:267-409)
# ---------------------------------------------------------------------------

def l2_norm(x1, x2, axis):
    return np.linalg.norm(np.asarray(x1) - np.asarray(x2), axis=axis)


def variance(x, T, axis):
    mean = x.mean(axis)
    return ((x - mean) ** 2).sum(axis) / (T - 1)


def calc_mpjpe(preds: np.ndarray, target: np.ndarray, align_root=True):
    """[T, J, 3] pair -> per-frame MPJPE (root-aligned)."""
    if align_root:
        preds = preds - preds[:, :1]
        target = target - target[:, :1]
    return np.linalg.norm(preds - target, axis=-1).mean(-1)


def calc_accel(preds: np.ndarray, target: np.ndarray):
    accel_gt = target[:-2] - 2 * target[1:-1] + target[2:]
    accel_pred = preds[:-2] - 2 * preds[1:-1] + preds[2:]
    return np.linalg.norm(accel_pred - accel_gt, axis=-1).mean(1)


def calc_pampjpe(preds: np.ndarray, target: np.ndarray):
    """Procrustes-aligned MPJPE (similarity transform per frame,
    reference utils.py:267-409)."""
    S1 = preds.transpose(0, 2, 1).astype(np.float64)  # [T, 3, J]
    S2 = target.transpose(0, 2, 1).astype(np.float64)
    mu1 = S1.mean(-1, keepdims=True)
    mu2 = S2.mean(-1, keepdims=True)
    X1, X2 = S1 - mu1, S2 - mu2
    var1 = (X1 ** 2).sum(axis=(1, 2))
    K = X1 @ X2.transpose(0, 2, 1)
    U, s, Vh = np.linalg.svd(K)
    V = Vh.transpose(0, 2, 1)
    Z = np.broadcast_to(np.eye(3), K.shape).copy()
    det = np.sign(np.linalg.det(U @ Vh))
    Z[:, -1, -1] = det
    R = V @ Z @ U.transpose(0, 2, 1)
    scale = np.trace(R @ K, axis1=1, axis2=2) / var1
    t = mu2 - scale[:, None, None] * (R @ mu1)
    S1_hat = scale[:, None, None] * (R @ S1) + t
    return np.linalg.norm(S1_hat.transpose(0, 2, 1)
                          - target, axis=-1).mean(-1)
