"""Unconditional-generation metrics: FID / KID / Diversity over motion
embeddings (rebuild of the reference ladiff/models/metrics/uncond.py:11).

The port's copy of ``ladiff_tpu/metrics/uncond.py``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ladiff_torch.metrics.utils import (calculate_activation_statistics,
                                      calculate_diversity,
                                      calculate_frechet_distance,
                                      calculate_kid)

__all__ = ["UncondMetrics"]


class UncondMetrics:
    def __init__(self, diversity_times: int = 300, seed: int = 0):
        self.diversity_times = diversity_times
        self.rng = np.random.RandomState(seed)
        self.reset()

    def reset(self):
        self.count_seq = 0
        self.rec: List[np.ndarray] = []
        self.gt: List[np.ndarray] = []

    def update(self, recmotion_embeddings, gtmotion_embeddings, lengths):
        self.count_seq += len(lengths)
        self.rec.append(np.asarray(recmotion_embeddings).reshape(
            len(lengths), -1))
        self.gt.append(np.asarray(gtmotion_embeddings).reshape(
            len(lengths), -1))

    def compute(self) -> Dict[str, float]:
        rec = np.concatenate(self.rec, axis=0)
        gt = np.concatenate(self.gt, axis=0)
        mu, cov = calculate_activation_statistics(rec)
        gt_mu, gt_cov = calculate_activation_statistics(gt)
        out = {"FID": calculate_frechet_distance(gt_mu, gt_cov, mu, cov)}
        kid_mean, kid_std = calculate_kid(gt, rec, n_subsets=100,
                                          subset_size=min(1000, len(gt)),
                                          rng=self.rng)
        out["KID_mean"], out["KID_std"] = kid_mean, kid_std
        if self.count_seq > self.diversity_times:
            out["Diversity"] = calculate_diversity(rec, self.diversity_times,
                                                   self.rng)
            out["gt_Diversity"] = calculate_diversity(gt, self.diversity_times,
                                                      self.rng)
        return out
