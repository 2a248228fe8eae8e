"""T2M benchmark metrics: R-precision, Matching score, FID, Diversity (the
port's copy of ``ladiff_tpu/metrics/tm2t.py``).

Rebuild of the reference ladiff/models/metrics/tm2t.py:11-178.  The
reference is a torchmetrics Metric with cross-rank reduction; here the
per-batch embeddings arrive on the host already, so this is a plain
accumulator: per-batch ``update`` stores embeddings, epoch-end ``compute``
shuffles, does 32-way retrieval groups, FID, and diversity — numerically
identical protocol (incl. the trace-based matching score and the
"count_seq // R_size" truncation).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ladiff_torch.metrics.utils import (calculate_activation_statistics,
                                      calculate_diversity,
                                      calculate_frechet_distance,
                                      calculate_top_k,
                                      euclidean_distance_matrix)

__all__ = ["TM2TMetrics"]


class TM2TMetrics:
    def __init__(self, top_k: int = 3, R_size: int = 32,
                 diversity_times: int = 300, seed: int = 0):
        self.top_k = top_k
        self.R_size = R_size
        self.diversity_times = diversity_times
        self.rng = np.random.RandomState(seed)
        self.reset()

    def reset(self):
        self.count = 0
        self.count_seq = 0
        self.text_embeddings: List[np.ndarray] = []
        self.recmotion_embeddings: List[np.ndarray] = []
        self.gtmotion_embeddings: List[np.ndarray] = []

    def update(self, text_embeddings, recmotion_embeddings,
               gtmotion_embeddings, lengths):
        self.count += int(np.sum(lengths))
        self.count_seq += len(lengths)
        flat = lambda x: np.asarray(x).reshape(len(lengths), -1)
        self.text_embeddings.append(flat(text_embeddings))
        self.recmotion_embeddings.append(flat(recmotion_embeddings))
        self.gtmotion_embeddings.append(flat(gtmotion_embeddings))

    def _retrieval(self, texts: np.ndarray, motions: np.ndarray):
        matching = 0.0
        top_k_mat = np.zeros(self.top_k)
        groups = self.count_seq // self.R_size
        for i in range(groups):
            sl = slice(i * self.R_size, (i + 1) * self.R_size)
            dist = euclidean_distance_matrix(texts[sl], motions[sl])
            matching += np.trace(dist)
            argsm = np.argsort(dist, axis=1)
            top_k_mat += calculate_top_k(argsm, self.top_k).sum(axis=0)
        R_count = groups * self.R_size
        return matching, top_k_mat, R_count

    def compute(self) -> Dict[str, float]:
        assert self.count_seq > self.R_size, (
            f"need > {self.R_size} sequences, have {self.count_seq}")
        shuffle = self.rng.permutation(self.count_seq)
        all_texts = np.concatenate(self.text_embeddings, axis=0)[shuffle]
        all_gen = np.concatenate(self.recmotion_embeddings, axis=0)[shuffle]
        all_gt = np.concatenate(self.gtmotion_embeddings, axis=0)[shuffle]

        metrics: Dict[str, float] = {}
        matching, topk, R_count = self._retrieval(all_texts, all_gen)
        metrics["Matching_score"] = matching / R_count
        for k in range(self.top_k):
            metrics[f"R_precision_top_{k+1}"] = topk[k] / R_count

        matching, topk, _ = self._retrieval(all_texts, all_gt)
        metrics["gt_Matching_score"] = matching / R_count
        for k in range(self.top_k):
            metrics[f"gt_R_precision_top_{k+1}"] = topk[k] / R_count

        mu, cov = calculate_activation_statistics(all_gen)
        gt_mu, gt_cov = calculate_activation_statistics(all_gt)
        metrics["FID"] = calculate_frechet_distance(gt_mu, gt_cov, mu, cov)

        if self.count_seq > self.diversity_times:
            metrics["Diversity"] = calculate_diversity(
                all_gen, self.diversity_times, self.rng)
            metrics["gt_Diversity"] = calculate_diversity(
                all_gt, self.diversity_times, self.rng)
        return metrics
