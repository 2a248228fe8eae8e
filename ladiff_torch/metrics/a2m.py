"""Action-to-motion metrics (counterpart of ``ladiff_tpu/metrics/a2m.py``,
the same numpy code): classifier accuracy, FID, Diversity and
Multimodality, the HumanAct12 (GRU) and UESTC (ST-GCN) protocol of the
reference's HUMANACTMetrics / UESTCMetrics: per-class confusion matrices for
the accuracy, FID on the classifier's features (generated against ground
truth, and ground truth against a shuffle of itself), and the action2motion
diversity / multimodality draws."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ladiff_torch.metrics.utils import (calculate_activation_statistics,
                                      calculate_frechet_distance)

__all__ = ["ActionClassifierMetrics", "a2m_diversity_multimodality"]


def a2m_diversity_multimodality(activations: np.ndarray, labels: np.ndarray,
                                num_labels: int, diversity_times: int = 200,
                                multimodality_times: int = 20,
                                rng: np.random.RandomState | None = None):
    """(Diversity, Multimodality) of ``activations`` [N, d] with class
    ``labels`` [N]: the mean distance of ``diversity_times`` random pairs,
    and of ``multimodality_times`` same-class pairs per class present,
    divided over every class (the action2motion protocol; every index
    drawn from ``rng`` with replacement)."""
    rng = rng or np.random
    n = activations.shape[0]
    first = rng.randint(0, n, diversity_times)
    second = rng.randint(0, n, diversity_times)
    diversity = float(np.linalg.norm(
        activations[first] - activations[second], axis=1).mean())

    multimodality = 0.0
    quotas = np.zeros(num_labels)
    quotas[np.unique(labels)] = multimodality_times
    guard = 0
    while np.any(quotas > 0) and guard < 10_000_000:
        guard += 1
        i = rng.randint(0, n)
        li = labels[i]
        if not quotas[li]:
            continue
        j = rng.randint(0, n)
        while labels[j] != li:
            j = rng.randint(0, n)
        quotas[li] -= 1
        multimodality += float(np.linalg.norm(activations[i] - activations[j]))
    multimodality /= multimodality_times * num_labels
    return diversity, multimodality


class ActionClassifierMetrics:
    """The accumulator of the HumanAct12 (GRU) and UESTC (ST-GCN) metrics:
    the caller runs the classifier and feeds its features and logits here.

    Protocol notes (reference metrics/gru.py:97-145):
      * the GT diversity/multimodality pass uses the FUNCTION defaults
        (200/20, utils.py:410-413) regardless of the configured gen-side
        times — ``gt_*`` mirror that, overridable for tiny test datasets;
      * all index draws are with replacement and uncapped, exactly like
        the reference's np.random.randint stream (so identically seeded
        streams yield identical numbers);
      * the gt-vs-shuffled-gt FID permutation comes from a SEPARATE stream
        (the reference draws it from torch.randperm, which never touches
        the np.random stream the diversity draws consume)."""

    def __init__(self, num_labels: int, diversity_times: int = 200,
                 multimodality_times: int = 20, seed: int = 0,
                 gt_diversity_times: int = 200,
                 gt_multimodality_times: int = 20):
        self.num_labels = num_labels
        self.diversity_times = diversity_times
        self.multimodality_times = multimodality_times
        self.gt_diversity_times = gt_diversity_times
        self.gt_multimodality_times = gt_multimodality_times
        self.rng = np.random.RandomState(seed)
        self.perm_rng = np.random.RandomState(seed + 0x5EED)
        self.reset()

    def reset(self):
        self.count = 0
        self.count_seq = 0
        self.confusion = np.zeros((self.num_labels, self.num_labels), int)
        self.gt_confusion = np.zeros((self.num_labels, self.num_labels), int)
        self.labels: List[np.ndarray] = []
        self.rec_feats: List[np.ndarray] = []
        self.gt_feats: List[np.ndarray] = []

    def update(self, labels, rec_feats, rec_logits, gt_feats, gt_logits,
               lengths):
        labels = np.asarray(labels).reshape(-1).astype(int)
        self.count += int(np.sum(lengths))
        self.count_seq += len(labels)
        for lab, pred in zip(labels, np.argmax(np.asarray(rec_logits), -1)):
            self.confusion[lab, pred] += 1
        for lab, pred in zip(labels, np.argmax(np.asarray(gt_logits), -1)):
            self.gt_confusion[lab, pred] += 1
        self.labels.append(labels)
        self.rec_feats.append(np.asarray(rec_feats))
        self.gt_feats.append(np.asarray(gt_feats))

    def compute(self) -> Dict[str, float]:
        labels = np.concatenate(self.labels)
        rec = np.concatenate(self.rec_feats, axis=0)
        gt = np.concatenate(self.gt_feats, axis=0)
        gt_shuffled = gt[self.perm_rng.permutation(len(gt))]

        out = {
            "accuracy": float(np.trace(self.confusion)
                              / max(self.confusion.sum(), 1)),
            "gt_accuracy": float(np.trace(self.gt_confusion)
                                 / max(self.gt_confusion.sum(), 1)),
        }
        genstats = calculate_activation_statistics(rec)
        gtstats = calculate_activation_statistics(gt)
        gtstats2 = calculate_activation_statistics(gt_shuffled)
        out["FID"] = calculate_frechet_distance(*gtstats, *genstats)
        out["gt_FID"] = calculate_frechet_distance(*gtstats, *gtstats2)

        if len(rec) > 0:
            # draw order matches the reference compute (gru.py:118-129):
            # gen with the configured times, then gt with its own times —
            # the same np.random-style stream serves both in sequence
            div, mm = a2m_diversity_multimodality(
                rec, labels, self.num_labels, self.diversity_times,
                self.multimodality_times, self.rng)
            out["Diversity"], out["Multimodality"] = div, mm
            div, mm = a2m_diversity_multimodality(
                gt, labels, self.num_labels, self.gt_diversity_times,
                self.gt_multimodality_times, self.rng)
            out["gt_Diversity"], out["gt_Multimodality"] = div, mm
        return out
