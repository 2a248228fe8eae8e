"""MultiModality metric (reference src/ladiff/models/metrics/mm.py:11-62):
100 texts x 30 repeats, mean pairwise distance among same-text generations.

The port's copy of ``ladiff_tpu/metrics/mm.py``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ladiff_torch.metrics.utils import calculate_multimodality

__all__ = ["MMMetrics"]


class MMMetrics:
    def __init__(self, mm_num_times: int = 10, seed: int = 0):
        self.mm_num_times = mm_num_times
        self.rng = np.random.RandomState(seed)
        self.reset()

    def reset(self):
        self.count_seq = 0
        self.mm_motion_embeddings: List[np.ndarray] = []

    def update(self, mm_motion_embeddings, lengths):
        """mm_motion_embeddings: [1, B_repeats, D] per text batch."""
        self.count_seq += len(lengths)
        emb = np.asarray(mm_motion_embeddings)
        self.mm_motion_embeddings.append(emb.reshape(emb.shape[0],
                                                     emb.shape[1], -1))

    def compute(self) -> Dict[str, float]:
        all_emb = np.concatenate(self.mm_motion_embeddings, axis=0)
        return {"MultiModality": calculate_multimodality(
            all_emb, self.mm_num_times, self.rng)}
