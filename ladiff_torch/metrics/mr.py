"""Motion-reconstruction metrics: MPJPE / PA-MPJPE / ACCEL.

Rebuild of the reference ladiff/models/metrics/mr.py:11-96 (per-sample
sums over valid frames, x1000 meter->millimeter factor, ACCEL normalized by
count - 2*count_seq).

The port's copy of ``ladiff_tpu/metrics/mr.py``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ladiff_torch.metrics.utils import calc_accel, calc_mpjpe, calc_pampjpe

__all__ = ["MRMetrics"]


class MRMetrics:
    def __init__(self, njoints: int = 22, force_in_meter: bool = True,
                 align_root: bool = True):
        self.njoints = njoints
        self.factor = 1000.0 if force_in_meter else 1.0
        self.align_root = align_root
        self.reset()

    def reset(self):
        self.count = 0
        self.count_seq = 0
        self.mpjpe = 0.0
        self.pampjpe = 0.0
        self.accel = 0.0

    def update(self, joints_rst, joints_ref, lengths):
        joints_rst = np.asarray(joints_rst)
        joints_ref = np.asarray(joints_ref)
        self.count += int(np.sum(lengths))
        self.count_seq += len(lengths)
        for i, L in enumerate(lengths):
            L = int(L)
            rst, ref = joints_rst[i, :L], joints_ref[i, :L]
            self.mpjpe += float(np.sum(calc_mpjpe(rst, ref, self.align_root)))
            self.pampjpe += float(np.sum(calc_pampjpe(rst, ref)))
            self.accel += float(np.sum(calc_accel(rst, ref)))

    def compute(self) -> Dict[str, float]:
        return {
            "MPJPE": self.mpjpe / self.count * self.factor,
            "PAMPJPE": self.pampjpe / self.count * self.factor,
            "ACCEL": self.accel / (self.count - 2 * self.count_seq) * self.factor,
        }
