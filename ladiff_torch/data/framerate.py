"""Framerate resampling helpers.

Host-side numpy: the counterpart of ``ladiff_tpu/data/framerate.py``,
line for line.

Rebuild of the reference's ladiff/data/sampling/framerate.py:5-13 and
the identical pair in utils/temos_utils.py:103-118.  Consumed by the SMPL
fitting entry (reference fit.py:172,179: KIT mmm joints arrive at 100 fps
and are decimated to the 12.5 fps the pipeline renders at) and the legacy
TEMOS data path.
"""
from __future__ import annotations

import numpy as np

__all__ = ["subsample", "upsample"]


def subsample(num_frames: int, last_framerate: float,
              new_framerate: float) -> np.ndarray:
    """Frame indices decimating ``last_framerate`` to ``new_framerate``
    (integer step; the reference TODOs a real resampler and never needed
    one — the shipped ratios are 100/12.5 = 8 and 1)."""
    step = int(last_framerate / new_framerate)
    assert step >= 1
    return np.arange(0, num_frames, step)


def upsample(motion: np.ndarray, last_framerate: float,
             new_framerate: float) -> np.ndarray:
    """Linear (alpha-blend) interpolation to an integer-multiple framerate;
    output length = (T-1)*step + 1."""
    step = int(new_framerate / last_framerate)
    assert step >= 1
    alpha = np.linspace(0, 1, step + 1)
    last = np.einsum("l,t...->lt...", 1 - alpha, motion[:-1])
    new = np.einsum("l,t...->lt...", alpha, motion[1:])
    chunks = (last + new)[:-1]                    # [step, T-1, ...]
    out = np.concatenate(chunks.swapaxes(1, 0))   # interleave per frame
    return np.concatenate([out, motion[[-1]]])
