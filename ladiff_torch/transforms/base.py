"""Datastruct / Transform base classes.

Host-side numpy: the counterpart of ``ladiff_tpu/transforms/base.py``,
line for line.

Rebuild of the reference's ladiff/transforms/base.py:1-68: a dict-like
dataclass whose fields are lazily converted between representations
(features <-> rots <-> joints <-> jfeats), plus the Transform factory that
collates lists of datastructs with padding.  Arrays are numpy (the transform
stack is an offline tool; nothing here needs a device).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

__all__ = ["Datastruct", "Transform", "collate_tensor_with_padding"]


def collate_tensor_with_padding(arrays) -> np.ndarray:
    """Stack variable-shape arrays zero-padded to the per-dim max
    (reference datasets/utils.py collate_tensor_with_padding)."""
    arrays = [np.asarray(a) for a in arrays]
    dims = max(a.ndim for a in arrays)
    size = [len(arrays)] + [
        max(a.shape[d] for a in arrays) for d in range(dims)]
    out = np.zeros(size, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


@dataclass
class Datastruct:
    """Dict-style access over dataclass fields; subclasses define
    ``datakeys`` in __post_init__ (reference base.py:22-68)."""

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, value):
        self.__dict__[key] = value

    def get(self, key, default=None):
        return getattr(self, key, default)

    def __iter__(self):
        return self.keys()

    def keys(self):
        return iter([t.name for t in fields(self)])

    def values(self):
        return iter([getattr(self, t.name) for t in fields(self)])

    def items(self):
        return iter([(t.name, getattr(self, t.name)) for t in fields(self)])

    def to(self, *args, **kwargs):  # device no-op (numpy backend)
        return self

    def detach(self):
        kwargs = {key: self[key] for key in self.datakeys}
        return self.transforms.Datastruct(**kwargs)


class Transform:
    """Factory base: subclasses provide ``Datastruct(**kwargs)``."""

    def collate(self, lst_datastruct):
        example = lst_datastruct[0]

        def collate_or_none(key):
            vals = [x[key] for x in lst_datastruct]
            # only collate keys materialized as arrays on every element
            if any(v is None or not hasattr(v, "shape") for v in vals):
                return None
            return collate_tensor_with_padding(vals)

        kwargs = {key: collate_or_none(key) for key in example.datakeys}
        return self.Datastruct(**kwargs)
