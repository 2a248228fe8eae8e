"""SMPL transform + datastructs: lazy conversion graph
features/rfeats <-> rots <-> joints <-> jfeats.

Host-side numpy: the counterpart of ``ladiff_tpu/transforms/smpl.py``,
line for line.

Rebuild of the reference's ladiff/transforms/smpl.py:13-125 (minus the
vendored-smplx SMPL class — the body model lives in ladiff_torch/smpl/).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ladiff_torch.transforms.base import Datastruct, Transform

__all__ = ["SMPLTransform", "SMPLDatastruct", "RotTransDatastruct",
           "RotIdentityTransform"]


class RotIdentityTransform(Transform):
    """reference smpl.py:32-40."""

    def Datastruct(self, **kwargs):
        return RotTransDatastruct(**kwargs)

    def __repr__(self):
        return "RotIdentityTransform()"


@dataclass
class RotTransDatastruct(Datastruct):
    """Raw SMPL state: rots [..., J, 3, 3] + trans [..., 3]
    (reference smpl.py:43-55)."""

    rots: Any = None
    trans: Any = None
    transforms: Any = None

    def __post_init__(self):
        self.datakeys = ["rots", "trans"]
        if self.transforms is None:
            self.transforms = RotIdentityTransform()

    def __len__(self):
        return len(self.rots)


class SMPLTransform(Transform):
    """reference smpl.py:13-29."""

    def __init__(self, rots2rfeats=None, rots2joints=None,
                 joints2jfeats=None) -> None:
        if rots2rfeats is None:
            from ladiff_torch.transforms.rots2rfeats import SMPLVelP
            rots2rfeats = SMPLVelP()
        if rots2joints is None:
            from ladiff_torch.transforms.rots2joints import SMPLH
            rots2joints = SMPLH()
        if joints2jfeats is None:
            from ladiff_torch.transforms.joints2jfeats import Rifke
            joints2jfeats = Rifke()
        self.rots2rfeats = rots2rfeats
        self.rots2joints = rots2joints
        self.joints2jfeats = joints2jfeats

    def Datastruct(self, **kwargs):
        return SMPLDatastruct(_rots2rfeats=self.rots2rfeats,
                              _rots2joints=self.rots2joints,
                              _joints2jfeats=self.joints2jfeats,
                              transforms=self, **kwargs)

    def __repr__(self):
        return "SMPLTransform()"


@dataclass
class SMPLDatastruct(Datastruct):
    """Lazily materializes every representation from whichever field was
    provided (reference smpl.py:58-125)."""

    transforms: Any = None
    _rots2rfeats: Any = None
    _rots2joints: Any = None
    _joints2jfeats: Any = None

    features: Optional[Any] = None
    rots_: Optional[RotTransDatastruct] = None
    rfeats_: Optional[Any] = None
    joints_: Optional[Any] = None
    jfeats_: Optional[Any] = None

    def __post_init__(self):
        self.datakeys = ["features", "rots_", "rfeats_", "joints_",
                         "jfeats_"]
        if self.features is not None and self.rfeats_ is None:
            self.rfeats_ = self.features

    @property
    def rots(self) -> RotTransDatastruct:
        if self.rots_ is None:
            assert self.rfeats_ is not None
            self.rots_ = self._rots2rfeats.inverse(self.rfeats)
        return self.rots_

    @property
    def rfeats(self):
        if self.rfeats_ is None:
            assert self.rots_ is not None
            self.rfeats_ = self._rots2rfeats(self.rots)
        return self.rfeats_

    @property
    def joints(self):
        if self.joints_ is None:
            self.joints_ = self._rots2joints(self.rots)
        return self.joints_

    @property
    def jfeats(self):
        if self.jfeats_ is None:
            self.jfeats_ = self._joints2jfeats(self.joints)
        return self.jfeats_

    def __len__(self):
        return len(self.rfeats)
