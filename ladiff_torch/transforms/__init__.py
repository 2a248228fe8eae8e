"""The TEMOS transform stack (rots / joints / features datastructs),
counterpart of ``ladiff_tpu/transforms``: feature math in numpy on the
host, the SMPL-H LBS of ``SMPLH`` in PyTorch on the card; and
``rotation2xyz``, the action family's SMPL pass.

``SMPLH`` is imported on first use, so the numpy modules (``geometry``,
``joints2jfeats``, ...) import without torch: the Blender preparation
imports ``geometry`` inside Blender's own Python."""
from ladiff_torch.transforms.base import (Datastruct, Transform,
                                          collate_tensor_with_padding)
from ladiff_torch.transforms.joints2jfeats import Rifke
from ladiff_torch.transforms.rots2rfeats import SMPLVelP
from ladiff_torch.transforms.smpl import (RotIdentityTransform,
                                          RotTransDatastruct, SMPLDatastruct,
                                          SMPLTransform)

__all__ = [
    "Datastruct", "Transform", "collate_tensor_with_padding",
    "Rifke", "SMPLH", "SMPLVelP",
    "RotIdentityTransform", "RotTransDatastruct", "SMPLDatastruct",
    "SMPLTransform",
]


def __getattr__(name):
    if name == "SMPLH":
        from ladiff_torch.transforms.rots2joints import SMPLH
        return SMPLH
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
