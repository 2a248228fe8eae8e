"""HumanML3D/KIT feature decoding (counterpart of
``ladiff_tpu/data/humanml/motion_repr.py``).

Feature layout (263 for 22 joints): [root rot-vel (1) | root lin-vel xz (2)
| root height (1) | ric (J-1)*3 | rot6d (J-1)*6 | local vel J*3 | foot
contacts (4)].  ``recover_from_ric`` integrates the root rotation and
translation and rigid-transforms the root-relative joint positions.
"""
from __future__ import annotations

import torch

from ladiff_torch.data.humanml.quaternion import qinv, qrot

__all__ = ["recover_root_rot_pos", "recover_from_ric"]


def recover_root_rot_pos(data: torch.Tensor):
    """[..., T, F] features -> (r_rot_quat [..., T, 4], r_pos [..., T, 3])."""
    rot_vel = data[..., 0]
    shifted = torch.cat([torch.zeros_like(rot_vel[..., :1]),
                         rot_vel[..., :-1]], dim=-1)
    r_rot_ang = torch.cumsum(shifted, dim=-1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros,
                              torch.sin(r_rot_ang), zeros], dim=-1)
    vel_xz = data[..., 1:3]
    vel_xz = torch.cat([torch.zeros_like(vel_xz[..., :1, :]),
                        vel_xz[..., :-1, :]], dim=-2)
    r_pos = torch.stack([vel_xz[..., 0], torch.zeros_like(vel_xz[..., 0]),
                         vel_xz[..., 1]], dim=-1)
    r_pos = torch.cumsum(qrot(qinv(r_rot_quat), r_pos), dim=-2)
    r_pos = torch.cat([r_pos[..., :1], data[..., 3:4], r_pos[..., 2:]],
                      dim=-1)
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """Features [..., T, F] -> joint positions [..., T, J, 3]."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4:(joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    q = qinv(r_rot_quat)[..., None, :].expand(
        positions.shape[:-1] + (4,))
    positions = qrot(q, positions)
    offset = torch.stack([r_pos[..., 0], torch.zeros_like(r_pos[..., 0]),
                          r_pos[..., 2]], dim=-1)
    positions = positions + offset[..., None, :]
    return torch.cat([r_pos[..., None, :], positions], dim=-2)
