"""Frozen action classifiers of the action-to-motion benchmark
(counterpart of ``ladiff_tpu/models/classifiers.py``), with the reference
torch parameter names, so the released checkpoints load with
``load_state_dict``:

  * ``MotionDiscriminator``, the HumanAct12 GRU (``humanact12_gru.tar``'s
    ``model``: ``recurrent.*``, ``linear1``, ``linear2``): a 2-layer GRU over
    the flattened poses (24 SMPL joints x 3 = 72 inputs) from a zero hidden
    state, the last valid step's output, a tanh(linear) 30-d feature (FID's)
    and linear logits;
  * ``STGCN``, the UESTC classifier (``uestc_rot6d_stgcn.tar``:
    ``data_bn``, ``st_gcn_networks.{i}.{gcn.conv, tcn.0, tcn.2, tcn.3,
    residual.0, residual.1}``, ``edge_importance.{i}``, ``fcn``, the graph
    ``A``): spatial-temporal graph convolutions over the 24-joint SMPL
    skeleton with edge-importance weights, 256-d pooled features (FID's) and
    a 1x1-convolution classifier.

Both run frozen in eval mode (BatchNorm with its running statistics), in
float32.  The GRU is ``nn.GRU``; no Pallas kernel computes either.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["MotionDiscriminator", "STGCN", "STGCNBlock",
           "smpl_graph_adjacency", "stgcn_input_from_feats",
           "load_gru_classifier_checkpoint", "load_stgcn_checkpoint",
           "SMPL_EDGES"]


class MotionDiscriminator(nn.Module):
    """[B, T, F] poses + [B] lengths -> (features [B, 30], logits)."""

    def __init__(self, input_size: int = 72, hidden_size: int = 128,
                 hidden_layer: int = 2, output_size: int = 12):
        super().__init__()
        self.recurrent = nn.GRU(input_size, hidden_size, hidden_layer,
                                batch_first=True)
        self.linear1 = nn.Linear(hidden_size, 30)
        self.linear2 = nn.Linear(30, output_size)

    def forward(self, motion: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        out, _ = self.recurrent(motion.float())       # zero initial state
        T = out.shape[1]
        idx = (lengths.to(out.device).long() - 1).clamp(0, T - 1)
        last = out.gather(1, idx[:, None, None].expand(-1, 1, out.shape[2]))
        feat = torch.tanh(self.linear1(last[:, 0]))
        return feat, self.linear2(feat)


def load_gru_classifier_checkpoint(path: str
                                   ) -> Optional[Dict[str, torch.Tensor]]:
    """The reference GRU classifier checkpoint's state dict (its ``model``
    entry), or None where there is no such file."""
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


# the SMPL kinematic tree's edges (the reference Graph's smpl layout)
SMPL_EDGES = [
    (0, 1), (0, 2), (0, 3), (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9),
    (7, 10), (8, 11), (9, 12), (9, 13), (9, 14), (12, 15), (13, 16), (14, 17),
    (16, 18), (17, 19), (18, 20), (19, 21), (20, 22), (21, 23),
]


def smpl_graph_adjacency(num_nodes: int = 24,
                         strategy: str = "spatial") -> np.ndarray:
    """The normalized adjacency stack [K, V, V] of the reference ``Graph``
    (smpl layout, max_hop 1): self-links and the kinematic tree's edges,
    A D^-1 (a zero column for an isolated node), and the spatial partition
    about joint 0 stacked as [hop-0 root, hop-1 root + centripetal, hop-1
    centrifugal]; "uniform" gives the one normalized matrix."""
    V = num_nodes
    assert V == 24, "the UESTC classifier's graph is the 24-joint SMPL one"
    A = np.zeros((V, V), np.float64)
    for i, j in [(i, i) for i in range(V)] + SMPL_EDGES:
        A[i, j] = A[j, i] = 1
    hop = np.full((V, V), np.inf)
    hop[A > 0] = 1
    np.fill_diagonal(hop, 0)
    deg = A.sum(0)
    Dn = np.zeros_like(A)
    nz = deg > 0
    Dn[nz, nz] = 1.0 / deg[nz]
    AD = A @ Dn
    if strategy == "uniform":
        return AD[None].astype(np.float32)
    out = []
    for h in (0, 1):
        root, close, far = (np.zeros((V, V)) for _ in range(3))
        for i in range(V):
            for j in range(V):
                if hop[j, i] == h:
                    if hop[j, 0] == hop[i, 0]:
                        root[j, i] = AD[j, i]
                    elif hop[j, 0] > hop[i, 0]:
                        close[j, i] = AD[j, i]
                    else:
                        far[j, i] = AD[j, i]
        out += [root] if h == 0 else [root + close, far]
    return np.stack(out).astype(np.float32)


class _GraphConv(nn.Module):
    """``gcn``: a 1x1 convolution to K * C_out channels (K-major), then the
    contraction over the K adjacency slices."""

    def __init__(self, in_channels: int, out_channels: int, K: int):
        super().__init__()
        self.K = K
        self.conv = nn.Conv2d(in_channels, out_channels * K, 1)

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)                                  # [B, K*C, T, V]
        B, KC, T, V = y.shape
        y = y.reshape(B, self.K, KC // self.K, T, V)
        return torch.einsum("bkctv,kvw->bctw", y, A)


class STGCNBlock(nn.Module):
    """One spatial-temporal block on [B, C, T, V]: graph convolution, BN,
    ReLU, a (9 x 1) temporal convolution with ``stride`` on T, BN, the
    residual (identity, a strided 1x1 convolution + BN, or none), ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 temporal_kernel: int = 9, spatial_kernel: int = 3,
                 stride: int = 1, residual: bool = True):
        super().__init__()
        pad = (temporal_kernel - 1) // 2
        self.gcn = _GraphConv(in_channels, out_channels, spatial_kernel)
        self.tcn = nn.Sequential(
            nn.BatchNorm2d(out_channels), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, (temporal_kernel, 1),
                      (stride, 1), (pad, 0)),
            nn.BatchNorm2d(out_channels), nn.Dropout(0.0))
        self.has_residual = residual
        self.residual = None
        if residual and (in_channels != out_channels or stride != 1):
            self.residual = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, (stride, 1)),
                nn.BatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        y = self.tcn(self.gcn(x, A))
        if not self.has_residual:
            res = 0.0
        elif self.residual is None:
            res = x
        else:
            res = self.residual(x)
        return torch.relu(y + res)


class STGCN(nn.Module):
    """[B, T, V, C] pose sequences -> (features [B, 256], logits)."""

    BLOCKS = ((None, 64, 1, False), (64, 64, 1, True), (64, 64, 1, True),
              (64, 64, 1, True), (64, 128, 2, True), (128, 128, 1, True),
              (128, 128, 1, True), (128, 256, 2, True), (256, 256, 1, True),
              (256, 256, 1, True))

    def __init__(self, in_channels: int = 6, num_class: int = 40,
                 num_nodes: int = 24, edge_importance_weighting: bool = True):
        super().__init__()
        A = torch.from_numpy(smpl_graph_adjacency(num_nodes))
        self.register_buffer("A", A)
        self.data_bn = nn.BatchNorm1d(in_channels * num_nodes)
        self.st_gcn_networks = nn.ModuleList([
            STGCNBlock(cin or in_channels, cout, stride=stride,
                       residual=resid)
            for cin, cout, stride, resid in self.BLOCKS])
        self.edge_importance = nn.ParameterList([
            nn.Parameter(torch.ones(A.shape),
                         requires_grad=edge_importance_weighting)
            for _ in self.BLOCKS])
        self.fcn = nn.Conv2d(256, num_class, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T, V, C = x.shape
        y = self.data_bn(x.float().reshape(B, T, V * C).transpose(1, 2))
        y = y.reshape(B, V, C, T).permute(0, 2, 3, 1)     # [B, C, T, V]
        for block, imp in zip(self.st_gcn_networks, self.edge_importance):
            y = block(y, self.A * imp)
        feat = y.mean(dim=(2, 3))                          # [B, 256]
        logits = self.fcn(feat[:, :, None, None])[:, :, 0, 0]
        return feat, logits


def stgcn_input_from_feats(feats: torch.Tensor) -> torch.Tensor:
    """[B, T, 150] rot6d + translation features -> [B, T, 24, 6], the
    reference's slicing: channel-major reshape, translation node dropped."""
    B, T, Fd = feats.shape
    return feats.reshape(B, T, 6, Fd // 6).transpose(2, 3)[:, :, :-1]


def load_stgcn_checkpoint(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """The reference ``uestc_rot6d_stgcn.tar`` state dict (under ``model``
    where it is nested), or None where there is no such file."""
    if not os.path.exists(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd
