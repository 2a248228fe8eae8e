"""Operator extras: AdaIN, the MUNIT-style blocks and the Hessian penalty
(counterpart of ``ladiff_tpu/ops/extras.py``).

Sequences are ``[B, C, T]`` (``Conv1d``'s layout; the JAX package computes
channels-last and ``convert.py`` transposes its kernels).  AdaIN takes its
style (weight, bias) as arguments; ``hessian_penalty`` draws its Rademacher
directions from an explicit generator, or takes them as ``directions``.
``LinearBlock``'s BatchNorm always uses its running averages, as the JAX
block does.  Parameter names are the JAX modules' in torch form
(``linear``, ``norm``, ``conv``, ``in_scale`` / ``in_bias``, ``block.{i}``,
``out``).  Plain PyTorch on every device.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["adaptive_instance_norm_1d", "split_adain_params",
           "num_adain_params", "LinearBlock", "ConvBlock", "MLP",
           "hessian_penalty"]


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Each (sample, channel) series of [B, C, T] normalized over time
    (biased variance)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def adaptive_instance_norm_1d(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, eps: float = 1e-5,
                              direct_weighting: bool = False,
                              no_std: bool = False) -> torch.Tensor:
    """AdaIN over [B, C, T]: instance-normalize, then scale and shift by the
    per-sample style ``weight``, ``bias`` [B, C]; with
    ``direct_weighting`` no normalization (and with ``no_std`` no scale)."""
    if direct_weighting:
        out = x if no_std else x * weight[:, :, None]
        return out + bias[:, :, None]
    return _instance_norm(x, eps) * weight[:, :, None] + bias[:, :, None]


def num_adain_params(channel_sizes: Sequence[int]) -> int:
    """2 C parameters per AdaIN site."""
    return 2 * sum(channel_sizes)


def split_adain_params(adain_params: torch.Tensor,
                       channel_sizes: Sequence[int]
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """A [B, sum(2 C)] style vector -> per-site (mean, std) pairs, mean
    first."""
    out, off = [], 0
    for c in channel_sizes:
        out.append((adain_params[:, off:off + c],
                    adain_params[:, off + c:off + 2 * c]))
        off += 2 * c
    return out


_ACTS = {"relu": F.relu, "lrelu": lambda x: F.leaky_relu(x, 0.2),
         "tanh": torch.tanh, "none": lambda x: x}


class LinearBlock(nn.Module):
    """Linear + norm ("bn": BatchNorm on its running averages, eps 1e-5;
    "in": LayerNorm, eps 1e-6; "none") + activation."""

    def __init__(self, in_dim: int, out_dim: int, norm: str = "none",
                 acti: str = "relu"):
        super().__init__()
        self.acti = _ACTS[acti]
        self.linear = nn.Linear(in_dim, out_dim)
        self.norm = {"bn": lambda: nn.BatchNorm1d(out_dim, eps=1e-5),
                     "in": lambda: nn.LayerNorm(out_dim, eps=1e-6),
                     "none": lambda: None}[norm]()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x)
        if isinstance(self.norm, nn.BatchNorm1d):
            n = self.norm
            x = F.batch_norm(x, n.running_mean, n.running_var, n.weight,
                             n.bias, training=False, eps=n.eps)
        elif self.norm is not None:
            x = self.norm(x)
        return self.acti(x)


class ConvBlock(nn.Module):
    """Pad ("reflect", "replicate" or "zero"; (k - 1) // 2 on the left, the
    rest on the right) + ``Conv1d`` + norm ("adain" with the style passed
    to ``forward``, "in" an affine instance norm, or "none") + activation,
    over [B, C, T]."""

    def __init__(self, in_channels: int, kernel_size: int, out_channels: int,
                 stride: int = 1, pad_type: str = "reflect",
                 norm: str = "none", acti: str = "lrelu"):
        super().__init__()
        self.pad = ((kernel_size - 1) // 2, kernel_size - 1
                    - (kernel_size - 1) // 2)
        self.mode = {"reflect": "reflect", "replicate": "replicate",
                     "zero": "constant"}[pad_type]
        self.norm = norm
        self.acti = _ACTS[acti]
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride)
        if norm == "in":
            self.in_scale = nn.Parameter(torch.ones(out_channels))
            self.in_bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor,
                adain_style: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        x = self.conv(F.pad(x, self.pad, mode=self.mode))
        if self.norm == "adain":
            if adain_style is None:
                raise ValueError("pass adain_style=(weight, bias) for "
                                 "norm='adain'")
            x = adaptive_instance_norm_1d(x, *adain_style)
        elif self.norm == "in":
            x = (_instance_norm(x) * self.in_scale[:, None]
                 + self.in_bias[:, None])
        return self.acti(x)


class MLP(nn.Module):
    """``LinearBlock``s over the flattened input: dims[0] -> dims[1] ... ->
    dims[-1] with ``acti``, then ``out`` to ``out_dim`` with none."""

    def __init__(self, dims: Sequence[int], out_dim: int,
                 acti: str = "lrelu"):
        super().__init__()
        self.block = nn.ModuleList([
            LinearBlock(a, b, acti=acti) for a, b in zip(dims[:-1], dims[1:])])
        self.out = LinearBlock(dims[-1], out_dim, acti="none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for blk in self.block:
            x = blk(x)
        return self.out(x)


def hessian_penalty(G: Callable, z: torch.Tensor, k: int = 2,
                    epsilon: float = 0.1, reduction: Callable = torch.max,
                    generator: Optional[torch.Generator] = None,
                    directions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Finite-difference Hessian penalty (arXiv:2008.10599): the variance
    over k Rademacher directions of the central second directional
    derivative of G at z, reduced to a scalar and summed over G's outputs
    (G returns a tensor or a list of tensors).  ``directions`` [k, *z.shape]
    of +-1 (drawn from ``generator`` when None).  Differentiable through
    G's parameters."""
    G_z = G(z)
    single = not isinstance(G_z, (list, tuple))
    G_z = [G_z] if single else list(G_z)
    if directions is None:
        directions = torch.randint(0, 2, (k,) + tuple(z.shape),
                                   generator=generator,
                                   device=z.device) * 2 - 1
    dzs = epsilon * directions.to(device=z.device, dtype=z.dtype)

    def second(dz):
        plus, minus = G(z + dz), G(z - dz)
        plus = [plus] if single else list(plus)
        minus = [minus] if single else list(minus)
        return [(p - 2 * g + m) / epsilon ** 2
                for p, g, m in zip(plus, G_z, minus)]

    seconds = [second(dzs[i]) for i in range(k)]
    total = 0.0
    for acts in zip(*seconds):
        total = total + reduction(torch.stack(acts).var(dim=0, unbiased=True))
    return total
