"""VQ-VAE motion tokenizer: the 1-D conv stack and its quantizers
(counterpart of ``ladiff_tpu/models/vq.py``).

``Encoder1D`` / ``Decoder1D`` are T2M-GPT's strided-conv encoder and
nearest-upsample decoder over ``[B, C, T]`` (``Conv1d``'s layout; the JAX
package computes channels-last, and ``convert.py`` transposes its kernels).
Their modules sit in the reference's ``nn.Sequential`` slots
(``model.0`` the input conv, ``model.{2+i}`` a down or up stage,
``Resnet1D.model.{j}`` its blocks with ``norm1`` / ``conv1`` / ``norm2`` /
``conv2``), so the reference's encdec state dicts load as they are.
``VQVae`` and ``HumanVQDiff`` take and return motion as ``[B, T, F]``, as the
JAX modules do.

Quantizers: ``orig`` keeps a learned ``codebook`` with the codebook +
beta * commitment loss; the EMA flavours (``ema``, ``ema_reset``) take the
codebook as an argument, kept as an ``EmaState`` that ``ema_init`` /
``ema_update`` advance (``index_add_`` for the JAX ``.at[idx].add``), with
the commitment loss.  The straight-through estimator passes the decoder's
gradient to the encoder.  Random draws come from an explicit
``torch.Generator``, or as the ``noise`` tensor.  Everything here is plain
PyTorch on every device, as the JAX package runs it in XLA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.utils.device import resolve_device

__all__ = ["ResConv1DBlock", "Resnet1D", "Encoder1D", "Decoder1D", "VQVae",
           "HumanVQDiff", "EmaState", "ema_init", "ema_update",
           "nearest_code", "perplexity"]

_ACTS = {"relu": F.relu, "silu": F.silu, "gelu": F.gelu}


class _ChannelLN(nn.LayerNorm):
    """LayerNorm over the channels of [B, C, T]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def _norm(kind: Optional[str], channels: int) -> nn.Module:
    if kind == "LN":
        return _ChannelLN(channels, eps=1e-5)
    if kind == "GN":
        return nn.GroupNorm(32, channels, eps=1e-6)
    if kind is None:
        return nn.Identity()
    raise ValueError(f"norm {kind!r}: LN, GN or None")


class ResConv1DBlock(nn.Module):
    """x + conv2(act(norm2(conv1(act(norm1(x)))))): a dilated 3-tap conv and
    a 1x1 conv."""

    def __init__(self, n_in: int, n_state: int, dilation: int = 1,
                 activation: str = "relu", norm: Optional[str] = None):
        super().__init__()
        self.act = _ACTS[activation]
        self.norm1 = _norm(norm, n_in)
        self.conv1 = nn.Conv1d(n_in, n_state, 3, 1, dilation, dilation)
        self.norm2 = _norm(norm, n_state)
        self.conv2 = nn.Conv1d(n_state, n_in, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.act(self.norm1(x)))
        return x + self.conv2(self.act(self.norm2(h)))


class Resnet1D(nn.Module):
    """``n_depth`` blocks with dilations ``rate ** d``, reversed by
    default."""

    def __init__(self, n_in: int, n_depth: int, dilation_growth_rate: int = 1,
                 reverse_dilation: bool = True, activation: str = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        dil = [dilation_growth_rate ** d for d in range(n_depth)]
        if reverse_dilation:
            dil = dil[::-1]
        self.model = nn.Sequential(*[
            ResConv1DBlock(n_in, n_in, d, activation, norm) for d in dil])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class Encoder1D(nn.Module):
    """[B, input_emb_width, T] -> [B, output_emb_width, T / stride^down_t]:
    kernel-4 stride-2 pad-1 convs, each followed by a ``Resnet1D``."""

    def __init__(self, input_emb_width: int = 263,
                 output_emb_width: int = 512, down_t: int = 3,
                 stride_t: int = 2, width: int = 512, depth: int = 3,
                 dilation_growth_rate: int = 3, activation: str = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        filt, pad = stride_t * 2, stride_t // 2
        blocks = [nn.Conv1d(input_emb_width, width, 3, 1, 1), nn.ReLU()]
        for _ in range(down_t):
            blocks.append(nn.Sequential(
                nn.Conv1d(width, width, filt, stride_t, pad),
                Resnet1D(width, depth, dilation_growth_rate,
                         activation=activation, norm=norm)))
        blocks.append(nn.Conv1d(width, output_emb_width, 3, 1, 1))
        self.model = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class Decoder1D(nn.Module):
    """[B, output_emb_width, L] -> [B, out_feats, L * 2^down_t]: each stage a
    ``Resnet1D``, a nearest x2 upsample and a conv."""

    def __init__(self, out_feats: int = 263, output_emb_width: int = 512,
                 down_t: int = 3, width: int = 512, depth: int = 3,
                 dilation_growth_rate: int = 3, activation: str = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        blocks = [nn.Conv1d(output_emb_width, width, 3, 1, 1), nn.ReLU()]
        for _ in range(down_t):
            blocks.append(nn.Sequential(
                Resnet1D(width, depth, dilation_growth_rate,
                         activation=activation, norm=norm),
                nn.Upsample(scale_factor=2, mode="nearest"),
                nn.Conv1d(width, width, 3, 1, 1)))
        blocks += [nn.Conv1d(width, width, 3, 1, 1), nn.ReLU(),
                   nn.Conv1d(width, out_feats, 3, 1, 1)]
        self.model = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


# -- quantizers --------------------------------------------------------------

def nearest_code(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """argmin_k ||x - c_k||^2: codebook [K, C], x [..., C] -> int64 [...]."""
    flat = x.reshape(-1, x.shape[-1])
    d = ((flat ** 2).sum(-1, keepdim=True) - 2.0 * flat @ codebook.T
         + (codebook ** 2).sum(-1)[None, :])
    return d.argmin(dim=-1).reshape(x.shape[:-1])


def perplexity(code_idx: torch.Tensor, nb_code: int) -> torch.Tensor:
    """exp(H[code usage])."""
    counts = torch.zeros(nb_code, device=code_idx.device).index_add_(
        0, code_idx.reshape(-1),
        torch.ones(code_idx.numel(), device=code_idx.device))
    prob = counts / counts.sum()
    return torch.exp(-(prob * torch.log(prob + 1e-7)).sum())


@dataclass(frozen=True)
class EmaState:
    """The EMA codebook: entries, their running sums and counts."""

    codebook: torch.Tensor    # [K, C]
    code_sum: torch.Tensor    # [K, C]
    code_count: torch.Tensor  # [K]


def _tiled(flat: torch.Tensor, K: int) -> torch.Tensor:
    """The rows of ``flat`` repeated to at least K rows."""
    return flat.repeat(-(-K // flat.shape[0]), 1)


def _draw(shape, like: torch.Tensor, noise, generator) -> torch.Tensor:
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=like.device,
                            dtype=like.dtype)
    return noise.to(device=like.device, dtype=like.dtype)


def ema_init(x: torch.Tensor, nb_code: int,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> EmaState:
    """The encoder's outputs tiled to ``nb_code`` rows plus Gaussian noise
    of std 0.01 / sqrt(C) seed the codebook.  ``noise`` has the tiled
    shape [ceil(K / n) n, C] (drawn from ``generator`` when None)."""
    flat = x.reshape(-1, x.shape[-1])
    out = _tiled(flat, nb_code)
    out = out + _draw(out.shape, out, noise, generator) * (
        0.01 / flat.shape[1] ** 0.5)
    codebook = out[:nb_code]
    return EmaState(codebook=codebook, code_sum=codebook,
                    code_count=torch.ones(nb_code, device=x.device))


def ema_update(state: EmaState, x: torch.Tensor, code_idx: torch.Tensor,
               mu: float, generator: Optional[torch.Generator] = None,
               reset: bool = True,
               noise: Optional[torch.Tensor] = None) -> EmaState:
    """One EMA step of the codebook; with ``reset``, codes used less than
    once (by the running count) restart at a batch row plus noise of std
    0.01 / sqrt(C).  ``noise`` [K, C] is that draw (from ``generator`` when
    None)."""
    flat = x.reshape(-1, x.shape[-1])
    idx = code_idx.reshape(-1)
    K, c = state.codebook.shape
    batch_sum = torch.zeros_like(state.code_sum).index_add_(0, idx, flat)
    batch_count = torch.zeros_like(state.code_count).index_add_(
        0, idx, torch.ones(idx.numel(), device=flat.device,
                           dtype=state.code_count.dtype))
    code_sum = mu * state.code_sum + (1 - mu) * batch_sum
    code_count = mu * state.code_count + (1 - mu) * batch_count
    codebook = code_sum / code_count[:, None]
    if reset:
        rand = _tiled(flat, K)[:K] + _draw((K, c), flat, noise, generator) * (
            0.01 / c ** 0.5)
        codebook = torch.where((code_count >= 1.0)[:, None], codebook, rand)
    return EmaState(codebook=codebook, code_sum=code_sum,
                    code_count=code_count)


class VQVae(nn.Module):
    """Conv encoder -> quantizer -> conv decoder over [B, T, F] motion."""

    def __init__(self, nfeats: int = 263, nb_code: int = 1024,
                 code_dim: int = 512, output_emb_width: int = 512,
                 down_t: int = 3, stride_t: int = 2, width: int = 512,
                 depth: int = 3, dilation_growth_rate: int = 3,
                 activation: str = "relu", norm: Optional[str] = None,
                 quantizer: str = "orig", beta: float = 1.0, device=None):
        super().__init__()
        if code_dim != output_emb_width:
            raise ValueError("codebook entries live in the encoder's output "
                             "space: code_dim must equal output_emb_width")
        self.nb_code = nb_code
        self.quantizer = quantizer
        self.beta = beta
        stack = dict(down_t=down_t, width=width, depth=depth,
                     dilation_growth_rate=dilation_growth_rate,
                     activation=activation, norm=norm)
        self.encoder = Encoder1D(nfeats, output_emb_width, stride_t=stride_t,
                                 **stack)
        self.decoder = Decoder1D(nfeats, output_emb_width, **stack)
        if quantizer == "orig":
            self.codebook = nn.Parameter(torch.empty(nb_code, code_dim)
                                         .uniform_(-1.0 / nb_code,
                                                   1.0 / nb_code))
        self.to(resolve_device(device))

    def _codebook(self, codebook: Optional[torch.Tensor]) -> torch.Tensor:
        """The codebook in the compute type (an EMA state may be kept in
        float32 while the model computes in bf16)."""
        dtype = self.encoder.model[0].weight.dtype
        if codebook is not None:
            return codebook.to(dtype)
        if self.quantizer != "orig":
            raise ValueError("the EMA quantizers take the codebook as an "
                             "argument (EmaState.codebook)")
        return self.codebook.to(dtype)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, F] -> [B, L, C]."""
        w = self.encoder.model[0].weight
        return self.encoder(x.to(w.dtype).transpose(1, 2)).transpose(1, 2)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, L, C] -> [B, T, F]."""
        return self.decoder(z.transpose(1, 2)).transpose(1, 2)

    def encode(self, x: torch.Tensor,
               codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, T, F] motion -> [B, L] code indices."""
        return nearest_code(self._codebook(codebook), self._encode(x))

    def decode_codes(self, code_idx: torch.Tensor,
                     codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, L] indices -> [B, T, F] motion."""
        return self._decode(self._codebook(codebook)[code_idx])

    def forward(self, x: torch.Tensor,
                codebook: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
        """(x_out [B, T, F], loss, perplexity, code_idx [B, L])."""
        z = self._encode(x)
        cb = self._codebook(codebook)
        idx = nearest_code(cb, z)
        z_q = cb[idx]
        if self.quantizer == "orig":
            loss = (((z_q - z.detach()) ** 2).mean()
                    + self.beta * ((z_q.detach() - z) ** 2).mean())
        else:
            loss = ((z - z_q.detach()) ** 2).mean()
        z_q = z + (z_q - z).detach()  # straight-through
        return self._decode(z_q), loss, perplexity(idx, self.nb_code), idx


class HumanVQDiff(nn.Module):
    """The reference HumanVQDIFF's surface over ``vqvae``."""

    def __init__(self, nfeats: int = 263, nb_code: int = 512,
                 code_dim: int = 512, quantizer: str = "orig", device=None):
        super().__init__()
        self.vqvae = VQVae(nfeats=nfeats, nb_code=nb_code, code_dim=code_dim,
                           quantizer=quantizer, device=device)

    def encode(self, x, codebook=None):
        return self.vqvae.encode(x, codebook)

    def forward(self, x, codebook=None):
        return self.vqvae(x, codebook)

    def forward_decoder(self, code_idx, codebook=None):
        return self.vqvae.decode_codes(code_idx, codebook)
