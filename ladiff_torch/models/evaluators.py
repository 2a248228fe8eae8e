"""T2M evaluator encoders (frozen, eval-only; counterpart of
``ladiff_tpu/models/evaluators.py``): the conv movement encoder and the
bidirectional-GRU motion and text encoders.

The modules are the reference's (``t2m_motionenc.py``, ``t2m_textenc.py``)
with their parameter names (``main.0`` / ``main.3`` convs, ``out_net``,
``input_emb``, ``pos_emb``, ``gru``, ``hidden``, ``output_net.{0,1,3}``),
so a ``finest.tar`` loads with ``load_state_dict(strict=True)``.  The GRU is
``nn.GRU`` over ``pack_padded_sequence`` (``enforce_sorted=False``, so the
batch needs no length sort), on the card cuDNN's: the JAX package computes
it as a ``lax.scan`` outside any Pallas kernel.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

__all__ = ["MovementConvEncoder", "MotionEncoderBiGRUCo",
           "TextEncoderBiGRUCo", "load_t2m_checkpoint"]


class MovementConvEncoder(nn.Module):
    """Two stride-2 conv blocks + linear (reference t2m_motionenc.py:6-25):
    [B, T, F - 4] -> [B, T // 4, output_size].

    ``valid_length`` (an int) is the batch's longest length: the reference
    collates each batch to it (data/utils.py:12), so the windows at the
    boundary read the convs' zero padding, not the padded frames (whose
    renormed values are not zero).  The input is cropped to it; below the 4
    frames one window reads, the crop keeps 4 rows and zeroes the rows past
    ``valid_length`` and the first conv's rows past (valid_length - 2) // 2
    + 1, as the JAX package's masks do, where the reference's conv would
    refuse the input."""

    def __init__(self, input_size: int, hidden_size: int = 512,
                 output_size: int = 512):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1),
            nn.Dropout(0.2),
            nn.LeakyReLU(0.2),
            nn.Conv1d(hidden_size, output_size, 4, 2, 1),
            nn.Dropout(0.2),
            nn.LeakyReLU(0.2),
        )
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, inputs: torch.Tensor,
                valid_length: Optional[int] = None) -> torch.Tensor:
        x = inputs
        l1 = None
        if valid_length is not None:
            valid_length = int(valid_length)
            n = max(valid_length, 4)
            x = x[:, :n]
            if n > valid_length:
                rows = torch.arange(n, device=x.device)[None, :, None]
                x = x.masked_fill(rows >= valid_length, 0.0)
                l1 = (valid_length - 2) // 2 + 1
        h = self.main[:3](x.transpose(1, 2))
        if l1 is not None:
            cols = torch.arange(h.shape[-1], device=h.device)
            h = h.masked_fill(cols >= l1, 0.0)
        h = self.main[3:](h)
        return self.out_net(h.transpose(1, 2))


class _BiGRUCo(nn.Module):
    """input_emb -> BiGRU (final hidden of both directions) -> output_net."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True,
                          bidirectional=True)
        self.output_net = nn.Sequential(
            nn.Linear(hidden_size * 2, hidden_size),
            nn.LayerNorm(hidden_size),
            nn.LeakyReLU(0.2),
            nn.Linear(hidden_size, output_size),
        )
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))

    def _encode(self, inputs: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        x = self.input_emb(inputs)
        h0 = self.hidden.expand(-1, x.shape[0], -1).contiguous()
        packed = pack_padded_sequence(x, lengths.cpu().long(),
                                      batch_first=True, enforce_sorted=False)
        _, last = self.gru(packed, h0)
        return self.output_net(torch.cat([last[0], last[1]], dim=-1))


class MotionEncoderBiGRUCo(_BiGRUCo):
    """reference t2m_motionenc.py:28-64; hidden 1024, output 512."""

    def __init__(self, input_size: int = 512, hidden_size: int = 1024,
                 output_size: int = 512):
        super().__init__(input_size, hidden_size, output_size)

    def forward(self, movements: torch.Tensor,
                m_lens: torch.Tensor) -> torch.Tensor:
        return self._encode(movements, m_lens)


class TextEncoderBiGRUCo(_BiGRUCo):
    """reference t2m_textenc.py:6-48; hidden 512, output 512."""

    def __init__(self, word_size: int = 300, pos_size: int = 15,
                 hidden_size: int = 512, output_size: int = 512):
        super().__init__(word_size, hidden_size, output_size)
        self.pos_emb = nn.Linear(pos_size, word_size)

    def forward(self, word_embs: torch.Tensor, pos_ohot: torch.Tensor,
                cap_lens: torch.Tensor) -> torch.Tensor:
        return self._encode(word_embs + self.pos_emb(pos_ohot), cap_lens)


def load_t2m_checkpoint(path: str) -> Optional[Dict[str, Dict]]:
    """The reference ``finest.tar`` (its ``text_encoder``,
    ``movement_encoder`` and ``motion_encoder`` state dicts; reference
    ladiff.py:203-212) as ``{"text", "movement", "motion"}`` state dicts of
    the modules above, or None where the file is missing."""
    if not os.path.exists(path):
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {"text": ckpt["text_encoder"],
            "movement": ckpt["movement_encoder"],
            "motion": ckpt["motion_encoder"]}
