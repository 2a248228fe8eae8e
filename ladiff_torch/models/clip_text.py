"""Frozen CLIP ViT-L/14 text tower (counterpart of
``ladiff_tpu/models/clip_text.py``).

Pre-LN layers with quick-GELU, a causal mask, EOT pooling (the highest token
id) and the text projection; vocab 49408, width 768, 12 layers, 12 heads,
context 77.  Module and parameter names are HuggingFace's
(``text_model.encoder.layers.i.self_attn.q_proj``, ``layer_norm1``,
``mlp.fc1``, ``text_model.final_layer_norm``, ``text_projection``), so an HF
``CLIPTextModelWithProjection`` state dict loads as it is.  Each layer runs
as kernel K3 (LN1 + q/k/v), the causal attention core in plain PyTorch (as
the JAX package leaves it to XLA), and kernel K4 (out-proj + MLP).
"""
from __future__ import annotations

import functools
import html
import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ladiff_torch.ops.clip_layer import (fused_ln_qkv, fused_proj_mlp,
                                         ln_qkv_plain, proj_mlp_plain)
from ladiff_torch.ops.cuda_common import NEG_INF, kernel_route
from ladiff_torch.utils.device import resolve_device, resolve_dtype

__all__ = ["CLIPTextTower", "ClipTextEncoder", "HashTokenizer",
           "BPETokenizer"]


class _CLIPAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)


class _CLIPMLP(nn.Module):
    def __init__(self, width: int, ff: int):
        super().__init__()
        self.fc1 = nn.Linear(width, ff)
        self.fc2 = nn.Linear(ff, width)


class CLIPTextLayer(nn.Module):
    """One pre-LN CLIP text block (HF ``CLIPEncoderLayer`` semantics)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.self_attn = _CLIPAttention(width)
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _CLIPMLP(width, 4 * width)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)

    def qkv_params(self) -> dict:
        a = self.self_attn
        return {"wq": a.q_proj.weight, "bq": a.q_proj.bias,
                "wk": a.k_proj.weight, "bk": a.k_proj.bias,
                "wv": a.v_proj.weight, "bv": a.v_proj.bias,
                "ln_w": self.layer_norm1.weight,
                "ln_b": self.layer_norm1.bias}

    def mlp_params(self) -> dict:
        return {"wo": self.self_attn.out_proj.weight,
                "bo": self.self_attn.out_proj.bias,
                "w1": self.mlp.fc1.weight, "b1": self.mlp.fc1.bias,
                "w2": self.mlp.fc2.weight, "b2": self.mlp.fc2.bias,
                "ln_w": self.layer_norm2.weight,
                "ln_b": self.layer_norm2.bias}

    def attention_core(self, q, k, v, causal_mask):
        """[B, S, D] q (pre-scaled), k, v -> [B, S, D]."""
        B, S, D = q.shape
        H = self.heads
        qh, kh, vh = (a.reshape(B, S, H, D // H).transpose(1, 2)
                      for a in (q, k, v))
        logits = torch.matmul(qh, kh.transpose(-1, -2)).float()
        logits = logits.masked_fill(~causal_mask, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.matmul(w, vh).transpose(1, 2).reshape(B, S, D)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor
                ) -> torch.Tensor:
        B, S, D = x.shape
        xf = x.reshape(B * S, D).contiguous()
        # K3 and K4 in bf16; a float32 tower on the card runs their plain
        # versions (the kernels take bf16 only, as the JAX package's take
        # a 2-byte type only)
        ln_qkv, proj_mlp = ((fused_ln_qkv, fused_proj_mlp)
                            if kernel_route(xf, "fused_ln_qkv")
                            else (ln_qkv_plain, proj_mlp_plain))
        q, k, v = ln_qkv(xf, self.qkv_params(),
                         scale=1.0 / math.sqrt(D // self.heads))
        att = self.attention_core(q.reshape(B, S, D), k.reshape(B, S, D),
                                  v.reshape(B, S, D), causal_mask)
        out = proj_mlp(att.reshape(B * S, D).contiguous(), xf,
                       self.mlp_params())
        return out.reshape(B, S, D)


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, width: int, context_length: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Embedding(context_length, width)


class _Encoder(nn.Module):
    def __init__(self, width: int, num_layers: int, heads: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPTextLayer(width, heads) for _ in range(num_layers)])


class _TextModel(nn.Module):
    def __init__(self, vocab_size, width, num_layers, heads, context_length):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, width, context_length)
        self.encoder = _Encoder(width, num_layers, heads)
        self.final_layer_norm = nn.LayerNorm(width, eps=1e-5)


class CLIPTextTower(nn.Module):
    def __init__(self, vocab_size: int = 49408, width: int = 768,
                 num_layers: int = 12, heads: int = 12,
                 context_length: int = 77, projection_dim: int = 768):
        super().__init__()
        self.text_model = _TextModel(vocab_size, width, num_layers, heads,
                                     context_length)
        self.text_projection = nn.Linear(width, projection_dim, bias=False)
        emb = self.text_model.embeddings
        nn.init.normal_(emb.token_embedding.weight, std=0.02)
        nn.init.normal_(emb.position_embedding.weight, std=0.01)
        nn.init.normal_(self.text_projection.weight, std=width ** -0.5)

    def forward(self, input_ids: torch.Tensor,
                return_hidden: bool = False) -> torch.Tensor:
        """input_ids [B, S] int -> pooled + projected [B, projection_dim]
        (or the last hidden state [B, S, width])."""
        B, S = input_ids.shape
        tm = self.text_model
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[:S][None])
        causal = torch.ones(S, S, dtype=torch.bool,
                            device=input_ids.device).tril()
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x)
        if return_hidden:
            return x
        eot = input_ids.argmax(dim=-1)
        pooled = x[torch.arange(B, device=x.device), eot]
        return self.text_projection(pooled)


# ---------------------------------------------------------------------------
# Tokenization (a copy of the JAX package's tokenizers)
# ---------------------------------------------------------------------------
class HashTokenizer:
    """Deterministic fallback when the CLIP BPE vocab is unavailable.

    Maps each whitespace word to a stable id in the CLIP vocab range; keeps
    the start/end token convention (ids 49406/49407) so EOT pooling works.
    """

    sot = 49406
    eot = 49407

    def __init__(self, context_length: int = 77):
        self.context_length = context_length

    def __call__(self, texts: List[str]) -> np.ndarray:
        import hashlib

        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            words = html.unescape(t.lower().strip()).split()
            ids = [self.sot]
            for w in words[: self.context_length - 2]:
                h = int.from_bytes(
                    hashlib.sha256(w.encode()).digest()[:4], "little")
                ids.append(1 + h % (self.sot - 1))
            ids.append(self.eot)
            out[i, :len(ids)] = ids
        return out


class BPETokenizer:
    """Real CLIP byte-pair encoder, loaded from a local
    ``bpe_simple_vocab_16e6.txt.gz`` or HF ``vocab.json``+``merges.txt``."""

    sot = 49406
    eot = 49407

    def __init__(self, vocab_dir: str, context_length: int = 77):
        import json

        self.context_length = context_length
        try:
            # CLIP's exact pattern needs unicode classes (\p{L}/\p{N}),
            # which the stdlib re lacks; the regex module ships with HF
            # transformers (parity vs CLIPTokenizer pinned in
            # tests/test_clip.py::test_bpe_matches_hf_clip_tokenizer)
            import regex as re_mod
            self._re = re_mod.compile(
                r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", re_mod.IGNORECASE)
        except ImportError:  # ASCII approximation (fine for HumanML3D/KIT)
            import re as re_mod
            self._re = re_mod.compile(
                r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+", re_mod.IGNORECASE)
        vocab_json = os.path.join(vocab_dir, "vocab.json")
        merges_txt = os.path.join(vocab_dir, "merges.txt")
        with open(vocab_json) as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [m for m in merges if m and not m.startswith("#version")]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.cache: Dict[str, str] = {}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text)).strip().lower()
        ids: List[int] = []
        for token in self._re.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" ")
                       if t in self.encoder)
        return ids

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: self.context_length - 2] + [self.eot]
            out[i, :len(ids)] = ids
        return out


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# ---------------------------------------------------------------------------
# Wrapper mirroring MldTextEncoder
# ---------------------------------------------------------------------------

class ClipTextEncoder:
    """texts -> [B, 1, 768] pooled features.

    Pooled mode runs the batch at the smallest context bucket that covers
    its longest caption: with causal attention and EOT pooling the pooled
    feature does not depend on trailing padding.  ``last_hidden_state`` mode
    keeps the full context.  A subclass sets another tower geometry
    (``tower_geometry``, ``CLIPTextTower``'s keywords) and feature width."""

    tower_geometry: Dict[str, int] = {}
    text_encoded_dim = 768

    def __init__(self, modelpath: Optional[str] = None,
                 last_hidden_state: bool = False, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 buckets=(16, 32, 77)):
        self.device = resolve_device(device)
        dtype = resolve_dtype(self.device, dtype)
        self.last_hidden_state = last_hidden_state
        if modelpath and os.path.exists(os.path.join(modelpath, "vocab.json")):
            self.tokenizer = BPETokenizer(modelpath)
        else:
            self.tokenizer = HashTokenizer()
        full = self.tokenizer.context_length
        self.buckets = tuple(sorted({int(b) for b in buckets
                                     if 0 < int(b) <= full} | {full}))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.tower = CLIPTextTower(**self.tower_geometry)
        if modelpath:
            self._load(modelpath)
        self.tower.to(device=self.device, dtype=dtype).eval()

    def _load(self, modelpath: str) -> None:
        """The tower's keys of a local HF checkpoint, where there is one."""
        state = _load_hf_state(modelpath)
        if state is not None:
            own = self.tower.state_dict()
            self.tower.load_state_dict(
                {k: v for k, v in state.items() if k in own})

    @torch.no_grad()
    def encode_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        out = self.tower(input_ids.to(self.device),
                         return_hidden=self.last_hidden_state)
        return out if self.last_hidden_state else out[:, None, :]

    def bucket_ids(self, ids: np.ndarray) -> np.ndarray:
        """Truncate 77-padded ids to the smallest bucket covering the
        batch's longest caption (EOT = the max id, first occurrence)."""
        need = int(ids.argmax(axis=-1).max()) + 1
        width = next(b for b in self.buckets if b >= need)
        return ids[:, :width]

    def __call__(self, texts: List[str]) -> torch.Tensor:
        ids = np.asarray(self.tokenizer(texts))
        if not self.last_hidden_state:
            ids = self.bucket_ids(ids)
        return self.encode_ids(torch.from_numpy(ids.astype(np.int64)))


def _load_hf_state(modelpath: str) -> Optional[Dict[str, torch.Tensor]]:
    """A local HF CLIP text checkpoint as a state dict, or None."""
    path = os.path.join(modelpath, "pytorch_model.bin")
    if os.path.exists(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    path = os.path.join(modelpath, "model.safetensors")
    if os.path.exists(path):
        from safetensors.torch import load_file
        return load_file(path)
    return None
