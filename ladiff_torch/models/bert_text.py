"""DistilBERT text encoder, the ``mld_bert`` text-encoder option
(counterpart of ``ladiff_tpu/models/bert_text.py``).

``DistilBertTower``: word and learned position embeddings, LayerNorm (eps
1e-12), 6 post-norm blocks (attention -> ``sa_layer_norm`` -> exact-GELU
FFN -> ``output_layer_norm``) under an additive key bias of
``finfo(float32).min`` on padded tokens.  ``BertTextEncoder``: texts ->
``projection_1(relu(last_hidden_state))`` [B, N, latent_dim] with padded
rows zero, for the denoiser's full-context conditioning
(``text_encoded_dim`` = ``latent_dim``).

Parameter names are HF ``DistilBertModel``'s (``embeddings.word_embeddings``,
``transformer.layer.{i}.attention.q_lin``, ``ffn.lin1``, ...), so a local
``distilbert-base-uncased`` checkpoint (``pytorch_model.bin``, or
``model.safetensors`` with the ``safetensors`` package) loads as it is;
``transformers`` is never imported.  The tokenizers are copies of the JAX
package's: greedy WordPiece over ``vocab.txt``, and a sha256 word hash
where no vocabulary exists.  Everything here is plain PyTorch on every
device, as the JAX package runs it in XLA.
"""
from __future__ import annotations

import hashlib
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.utils.device import resolve_device, resolve_dtype

__all__ = ["DistilBertLayer", "DistilBertTower", "HashWordTokenizer",
           "WordPieceTokenizer", "BertTextEncoder", "load_distilbert_state"]


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q_lin = nn.Linear(dim, dim)
        self.k_lin = nn.Linear(dim, dim)
        self.v_lin = nn.Linear(dim, dim)
        self.out_lin = nn.Linear(dim, dim)


class _FFN(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden_dim)
        self.lin2 = nn.Linear(hidden_dim, dim)


class DistilBertLayer(nn.Module):
    """Post-norm block (HF ``TransformerBlock``)."""

    def __init__(self, dim: int, n_heads: int, hidden_dim: int):
        super().__init__()
        self.n_heads = n_heads
        self.attention = _Attention(dim)
        self.sa_layer_norm = nn.LayerNorm(dim, eps=1e-12)
        self.ffn = _FFN(dim, hidden_dim)
        self.output_layer_norm = nn.LayerNorm(dim, eps=1e-12)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor
                ) -> torch.Tensor:
        """x [B, S, D]; attn_bias [B, 1, 1, S] added to the logits."""
        B, S, D = x.shape
        H, a = self.n_heads, self.attention
        q, k, v = (lin(x).reshape(B, S, H, D // H).transpose(1, 2)
                   for lin in (a.q_lin, a.k_lin, a.v_lin))
        scores = q @ k.transpose(-1, -2) / math.sqrt(D // H) + attn_bias
        ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2)
        x = self.sa_layer_norm(x + a.out_lin(ctx.reshape(B, S, D)))
        h = self.ffn.lin2(F.gelu(self.ffn.lin1(x)))
        return self.output_layer_norm(x + h)


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, max_position: int, dim: int):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, dim)
        self.position_embeddings = nn.Embedding(max_position, dim)
        self.LayerNorm = nn.LayerNorm(dim, eps=1e-12)


class _Transformer(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class DistilBertTower(nn.Module):
    """input_ids [B, S], attention_mask [B, S] bool -> last_hidden_state
    [B, S, dim]."""

    def __init__(self, vocab_size: int = 30522, max_position: int = 512,
                 dim: int = 768, n_layers: int = 6, n_heads: int = 12,
                 hidden_dim: int = 3072, device=None):
        super().__init__()
        self.dim = dim
        self.embeddings = _Embeddings(vocab_size, max_position, dim)
        self.transformer = _Transformer([
            DistilBertLayer(dim, n_heads, hidden_dim)
            for _ in range(n_layers)])
        self.to(resolve_device(device))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        S = input_ids.shape[1]
        e = self.embeddings
        x = e.LayerNorm(e.word_embeddings(input_ids)
                        + e.position_embeddings.weight[:S][None])
        bias = torch.where(attention_mask[:, None, None, :],
                           torch.zeros((), dtype=x.dtype, device=x.device),
                           torch.tensor(torch.finfo(torch.float32).min,
                                        dtype=x.dtype, device=x.device))
        for layer in self.transformer.layer:
            x = layer(x, bias)
        return x


class HashWordTokenizer:
    """The fallback without a vocab.txt: one id per word by sha256 (stable
    across runs), [CLS] 101 and [SEP] 102, padding 0, ``max_len`` ids."""

    def __init__(self, vocab_size: int = 30522, max_len: int = 32):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.cls_id, self.sep_id, self.pad_id = 101, 102, 0

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), self.max_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), self.max_len), bool)
        for i, t in enumerate(texts):
            toks = [self.cls_id] + [
                1000 + int.from_bytes(
                    hashlib.sha256(w.encode()).digest()[:4], "little")
                % (self.vocab_size - 2000)
                for w in t.lower().split()[:self.max_len - 2]
            ] + [self.sep_id]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = True
        return ids, mask


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a BERT vocab.txt, with
    lowercasing and punctuation splitting (HF ``BertTokenizer`` on ASCII
    text).  Pads the batch to its longest sequence, at most ``max_len``."""

    def __init__(self, vocab_path: str, max_len: int = 64):
        self.vocab: Dict[str, int] = {}
        with open(vocab_path) as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.max_len = max_len
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_id = self.vocab["[PAD]"]
        self.unk_id = self.vocab["[UNK]"]

    @staticmethod
    def _basic(text: str) -> List[str]:
        out, cur = [], ""
        for ch in text.lower():
            if ch.isalnum():
                cur += ch
                continue
            if cur:
                out.append(cur)
                cur = ""
            if not ch.isspace():
                out.append(ch)
        if cur:
            out.append(cur)
        return out

    def _wordpiece(self, word: str) -> List[int]:
        ids, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        seqs = []
        for t in texts:
            toks = [self.cls_id]
            for w in self._basic(t):
                toks.extend(self._wordpiece(w))
            seqs.append(toks[:self.max_len - 1] + [self.sep_id])
        L = min(self.max_len, max(len(s) for s in seqs))
        ids = np.full((len(texts), L), self.pad_id, np.int32)
        mask = np.zeros((len(texts), L), bool)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s[:L]
            mask[i, :len(s)] = True
        return ids, mask


def load_distilbert_state(modelpath: str
                          ) -> Optional[Dict[str, torch.Tensor]]:
    """A local HF DistilBERT checkpoint as the tower's state dict (the
    ``distilbert.`` prefix of a task model removed, other heads dropped),
    or None where there is none."""
    for name in ("pytorch_model.bin", "model.safetensors"):
        path = os.path.join(modelpath, name)
        if os.path.exists(path):
            break
    else:
        return None
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("distilbert."): v for k, v in sd.items()}
    return {k: v.float() for k, v in sd.items()
            if k.startswith(("embeddings.", "transformer.layer."))
            and not k.endswith("position_ids")}


class BertTextEncoder:
    """texts -> [B, N, latent_dim] projected DistilBERT token features,
    padded rows zero: the full-context alternative to ``ClipTextEncoder``
    (pair with the denoiser's ``text_encoded_dim`` = ``latent_dim``)."""

    def __init__(self, modelpath: Optional[str] = None,
                 latent_dim: int = 256, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        self.device = resolve_device(device)
        dtype = resolve_dtype(self.device, dtype)
        self.latent_dim = self.text_encoded_dim = latent_dim
        vocab = os.path.join(modelpath, "vocab.txt") if modelpath else None
        self.tokenizer = (WordPieceTokenizer(vocab)
                          if vocab and os.path.exists(vocab)
                          else HashWordTokenizer())
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.tower = DistilBertTower(device="cpu")
            self.projection_1 = nn.Linear(self.tower.dim, latent_dim)
        state = load_distilbert_state(modelpath) if modelpath else None
        if state is not None:
            self.tower.load_state_dict(state)
        for m in (self.tower, self.projection_1):
            m.to(device=self.device, dtype=dtype).eval()

    def _tokens(self, texts: List[str]):
        ids, mask = self.tokenizer(texts)
        return (torch.as_tensor(ids.astype(np.int64), device=self.device),
                torch.as_tensor(mask, device=self.device))

    @torch.no_grad()
    def __call__(self, texts: List[str]) -> torch.Tensor:
        ids, mask = self._tokens(texts)
        out = self.projection_1(F.relu(self.tower(ids, mask)))
        return out * mask[..., None].to(out.dtype)

    @torch.no_grad()
    def last_hidden_state(self, texts: List[str]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tower output [B, N, 768], mask [B, N])."""
        ids, mask = self._tokens(texts)
        return self.tower(ids, mask), mask
