"""GloVe + POS word vectorization for the T2M evaluator path (the port's
copy of ``ladiff_tpu/data/word_vectorizer.py``).

The reference LADiff's word vectorizer
(``data/humanml/utils/word_vectorizer.py``): 300-d GloVe vectors keyed by ``word/POS`` tokens, a 15-way POS one-hot with
five VIP word classes that override the tagger's POS.  When the GloVe deps
(``our_vab_{data.npy,words.pkl,idx.pkl}``) are absent (no-egress images), a
deterministic hash-based fallback provides stable pseudo-embeddings so the
full pipeline stays runnable end-to-end (metrics computed with it are only
self-consistent, not comparable to published numbers).
"""
from __future__ import annotations

import hashlib
import os
import pickle
from os.path import join as pjoin

import numpy as np

__all__ = ["POS_ENUMERATOR", "WordVectorizer", "HashWordVectorizer",
           "build_word_vectorizer"]

POS_ENUMERATOR = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5, "PRON": 6,
    "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10, "Obj_VIP": 11,
    "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}

_LOC = ("left", "right", "clockwise", "counterclockwise", "anticlockwise",
        "forward", "back", "backward", "up", "down", "straight", "curve")
_BODY = ("arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
         "waist", "eye", "knee", "shoulder", "thigh")
_OBJ = ("stair", "dumbbell", "chair", "window", "floor", "car", "ball",
        "handrail", "baseball", "basketball")
_ACT = ("walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
        "throw", "hop", "dance", "jump", "turn", "stumble", "dance", "stop",
        "sit", "lift", "lower", "raise", "wash", "stand", "kneel", "stroll",
        "rub", "bend", "balance", "flap", "jog", "shuffle", "lean", "rotate",
        "spin", "spread", "climb")
_DESC = ("slowly", "carefully", "fast", "careful", "slow", "quickly", "happy",
         "angry", "sad", "happily", "angrily", "sadly")

VIP_DICT = {
    "Loc_VIP": _LOC, "Body_VIP": _BODY, "Obj_VIP": _OBJ, "Act_VIP": _ACT,
    "Desc_VIP": _DESC,
}


def _pos_onehot(pos: str) -> np.ndarray:
    vec = np.zeros(len(POS_ENUMERATOR), dtype=np.float32)
    vec[POS_ENUMERATOR.get(pos, POS_ENUMERATOR["OTHER"])] = 1.0
    return vec


def _vip_pos(word: str):
    for key, values in VIP_DICT.items():
        if word in values:
            return key
    return None


class WordVectorizer:
    """Loads the reference GloVe deps (``deps/glove``)."""

    dim = 300

    def __init__(self, meta_root: str, prefix: str = "our_vab"):
        vectors = np.load(pjoin(meta_root, f"{prefix}_data.npy"))
        with open(pjoin(meta_root, f"{prefix}_words.pkl"), "rb") as f:
            words = pickle.load(f)
        with open(pjoin(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
            word2idx = pickle.load(f)
        self.word2vec = {w: vectors[word2idx[w]] for w in words}
        self.dim = vectors.shape[1]

    def __len__(self):
        return len(self.word2vec)

    def __getitem__(self, item: str):
        word, pos = item.split("/")
        if word in self.word2vec:
            word_vec = self.word2vec[word]
            vip = _vip_pos(word)
            pos_vec = _pos_onehot(vip if vip is not None else pos)
        else:
            word_vec = self.word2vec["unk"]
            pos_vec = _pos_onehot("OTHER")
        return word_vec.astype(np.float32), pos_vec


class HashWordVectorizer:
    """Deterministic stand-in when GloVe deps are unavailable."""

    def __init__(self, dim: int = 300):
        self.dim = dim

    def _vec(self, word: str) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.sha256(word.encode()).digest()[:4], "little")
        rng = np.random.RandomState(seed)
        v = rng.randn(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def __getitem__(self, item: str):
        word, pos = item.split("/")
        vip = _vip_pos(word)
        return self._vec(word), _pos_onehot(vip if vip is not None else pos)


def build_word_vectorizer(glove_root: str | None, prefix: str = "our_vab",
                          dim: int = 300):
    if glove_root and os.path.exists(pjoin(glove_root, f"{prefix}_data.npy")):
        return WordVectorizer(glove_root, prefix)
    return HashWordVectorizer(dim)
