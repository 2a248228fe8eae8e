"""Legacy T2M dataset variants (V1 / Baseline / snippet / text-only).

Host-side numpy: the counterpart of ``ladiff_tpu/data/humanml/legacy.py``,
line for line.

Rebuild of the remaining dataset classes in
the reference's ladiff/data/humanml/data/dataset.py:
  * ``Text2MotionDatasetV1`` (:27-231) — the original T2M dataset with the
    progressive ``max_length`` curriculum crop and the train-time std
    re-biasing (root/foot-contact channels divided by ``feat_bias``),
  * ``Text2MotionDatasetBaseline`` (:563-737) — (src, tgt) motion pairs for
    training the T2M evaluator,
  * ``MotionDatasetV2`` (:739-815) — fixed ``window_size`` snippets drawn
    uniformly over all frames (cumsum index) for the movement encoder,
  * ``RawTextDataset`` (:819-890) — free-text prompts POS-tagged on the fly
    (spaCy in the reference; a closed-class fallback tagger here when spaCy
    is absent),
  * ``TextOnlyDataset`` (:893-977) — captions without motions for
    generation-only runs.

These feed the evaluator-training and prompt-only paths; the main training
path uses Text2MotionDataset (V2) in dataset.py.
"""
from __future__ import annotations

import codecs
import random
from os.path import join as pjoin
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Text2MotionDatasetV1", "Text2MotionDatasetBaseline",
           "MotionDatasetV2", "RawTextDataset", "TextOnlyDataset",
           "rebias_std"]


def rebias_std(std: np.ndarray, joints_num: int,
               feat_bias: float = 5.0) -> np.ndarray:
    """Train-time std re-biasing of the root/foot-contact channels
    (reference dataset.py:113-146): root rot-vel / lin-vel / height and the
    4 foot contacts are divided by ``feat_bias`` so their normalized scale
    is amplified for the evaluator."""
    std = std.copy()
    std[0:4] = std[0:4] / feat_bias
    std[4 + (joints_num - 1) * 9 + joints_num * 3:] = (
        std[4 + (joints_num - 1) * 9 + joints_num * 3:] / feat_bias)
    assert 4 + (joints_num - 1) * 9 + joints_num * 3 + 4 == std.shape[-1]
    return std


def _read_split(split_file: str) -> List[str]:
    with codecs.open(split_file, "r") as f:
        return [line.strip() for line in f.readlines() if line.strip()]


def _load_clips(split_file: str, motion_dir: str, text_dir: str,
                min_motion_len: int, fps: float, rng: random.Random,
                maxdata: int = int(1e10)):
    """Shared clip+caption loader (identical across V1/V2/Baseline,
    reference dataset.py:45-106): sub-span tags become extra clips; returns
    (data_dict, name_list sorted by length, length array)."""
    data_dict: Dict[str, dict] = {}
    new_name_list: List[str] = []
    length_list: List[int] = []
    count = 0
    for name in _read_split(split_file):
        if count > maxdata:
            break
        try:
            motion = np.load(pjoin(motion_dir, name + ".npy"))
        except Exception:
            continue
        if len(motion) < min_motion_len or len(motion) >= 200:
            continue
        try:
            with codecs.open(pjoin(text_dir, name + ".txt")) as f:
                lines = f.readlines()
        except Exception:
            continue
        text_data, flag = [], False
        for line in lines:
            parts = line.strip().split("#")
            if len(parts) < 4:
                continue
            caption, tokens = parts[0], parts[1].split(" ")
            f_tag = 0.0 if parts[2] in ("nan", "") else float(parts[2])
            to_tag = 0.0 if parts[3] in ("nan", "") else float(parts[3])
            f_tag = 0.0 if np.isnan(f_tag) else f_tag
            to_tag = 0.0 if np.isnan(to_tag) else to_tag
            text_dict = {"caption": caption, "tokens": tokens}
            if f_tag == 0.0 and to_tag == 0.0:
                flag = True
                text_data.append(text_dict)
            else:
                n_motion = motion[int(f_tag * fps):int(to_tag * fps)]
                if len(n_motion) < min_motion_len or len(n_motion) >= 200:
                    continue
                new_name = rng.choice("ABCDEFGHIJKLMNOPQRSTUVW") + "_" + name
                while new_name in data_dict:
                    new_name = (rng.choice("ABCDEFGHIJKLMNOPQRSTUVW")
                                + "_" + name)
                data_dict[new_name] = {"motion": n_motion,
                                       "length": len(n_motion),
                                       "text": [text_dict]}
                new_name_list.append(new_name)
                length_list.append(len(n_motion))
        if flag:
            data_dict[name] = {"motion": motion, "length": len(motion),
                               "text": text_data}
            new_name_list.append(name)
            length_list.append(len(motion))
            count += 1
    if not new_name_list:
        raise FileNotFoundError(f"no usable clips for split {split_file}")
    pairs = sorted(zip(new_name_list, length_list), key=lambda x: x[1])
    return (data_dict, [p[0] for p in pairs],
            np.array([p[1] for p in pairs]))


class _TokensMixin:
    def _tokens_to_arrays(self, tokens: List[str]):
        if len(tokens) < self.max_text_len:
            tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
            sent_len = len(tokens)
            tokens = tokens + ["unk/OTHER"] * (self.max_text_len + 2 - sent_len)
        else:
            tokens = ["sos/OTHER"] + tokens[:self.max_text_len] + ["eos/OTHER"]
            sent_len = len(tokens)
        embs, ohs = zip(*(self.w_vectorizer[t] for t in tokens))
        return (np.stack(embs).astype(np.float32),
                np.stack(ohs).astype(np.float32), sent_len)


class Text2MotionDatasetV1(_TokensMixin):
    """Original T2M dataset with the progressive max_length curriculum
    (reference dataset.py:27-231).  ``reset_max_len`` moves both the
    sorted-length pointer and the crop target; train items crop to
    ``max_length`` (or a unit-aligned longer report length via the
    single/double coin), eval items snap to unit_length."""

    def __init__(self, mean, std, split_file, w_vectorizer,
                 max_motion_length: int = 196, min_motion_length: int = 40,
                 max_text_len: int = 20, unit_length: int = 4,
                 motion_dir: str = "", text_dir: str = "", fps: float = 20.0,
                 joints_num: int = 22, feat_bias: float = 5.0,
                 is_train: bool = True, rebias: bool = False,
                 tiny: bool = False, debug: bool = False, seed: int = 1234):
        self.w_vectorizer = w_vectorizer
        self.max_motion_length = max_motion_length
        self.max_text_len = max_text_len
        self.unit_length = unit_length
        self.is_train = is_train
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.max_length = 20
        self.pointer = 0
        if rebias and is_train:
            std = rebias_std(np.asarray(std), joints_num, feat_bias)
        self.mean, self.std = np.asarray(mean), np.asarray(std)
        maxdata = 10 if tiny else (100 if debug else int(1e10))
        self.data_dict, self.name_list, self.length_arr = _load_clips(
            split_file, motion_dir, text_dir, min_motion_length, fps,
            self.rng, maxdata)
        self.nfeats = self.data_dict[self.name_list[0]]["motion"].shape[1]
        self.reset_max_len(self.max_length)

    def reset_max_len(self, length: int):
        assert length <= self.max_motion_length
        self.pointer = int(np.searchsorted(self.length_arr, length))
        self.max_length = length

    def inv_transform(self, data):
        return data * self.std + self.mean

    def __len__(self):
        return len(self.name_list) - self.pointer

    def __getitem__(self, item: int):
        idx = self.pointer + item
        data = self.data_dict[self.name_list[idx]]
        motion, m_length = data["motion"], data["length"]
        text_data = self.rng.choice(data["text"])
        caption = text_data["caption"]
        word_embs, pos_ohot, sent_len = self._tokens_to_arrays(
            text_data["tokens"])

        len_gap = (m_length - self.max_length) // self.unit_length
        if self.is_train:
            if m_length != self.max_length:
                coin2 = (self.np_rng.choice(["single", "single", "double"])
                         if self.unit_length < 10 else "single")
                if len_gap == 0 or (len_gap == 1 and coin2 == "double"):
                    m_length = self.max_length
                    start = self.rng.randint(0, m_length - self.max_length)
                    motion = motion[start:start + self.max_length]
                else:
                    # crop to max_length but REPORT the unit-aligned longer
                    # length (reference dataset.py:203-212 — deliberate)
                    n_m_length = self.max_length + self.unit_length * (
                        len_gap if coin2 == "single" else len_gap - 1)
                    start = self.rng.randint(0, m_length - n_m_length)
                    motion = motion[start:start + self.max_length]
                    m_length = n_m_length
        else:
            coin2 = (self.np_rng.choice(["single", "single", "double"])
                     if self.unit_length < 10 else "single")
            if coin2 == "double":
                m_length = (m_length // self.unit_length - 1) * self.unit_length
            else:
                m_length = (m_length // self.unit_length) * self.unit_length
            start = self.rng.randint(0, len(motion) - m_length)
            motion = motion[start:start + m_length]

        motion = (motion - self.mean) / self.std
        return (word_embs, pos_ohot, caption, sent_len,
                motion.astype(np.float32), int(m_length))


class Text2MotionDatasetBaseline(_TokensMixin):
    """(src, tgt) motion pairs for evaluator training (reference
    dataset.py:563-737): src = unit-aligned crop zero-padded to
    max_motion_length, tgt = the first max_length frames of the same crop."""

    def __init__(self, mean, std, split_file, w_vectorizer,
                 max_motion_length: int = 196, min_motion_length: int = 40,
                 max_text_len: int = 20, unit_length: int = 4,
                 motion_dir: str = "", text_dir: str = "", fps: float = 20.0,
                 tiny: bool = False, debug: bool = False, seed: int = 1234):
        self.w_vectorizer = w_vectorizer
        self.max_motion_length = max_motion_length
        self.max_text_len = max_text_len
        self.unit_length = unit_length
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.max_length = 20
        self.mean, self.std = np.asarray(mean), np.asarray(std)
        maxdata = 10 if tiny else (100 if debug else int(1e10))
        self.data_dict, self.name_list, self.length_arr = _load_clips(
            split_file, motion_dir, text_dir, min_motion_length, fps,
            self.rng, maxdata)
        self.nfeats = self.data_dict[self.name_list[0]]["motion"].shape[1]
        self.reset_max_len(self.max_length)

    def reset_max_len(self, length: int):
        assert length <= self.max_motion_length
        self.pointer = int(np.searchsorted(self.length_arr, length))
        self.max_length = length

    def inv_transform(self, data):
        return data * self.std + self.mean

    def __len__(self):
        return len(self.name_list) - self.pointer

    def __getitem__(self, item: int):
        idx = self.pointer + item
        data = self.data_dict[self.name_list[idx]]
        motion, m_length = data["motion"], data["length"]
        text_data = self.rng.choice(data["text"])
        caption = text_data["caption"]
        word_embs, _pos, sent_len = self._tokens_to_arrays(
            text_data["tokens"])

        len_gap = (m_length - self.max_length) // self.unit_length
        if m_length != self.max_length:
            coin2 = (self.np_rng.choice(["single", "single", "double"])
                     if self.unit_length < 10 else "single")
            if len_gap == 0 or (len_gap == 1 and coin2 == "double"):
                m_length = self.max_length
                s_idx = self.rng.randint(0, m_length - self.max_length)
            else:
                n_m_length = self.max_length + self.unit_length * (
                    len_gap if coin2 == "single" else len_gap - 1)
                s_idx = self.rng.randint(0, m_length - n_m_length)
                m_length = n_m_length
        else:
            s_idx = 0

        src_motion = motion[s_idx:s_idx + m_length]
        tgt_motion = motion[s_idx:s_idx + self.max_length]
        src_motion = (src_motion - self.mean) / self.std
        tgt_motion = (tgt_motion - self.mean) / self.std
        if m_length < self.max_motion_length:
            src_motion = np.concatenate(
                [src_motion,
                 np.zeros((self.max_motion_length - m_length,
                           motion.shape[1]))], axis=0)
        return (word_embs, caption, sent_len,
                src_motion.astype(np.float32),
                tgt_motion.astype(np.float32), int(m_length))


class MotionDatasetV2:
    """Uniform fixed-window snippets over all clips for the movement
    encoder (reference dataset.py:739-815)."""

    def __init__(self, mean, std, split_file, motion_dir: str = "",
                 window_size: int = 64, joints_num: int = 22,
                 feat_bias: float = 5.0, is_train: bool = True,
                 rebias: bool = False, tiny: bool = False,
                 debug: bool = False, seed: int = 1234):
        self.window_size = window_size
        self.rng = random.Random(seed)
        if rebias and is_train:
            std = rebias_std(np.asarray(std), joints_num, feat_bias)
        self.mean, self.std = np.asarray(mean), np.asarray(std)
        maxdata = 10 if tiny else (100 if debug else int(1e10))
        self.data, self.lengths = [], []
        for name in _read_split(split_file)[:maxdata]:
            try:
                motion = np.load(pjoin(motion_dir, name + ".npy"))
            except Exception:
                continue
            if motion.shape[0] < window_size:
                continue
            self.lengths.append(motion.shape[0] - window_size)
            self.data.append(motion)
        if not self.data:
            raise FileNotFoundError(f"no clips >= window {window_size}")
        self.cumsum = np.cumsum([0] + self.lengths)

    def inv_transform(self, data):
        return data * self.std + self.mean

    def __len__(self):
        return int(self.cumsum[-1])

    def __getitem__(self, item: int) -> np.ndarray:
        if item != 0:
            motion_id = int(np.searchsorted(self.cumsum, item)) - 1
            idx = item - int(self.cumsum[motion_id]) - 1
        else:
            motion_id, idx = 0, 0
        motion = self.data[motion_id][idx:idx + self.window_size]
        return ((motion - self.mean) / self.std).astype(np.float32)


# closed-class fallback tagger used when spaCy is unavailable: enough for
# the GloVe vectorizer's VIP classes (Loc/Body/Obj/Act/Desc come from the
# vectorizer itself; here we only need NOUN/VERB/OTHER-ish splits)
_FALLBACK_POS = {
    "a": "DET", "an": "DET", "the": "DET",
    "and": "CCONJ", "or": "CCONJ", "but": "CCONJ",
    "in": "ADP", "on": "ADP", "at": "ADP", "to": "ADP", "of": "ADP",
    "with": "ADP", "from": "ADP", "into": "ADP", "over": "ADP",
    "is": "AUX", "are": "AUX", "was": "AUX", "be": "AUX",
    "he": "PRON", "she": "PRON", "it": "PRON", "they": "PRON",
    "person": "NOUN", "man": "NOUN", "woman": "NOUN", "arm": "NOUN",
    "leg": "NOUN", "hand": "NOUN", "foot": "NOUN", "circle": "NOUN",
    "then": "ADV", "slowly": "ADV", "quickly": "ADV", "forward": "ADV",
    "backwards": "ADV", "backward": "ADV",
}
_COMMON_VERBS = {"walk", "run", "jump", "turn", "sit", "stand", "wave",
                 "raise", "lower", "kick", "throw", "pick", "bend", "step",
                 "move", "dance", "crawl", "climb", "stretch", "swing"}


def _fallback_pos_tag(word: str) -> str:
    w = word.lower()
    if w in _FALLBACK_POS:
        return _FALLBACK_POS[w]
    for stem in _COMMON_VERBS:
        forms = (stem, stem + "s", stem + "ed", stem + "ing",
                 stem + stem[-1] + "ing", stem + stem[-1] + "ed")
        if w in forms:
            return "VERB"
    return "NOUN"


class RawTextDataset(_TokensMixin):
    """Free-text prompt file -> tokenized items (reference
    dataset.py:819-890).  Uses spaCy lemma+POS when installed (as the
    reference does), otherwise a closed-class heuristic tagger."""

    def __init__(self, mean, std, text_file, w_vectorizer,
                 max_text_len: int = 20):
        self.mean, self.std = np.asarray(mean), np.asarray(std)
        self.max_text_len = max_text_len
        self.w_vectorizer = w_vectorizer
        try:
            import spacy
            self.nlp = spacy.load("en_core_web_sm")
        except Exception:
            self.nlp = None
        self.data_dict = []
        with codecs.open(text_file) as f:
            for line in f.readlines():
                line = line.strip()
                if not line:
                    continue
                word_list, pos_list = self.process_text(line)
                tokens = [f"{word_list[i]}/{pos_list[i]}"
                          for i in range(len(word_list))]
                self.data_dict.append({"caption": line, "tokens": tokens})

    def process_text(self, sentence: str):
        sentence = sentence.replace("-", "")
        if self.nlp is not None:
            doc = self.nlp(sentence)
            word_list, pos_list = [], []
            for token in doc:
                word = token.text
                if not word.isalpha():
                    continue
                if (token.pos_ in ("NOUN", "VERB")) and word != "left":
                    word_list.append(token.lemma_)
                else:
                    word_list.append(word)
                pos_list.append(token.pos_)
            return word_list, pos_list
        words = [w for w in sentence.lower().split() if w.isalpha()]
        return words, [_fallback_pos_tag(w) for w in words]

    def inv_transform(self, data):
        return data * self.std + self.mean

    def __len__(self):
        return len(self.data_dict)

    def __getitem__(self, item: int):
        data = self.data_dict[item]
        caption = data["caption"]
        word_embs, pos_ohot, sent_len = self._tokens_to_arrays(
            data["tokens"])
        return word_embs, pos_ohot, caption, sent_len


class TextOnlyDataset:
    """Captions without motions (reference dataset.py:893-977); item shape
    mirrors the reference's 7-tuple with None placeholders."""

    def __init__(self, mean, std, split_file, text_dir: str = "",
                 fixed_length: int = 120, tiny: bool = False,
                 debug: bool = False, seed: int = 1234):
        self.mean, self.std = np.asarray(mean), np.asarray(std)
        self.fixed_length = fixed_length
        self.rng = random.Random(seed)
        maxdata = 10 if tiny else (100 if debug else int(1e10))
        data_dict: Dict[str, dict] = {}
        name_list: List[str] = []
        for name in _read_split(split_file)[:maxdata]:
            try:
                with codecs.open(pjoin(text_dir, name + ".txt")) as f:
                    lines = f.readlines()
            except Exception:
                continue
            text_data, flag = [], False
            for line in lines:
                parts = line.strip().split("#")
                if len(parts) < 4:
                    continue
                caption, tokens = parts[0], parts[1].split(" ")
                f_tag = 0.0 if parts[2] in ("nan", "") else float(parts[2])
                to_tag = 0.0 if parts[3] in ("nan", "") else float(parts[3])
                text_dict = {"caption": caption, "tokens": tokens}
                if (0.0 if np.isnan(f_tag) else f_tag) == 0.0 and \
                        (0.0 if np.isnan(to_tag) else to_tag) == 0.0:
                    flag = True
                    text_data.append(text_dict)
                else:
                    new_name = (self.rng.choice("ABCDEFGHIJKLMNOPQRSTUVW")
                                + "_" + name)
                    while new_name in data_dict:
                        new_name = (self.rng.choice("ABCDEFGHIJKLMNOPQRSTUVW")
                                    + "_" + name)
                    data_dict[new_name] = {"text": [text_dict]}
                    name_list.append(new_name)
            if flag:
                data_dict[name] = {"text": text_data}
                name_list.append(name)
        self.data_dict = data_dict
        self.name_list = name_list

    def inv_transform(self, data):
        return data * self.std + self.mean

    def __len__(self):
        return len(self.data_dict)

    def __getitem__(self, item: int):
        data = self.data_dict[self.name_list[item]]
        text_data = self.rng.choice(data["text"])
        return (None, None, text_data["caption"], None, np.array([0]),
                self.fixed_length, None)
