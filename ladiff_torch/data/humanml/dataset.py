"""Text2Motion dataset: clip loading, filtering, caption/crop sampling (the
port's copy of ``ladiff_tpu/data/humanml/dataset.py``, numpy throughout).

The reference LADiff's ``Text2MotionDatasetV2``
(``data/humanml/data/dataset.py:234-556``):
  * per-clip ``.npy`` motion features + ``.txt`` captions with sub-span tags
    (``caption#tokens#f_tag#to_tag``; tagged spans become extra clips,
    dataset.py:344-380),
  * length filter [min_motion_length, 200), tiny/debug caps (10/100 items),
  * clips sorted by length with a ``pointer`` (searchsorted at max_length),
  * __getitem__: random caption; GloVe+POS tokens padded to max_text_len+2
    with sos/eos/unk; eval-phase length snap to unit_length with the
    "single/single/double" coin and random crop (dataset.py:452-475);
    train phase uses the full clip; z-normalization.

The returned motion is zero-padded to a static ``max_motion_length`` (or a
length bucket): padding is carried as ``length`` data, never as shape, so
the kernels see one row count per batch size.
"""
from __future__ import annotations

import codecs
import random
from os.path import join as pjoin
from typing import Dict, List

import numpy as np

__all__ = ["Text2MotionDataset", "collate_t2m"]


class Text2MotionDataset:
    def __init__(
        self,
        mean: np.ndarray,
        std: np.ndarray,
        split_file: str,
        w_vectorizer,
        max_motion_length: int = 196,
        min_motion_length: int = 40,
        max_text_len: int = 20,
        unit_length: int = 4,
        motion_dir: str = "",
        text_dir: str = "",
        fps: float = 20.0,
        tiny: bool = False,
        debug: bool = False,
        phase: str = "train",
        seed: int = 1234,
    ):
        self.w_vectorizer = w_vectorizer
        self.phase = phase
        self.max_motion_length = max_motion_length
        self.min_motion_length = min_motion_length
        self.max_text_len = max_text_len
        self.unit_length = unit_length
        self.mean = mean
        self.std = std
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.max_length = 20  # reference default at phase != train-subphase

        with codecs.open(split_file, "r") as f:
            id_list = [line.strip() for line in f.readlines()]

        maxdata = 10 if tiny else (100 if debug else int(1e10))

        data_dict: Dict[str, dict] = {}
        new_name_list: List[str] = []
        length_list: List[int] = []
        count = 0
        for name in id_list:
            if count > maxdata:
                break
            try:
                motion = np.load(pjoin(motion_dir, name + ".npy"))
            except Exception:
                continue
            if len(motion) < self.min_motion_length or len(motion) >= 200:
                continue
            text_data, flag = [], False
            try:
                with codecs.open(pjoin(text_dir, name + ".txt")) as f:
                    lines = f.readlines()
            except Exception:
                continue
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
                    if (len(n_motion) < self.min_motion_length
                            or len(n_motion) >= 200):
                        continue
                    new_name = self.rng.choice("ABCDEFGHIJKLMNOPQRSTUVW") + "_" + name
                    while new_name in data_dict:
                        new_name = (self.rng.choice("ABCDEFGHIJKLMNOPQRSTUVW")
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
            raise FileNotFoundError(
                f"no usable clips under {motion_dir} for split {split_file}")

        pairs = sorted(zip(new_name_list, length_list), key=lambda x: x[1])
        self.name_list = [p[0] for p in pairs]
        self.length_arr = np.array([p[1] for p in pairs])
        self.data_dict = data_dict
        self.nfeats = data_dict[self.name_list[0]]["motion"].shape[1]
        self.pointer = int(np.searchsorted(self.length_arr, self.max_length))

    def reset_max_len(self, length: int):
        assert length <= self.max_motion_length
        self.pointer = int(np.searchsorted(self.length_arr, length))
        self.max_length = length

    def inv_transform(self, data):
        return data * self.std + self.mean

    def __len__(self):
        return len(self.name_list) - self.pointer

    def _tokens_to_arrays(self, tokens: List[str]):
        if len(tokens) < self.max_text_len:
            tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
            sent_len = len(tokens)
            tokens = tokens + ["unk/OTHER"] * (self.max_text_len + 2 - sent_len)
        else:
            tokens = ["sos/OTHER"] + tokens[: self.max_text_len] + ["eos/OTHER"]
            sent_len = len(tokens)
        embs, ohs = zip(*(self.w_vectorizer[t] for t in tokens))
        return (np.stack(embs).astype(np.float32),
                np.stack(ohs).astype(np.float32), sent_len, tokens)

    def __getitem__(self, item: int) -> dict:
        idx = self.pointer + item
        data = self.data_dict[self.name_list[idx]]
        motion, m_length = data["motion"], data["length"]
        text_data = self.rng.choice(data["text"])
        caption, tokens = text_data["caption"], text_data["tokens"]
        word_embs, pos_ohot, sent_len, tokens = self._tokens_to_arrays(tokens)

        if self.phase != "train":
            # snap to unit_length with the single/single/double coin
            if self.unit_length < 10:
                coin2 = self.np_rng.choice(["single", "single", "double"])
            else:
                coin2 = "single"
            if coin2 == "double":
                m_length = (m_length // self.unit_length - 1) * self.unit_length
            else:
                m_length = (m_length // self.unit_length) * self.unit_length
            start = self.rng.randint(0, len(motion) - m_length)
        else:
            # reference train path: 2/3 of the time start=0 (which is the
            # only choice anyway since m_length == len(motion))
            start = self.rng.randint(0, len(motion) - m_length)
        motion = motion[start:start + m_length]
        is_starting = start == 0

        motion = (motion - self.mean) / self.std
        if np.any(np.isnan(motion)):
            raise ValueError("nan in motion")

        return {
            "word_embs": word_embs,
            "pos_ohot": pos_ohot,
            "text": caption,
            "text_len": sent_len,
            "motion": motion.astype(np.float32),
            "length": int(m_length),
            "tokens": "_".join(tokens),
            "is_starting": is_starting,
        }


def collate_t2m(items: List[dict], max_frames: int) -> dict:
    """Static-shape batch assembly (replaces reference ``mld_collate``,
    data/utils.py:57-75).  Sorts by text length desc (pack_padded_sequence
    convention for the BiGRU evaluators), zero-pads motion to the STATIC
    ``max_frames`` rather than the batch max."""
    items = sorted(items, key=lambda b: b["text_len"], reverse=True)
    B = len(items)
    F = items[0]["motion"].shape[1]
    motion = np.zeros((B, max_frames, F), np.float32)
    for i, b in enumerate(items):
        L = min(b["length"], max_frames)
        motion[i, :L] = b["motion"][:L]
    return {
        "motion": motion,
        "length": np.array([min(b["length"], max_frames) for b in items],
                           np.int32),
        "text": [b["text"] for b in items],
        "word_embs": np.stack([b["word_embs"] for b in items]),
        "pos_ohot": np.stack([b["pos_ohot"] for b in items]),
        "text_len": np.array([b["text_len"] for b in items], np.int32),
        "tokens": [b["tokens"] for b in items],
        "is_starting": np.array([b["is_starting"] for b in items]),
    }
