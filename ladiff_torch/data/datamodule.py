"""Data modules + dataset factory (the port's copy of
``ladiff_tpu/data/datamodule.py``: the same batches for the same data and
seed).

The reference LADiff's data layer:
  * ``get_datasets`` factory (``data/get_data.py:86``):
    maps dataset names to modules, loads train-norm Mean/Std from the
    dataset root and eval-norm stats from the T2M evaluator meta dir, builds
    the word vectorizer, records NFEATS/NJOINTS back into the config.
  * ``BASEDataModule``/``HumanML3DDataModule``/``KitDataModule``
    (data/base.py:7, data/HumanML3D.py:11, data/Kit.py:11): lazy per-split
    datasets, ``feats2joints`` (denorm + RIC recovery), ``renorm4t2m``,
    ``mm_mode`` subsampling (HumanML3D.py:67-78).

The loaders yield numpy batches of a static shape (motion padded to MAX_LEN,
or to a length bucket); the training loop copies them to the device.  The
action datasets (HumanAct12, UESTC) are not ported yet.
"""
from __future__ import annotations

import os
from os.path import join as pjoin
from typing import Dict, Iterator, List, Optional

import numpy as np

import torch

from ladiff_torch.data.humanml.dataset import Text2MotionDataset, collate_t2m
from ladiff_torch.data.humanml.motion_repr import recover_from_ric
from ladiff_torch.data.word_vectorizer import build_word_vectorizer

__all__ = ["T2MDataModule", "get_datasets"]

_DATASET_SPECS = {
    "humanml3d": dict(njoints=22, nfeats=263, fps=20.0, unit_len=4,
                      min_len=40),
    "kit": dict(njoints=21, nfeats=251, fps=12.5, unit_len=4, min_len=24),
}


class T2MDataModule:
    """Text-to-motion data module for HumanML3D / KIT-ML."""

    def __init__(
        self,
        name: str,
        data_root: str,
        w_vectorizer,
        batch_size: int = 64,
        max_motion_length: int = 196,
        max_text_len: int = 20,
        mean_eval: Optional[np.ndarray] = None,
        std_eval: Optional[np.ndarray] = None,
        tiny: bool = False,
        debug: bool = False,
        seed: int = 1234,
    ):
        spec = _DATASET_SPECS[name]
        self.name = name
        self.njoints = spec["njoints"]
        self.nfeats = spec["nfeats"]
        self.fps = spec["fps"]
        self.unit_length = spec["unit_len"]
        self.min_motion_length = spec["min_len"]
        self.data_root = data_root
        self.w_vectorizer = w_vectorizer
        self.batch_size = batch_size
        self.max_motion_length = max_motion_length
        self.max_text_len = max_text_len
        self.tiny = tiny
        self.debug = debug
        self.seed = seed
        self.is_mm = False
        self._mm_names: Optional[List[str]] = None

        self.mean = np.load(pjoin(data_root, "Mean.npy")).astype(np.float32)
        self.std = np.load(pjoin(data_root, "Std.npy")).astype(np.float32)
        # eval-normalization stats (T2M evaluator meta); fall back to train
        self.mean_eval = (mean_eval if mean_eval is not None else self.mean)
        self.std_eval = (std_eval if std_eval is not None else self.std)
        self._datasets: Dict[str, Text2MotionDataset] = {}

    # ------------------------------------------------------------------
    def dataset(self, split: str) -> Text2MotionDataset:
        if split not in self._datasets:
            self._datasets[split] = Text2MotionDataset(
                mean=self.mean, std=self.std,
                split_file=pjoin(self.data_root, f"{split}.txt"),
                w_vectorizer=self.w_vectorizer,
                max_motion_length=self.max_motion_length,
                min_motion_length=self.min_motion_length,
                max_text_len=self.max_text_len,
                unit_length=self.unit_length,
                motion_dir=pjoin(self.data_root, "new_joint_vecs"),
                text_dir=pjoin(self.data_root, "texts"),
                fps=self.fps,
                tiny=self.tiny, debug=self.debug,
                phase="train" if split == "train" else "eval",
                seed=self.seed,
            )
        return self._datasets[split]

    def loader(self, split: str, batch_size: Optional[int] = None,
               shuffle: Optional[bool] = None, drop_last: bool = False,
               seed: Optional[int] = None,
               buckets: Optional[tuple] = None) -> Iterator[dict]:
        """One epoch of static-shape collated batches.

        ``buckets``: optional ascending frame-count grid (e.g. (64, 128,
        196)).  Clips batch with others from the same bucket and pad only
        to the bucket size instead of MAX_LEN, so short clips cost fewer
        rows.  Without buckets, every batch is padded to MAX_LEN."""
        ds = self.dataset(split)
        bs = batch_size or self.batch_size
        shuffle = (split == "train") if shuffle is None else shuffle
        idx = np.arange(len(ds))
        if self.is_mm and split == "test" and self._mm_names is not None:
            name_to_i = {n: i for i, n in enumerate(
                ds.name_list[ds.pointer:])}
            idx = np.array([name_to_i[n] for n in self._mm_names
                            if n in name_to_i])
        rng = np.random.RandomState(self.seed if seed is None else seed)
        if shuffle:
            rng.shuffle(idx)

        if buckets:
            buckets = tuple(sorted(min(b, self.max_motion_length)
                                   for b in buckets))
            assert buckets[-1] >= self.max_motion_length, (
                "largest bucket must cover MAX_LEN")
            lengths = ds.length_arr[ds.pointer:][idx] if not self.is_mm \
                else np.array([ds.data_dict[ds.name_list[ds.pointer + i]]
                               ["length"] for i in idx])
            order = []
            for b in buckets:
                in_b = idx[(lengths <= b)
                           & (lengths > (0 if b == buckets[0]
                                         else buckets[buckets.index(b) - 1]))]
                for start in range(0, len(in_b), bs):
                    chunk = in_b[start:start + bs]
                    if drop_last and len(chunk) < bs:
                        continue
                    order.append((b, chunk))
            if shuffle:
                rng.shuffle(order)
            for b, chunk in order:
                items = [ds[int(i)] for i in chunk]
                yield collate_t2m(items, b)
            return

        for start in range(0, len(idx), bs):
            chunk = idx[start:start + bs]
            if drop_last and len(chunk) < bs:
                break
            items = [ds[int(i)] for i in chunk]
            yield collate_t2m(items, self.max_motion_length)

    # ------------------------------------------------------------------
    def feats2joints(self, feats: torch.Tensor) -> torch.Tensor:
        """Denormalize + RIC recovery (reference HumanML3D.py:44-48)."""
        feats = torch.as_tensor(feats, dtype=torch.float32)
        feats = (feats * torch.as_tensor(self.std).to(feats.device)
                 + torch.as_tensor(self.mean).to(feats.device))
        return recover_from_ric(feats, self.njoints)

    def renorm4t2m(self, feats):
        """Re-normalize to evaluator stats (reference HumanML3D.py:57-65)."""
        feats = feats * self.std + self.mean
        return (feats - self.mean_eval) / self.std_eval

    def mm_mode(self, on: bool, mm_num_samples: int = 100,
                seed: Optional[int] = None):
        """Sub-sample clips for the MultiModality metric
        (reference HumanML3D.py:67-78)."""
        ds = self.dataset("test")
        if on:
            names = list(ds.name_list[ds.pointer:])
            rng = np.random.RandomState(self.seed if seed is None else seed)
            k = min(mm_num_samples, len(names))
            self._mm_names = list(rng.choice(names, k, replace=False))
            self.is_mm = True
        else:
            self.is_mm = False
            self._mm_names = None


def _get_action_dataset(cfg, name: str, base, phase: str = "train"):
    """The action datasets (HumanAct12, UESTC) are not ported yet
    (ROADMAP.md Queue 1: the action family)."""
    raise NotImplementedError(
        f"the {name} action dataset is not ported to ladiff_torch yet "
        "(ROADMAP.md Queue 1: the action family)")


def get_datasets(cfg, phase: str = "train") -> List[T2MDataModule]:
    """Reference factory (data/get_data.py:86-161)."""
    names = list(cfg[phase.upper()].DATASETS)
    modules = []
    for name in names:
        name = name.lower()
        base = cfg.DATASET.get(name.upper(), {})
        if name in ("humanact12", "uestc"):
            modules.append(_get_action_dataset(cfg, name, base, phase))
            continue
        data_root = base.get("ROOT", pjoin("datasets", name))
        if not os.path.exists(pjoin(data_root, "Mean.npy")):
            if os.environ.get("LADIFF_SYNTHETIC_DATA", "") == "1":
                from ladiff_torch.data.synthetic import \
                    generate_synthetic_dataset
                # LADIFF_SYNTHETIC_CLIPS sizes the stand-in (default 64).
                # Non-default counts get their own dir so a cached 64-clip
                # set is never mistaken for a larger one.
                n_clips = int(os.environ.get("LADIFF_SYNTHETIC_CLIPS",
                                             "64") or 64)
                suffix = f"_{n_clips}" if n_clips != 64 else ""
                data_root = pjoin("datasets", f"synthetic_{name}{suffix}")
                if not os.path.exists(pjoin(data_root, "Mean.npy")):
                    nfeats = _DATASET_SPECS[name]["nfeats"]
                    generate_synthetic_dataset(data_root, n_clips=n_clips,
                                               nfeats=nfeats)
                print(f"WARNING: {name} dataset not found; using SYNTHETIC "
                      f"data at {data_root} (LADIFF_SYNTHETIC_DATA=1). "
                      "Metrics are meaningless on synthetic data.")
            else:
                raise FileNotFoundError(
                    f"dataset root {data_root} is missing Mean.npy — "
                    "download/prepare the dataset (see prepare/README.md) "
                    "or set LADIFF_SYNTHETIC_DATA=1 for a synthetic "
                    "stand-in")
        glove = cfg.DATASET.get("WORD_VERTILIZER_PATH", None)
        wv = build_word_vectorizer(glove)
        # eval-norm stats from T2M evaluator meta dir when available
        mean_eval = std_eval = None
        t2m_path = cfg.model.get("t2m_path", None)
        if t2m_path:
            ename = "t2m" if name == "humanml3d" else name
            # the KIT evaluator release ships a different experiment dir
            # (reference get_data.py:28-32: t2m -> Comp_v6_KLD01,
            #  kit -> Comp_v6_KLD005)
            exp = "Comp_v6_KLD005" if ename == "kit" else "Comp_v6_KLD01"
            meta = pjoin(t2m_path, ename, exp, "meta")
            if os.path.exists(pjoin(meta, "mean.npy")):
                mean_eval = np.load(pjoin(meta, "mean.npy")).astype(np.float32)
                std_eval = np.load(pjoin(meta, "std.npy")).astype(np.float32)
        dm = T2MDataModule(
            name=name,
            data_root=data_root,
            w_vectorizer=wv,
            batch_size=int(cfg[phase.upper()].BATCH_SIZE),
            max_motion_length=int(cfg.DATASET.SAMPLER.MAX_LEN),
            max_text_len=int(cfg.DATASET.SAMPLER.MAX_TEXT_LEN),
            mean_eval=mean_eval, std_eval=std_eval,
            debug=bool(cfg.get("DEBUG", False)),
            seed=int(cfg.get("SEED_VALUE", 1234)),
        )
        cfg.DATASET.NFEATS = dm.nfeats
        cfg.DATASET.NJOINTS = dm.njoints
        modules.append(dm)
    return modules
