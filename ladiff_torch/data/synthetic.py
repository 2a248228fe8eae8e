"""Synthetic HumanML3D-format dataset generator (the port's copy of
``ladiff_tpu/data/synthetic.py``: the same clips, captions and files for the
same seed).

Writes a directory tree with the exact on-disk layout the real datasets use
(``new_joint_vecs/*.npy`` feature clips, ``texts/*.txt`` caption files with
``caption#tokens#f_tag#to_tag`` lines, split id lists, Mean/Std npy), so the
entire real loading path — filtering, caption parsing, normalization,
bucketing — is exercised in tests and benchmarks without the (license-gated)
AMASS-derived data.  Feature vectors are smooth random walks with plausible
scales per feature block; captions are templated motion phrases.
"""
from __future__ import annotations

import os
from os.path import join as pjoin

import numpy as np

__all__ = ["generate_synthetic_dataset"]

_VERBS = ["walks", "runs", "jumps", "turns", "sits", "kneels", "dances",
          "jogs", "spins", "stumbles"]
_ADVS = ["slowly", "quickly", "carefully", "happily", "forward", "backward",
         "left", "right"]


def _caption(rng: np.random.RandomState):
    v = _VERBS[rng.randint(len(_VERBS))]
    a = _ADVS[rng.randint(len(_ADVS))]
    caption = f"a person {v} {a}"
    tokens = " ".join([
        "a/DET", "person/NOUN", f"{v[:-1]}/VERB", f"{a}/ADV"])
    return caption, tokens


def generate_synthetic_dataset(
    root: str,
    n_clips: int = 64,
    nfeats: int = 263,
    min_len: int = 40,
    max_len: int = 199,
    seed: int = 0,
) -> str:
    rng = np.random.RandomState(seed)
    motion_dir = pjoin(root, "new_joint_vecs")
    text_dir = pjoin(root, "texts")
    os.makedirs(motion_dir, exist_ok=True)
    os.makedirs(text_dir, exist_ok=True)

    names = [f"{i:06d}" for i in range(n_clips)]
    all_feats = []
    for name in names:
        L = rng.randint(min_len, max_len)
        # smooth random walk: integrates small deltas, then per-block scaling
        deltas = rng.randn(L, nfeats).astype(np.float32) * 0.05
        feats = np.cumsum(deltas, axis=0)
        feats[:, 0] *= 0.02          # root rot-vel small
        feats[:, 1:3] *= 0.05        # root lin-vel
        feats[:, 3] = 0.9 + 0.05 * feats[:, 3]  # root height ~ 0.9m
        np.save(pjoin(motion_dir, name + ".npy"), feats)
        all_feats.append(feats)
        cap, tok = _caption(rng)
        lines = [f"{cap}#{tok}#0.0#0.0"]
        if L > 80 and rng.rand() < 0.3:  # exercise the sub-span path
            cap2, tok2 = _caption(rng)
            lines.append(f"{cap2}#{tok2}#0.5#{(L - 1) / 20.0:.1f}")
        with open(pjoin(text_dir, name + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    cat = np.concatenate(all_feats, axis=0)
    np.save(pjoin(root, "Mean.npy"), cat.mean(axis=0))
    np.save(pjoin(root, "Std.npy"), cat.std(axis=0) + 1e-7)

    n_train = max(1, int(0.8 * n_clips))
    n_val = max(1, int(0.1 * n_clips))
    with open(pjoin(root, "train.txt"), "w") as f:
        f.write("\n".join(names[:n_train]))
    with open(pjoin(root, "val.txt"), "w") as f:
        f.write("\n".join(names[n_train:n_train + n_val]))
    with open(pjoin(root, "test.txt"), "w") as f:
        f.write("\n".join(names[n_train + n_val:] or names[-1:]))
    return root
