"""The action-to-motion evaluation (counterpart of
``ladiff_tpu/evaluation/a2m_eval.py``): generate motions from action labels
(classifier-free guidance with the zeroed action token as the unconditional
branch, then the ActorVae's decode), run the frozen classifier on the
generated and on the ground-truth sequences, and accumulate
``ActionClassifierMetrics``.  On one device.

Classifier inputs, as the reference's protocol has them:

  * HumanAct12, the GRU: the 24 x 3 SMPL joints of the Rotation2xyz pass
    (``feats2joints_action_eval``), flattened joints-major [B, T, 72];
  * UESTC, the ST-GCN: the rot6d features, channel-major, the translation
    node dropped (``stgcn_input_from_feats``).

The classifiers compute in float32 without TF32, whatever the system's
type.  The last batch is padded to ``batch_size`` with copies of its last
item and the outputs trimmed back.  Each batch's initial latents [batch_size,
n_latents, D] come from one seeded CPU generator, so a CPU run and a card
run of one seed see the same noise.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ladiff_torch.evaluation.t2m_eval import _full_float32

__all__ = ["a2m_eval_step", "run_a2m_eval", "classify"]


def classify(system, classifier, motion: torch.Tensor, lengths: torch.Tensor,
             mask: torch.Tensor, classifier_kind: str = "gru"):
    """(features, logits) of ``classifier`` on features [B, T, 150]."""
    from ladiff_torch.models.classifiers import stgcn_input_from_feats
    with _full_float32():
        if classifier_kind == "gru":
            joints = system.feats2joints_action_eval(motion, mask)
            B, T = joints.shape[:2]
            return classifier(joints.reshape(B, T, -1), lengths)
        return classifier(stgcn_input_from_feats(motion.float()))


@torch.no_grad()
def a2m_eval_step(system, classifier, batch: Dict[str, torch.Tensor],
                  classifier_kind: str = "gru",
                  init_latents: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """One batch ("motion" [B, T, 150], "length" [B], "action" [B, 1],
    "mask" [B, T]) -> the classifier's features and logits on the generated
    ("rec_*") and the ground-truth ("gt_*") motions, and the generated
    features ("feats_rst").  ``init_latents`` [B, n_latents, D]: the
    sampler's initial noise (drawn from ``generator`` when None)."""
    dev = system.device
    lengths = batch["length"].to(dev)
    mask = batch["mask"].to(dev)
    motion = batch["motion"].to(dev)
    cond = system.denoiser.embed_action(batch["action"][:, 0].to(dev))
    feats_rst, _ = system.generate(cond, torch.zeros_like(cond), lengths,
                                   generator=generator,
                                   nframes=motion.shape[1],
                                   init_latents=init_latents)
    rec_f, rec_l = classify(system, classifier, feats_rst, lengths, mask,
                            classifier_kind)
    gt_f, gt_l = classify(system, classifier, motion, lengths, mask,
                          classifier_kind)
    return {"rec_feats": rec_f, "rec_logits": rec_l, "gt_feats": gt_f,
            "gt_logits": gt_l, "feats_rst": feats_rst}


def run_a2m_eval(system, dataset, classifier, metrics, batch_size: int = 32,
                 num_frames: int = 60, classifier_kind: str = "gru",
                 seed: int = 0,
                 noise: Optional[Callable[[int], torch.Tensor]] = None
                 ) -> Dict[str, float]:
    """One pass over ``dataset`` (its current split) in order, accumulating
    ``metrics``; returns ``metrics.compute()``.  ``noise(n)`` gives a
    batch's initial latents (default: draws from a CPU generator seeded
    with ``seed``)."""
    from ladiff_torch.data.a2m import a2m_collate
    gen = torch.Generator().manual_seed(seed)
    D = system.latent_dim[-1]
    if noise is None:
        noise = lambda n: torch.randn((n, system.n_latents, D),
                                      generator=gen)
    n = len(dataset)
    for start in range(0, n, batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, n))]
        n_true = len(items)
        batch = a2m_collate(items, num_frames)
        pad = batch_size - n_true
        tensors = {k: torch.from_numpy(np.ascontiguousarray(np.concatenate(
            [v, np.repeat(v[-1:], pad, 0)]) if pad else v))
            for k, v in batch.items() if k != "action_text"}
        tensors["length"] = tensors["length"].long()
        out = a2m_eval_step(system, classifier, tensors, classifier_kind,
                            init_latents=noise(batch_size))
        out = {k: v[:n_true].float().cpu().numpy() for k, v in out.items()}
        metrics.update(batch["action"], out["rec_feats"], out["rec_logits"],
                       out["gt_feats"], out["gt_logits"],
                       list(batch["length"]))
    return metrics.compute()
