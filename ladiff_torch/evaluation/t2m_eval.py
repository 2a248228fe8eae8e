"""T2M evaluation step (counterpart of ``ladiff_tpu/evaluation/t2m_eval.py``):
generation or reconstruction, joints, the evaluators' re-normalization and
the three evaluator encoders, per batch.

Rebuild of the reference ``t2m_eval`` (ladiff.py:1111-1282).  Stage
``diffusion`` generates from the captions (CFG DDIM through
``LADiffSystem.generate``); stage ``vae`` encodes the ground-truth motion
and decodes it.  The system computes in its own type (bf16 through the
kernels where ``TRAIN.MIXED_PRECISION`` asks for it); the features are
taken to float32 before the joints and the re-normalization, and the
evaluators compute in float32 whatever the system's type, with dropout off.

Reference deltas, deliberate (as in the JAX package): no per-sample
"repeat last frame" padding loop (ladiff.py:1219-1229): the decoder's frame
mask zeroes the padded frames, and the movement encoder crops each batch to
its longest length; no length sort (ladiff.py:1256-1262): the GRU packs with
``enforce_sorted=False``, and the metrics need only one order for the three
embeddings.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from ladiff_torch.models.evaluators import (MotionEncoderBiGRUCo,
                                            MovementConvEncoder,
                                            TextEncoderBiGRUCo,
                                            load_t2m_checkpoint)
from ladiff_torch.utils.device import resolve_device

__all__ = ["T2MEvaluator", "eval_step"]


@contextlib.contextmanager
def _full_float32():
    """float32 products without TF32 inside the block (cuDNN's convolutions
    and GRU default to TF32), the caller's settings afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class T2MEvaluator(nn.Module):
    """The three frozen evaluator encoders, float32, in eval mode, on
    ``device`` (the GPU unless the caller names another)."""

    unit_length = 4

    def __init__(self, nfeats: int, device=None):
        super().__init__()
        self.nfeats = nfeats
        self.movement = MovementConvEncoder(nfeats - 4, 512, 512)
        self.motion = MotionEncoderBiGRUCo(512, 1024, 512)
        self.text = TextEncoderBiGRUCo(300, 15, 512, 512)
        self.to(resolve_device(device))
        self.eval()
        self.requires_grad_(False)

    @classmethod
    def random_init(cls, nfeats: int,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> "T2MEvaluator":
        """Random-weight evaluators (self-consistent metrics only), for
        when the pretrained ``finest.tar`` is absent: PyTorch's default
        initialization, seeded from ``generator`` (seed 0 without one)."""
        seed = (0 if generator is None else int(torch.randint(
            0, 2 ** 31 - 1, (), generator=generator)))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return cls(nfeats, device=device)

    @classmethod
    def from_checkpoint(cls, path: str, nfeats: int,
                        device=None) -> Optional["T2MEvaluator"]:
        """The released evaluators of ``path`` (``finest.tar``), or None
        where the file is missing."""
        sds = load_t2m_checkpoint(path)
        if sds is None:
            return None
        ev = cls(nfeats, device=device)
        for name, sd in sds.items():
            getattr(ev, name).load_state_dict(sd, strict=True)
        return ev

    @property
    def device(self) -> torch.device:
        return self.motion.hidden.device

    @torch.no_grad()
    def encode_motion(self, feats_renormed: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
        """[B, T, F] renormed features -> [B, 512] (reference
        ladiff.py:1264-1267: the movement encoder on feats[..., :-4] of the
        batch cropped to its longest length, the motion encoder over
        max(length // unit_length, 1) steps)."""
        lengths = torch.as_tensor(lengths).cpu().long()
        x = feats_renormed.to(self.device, torch.float32)
        with _full_float32():
            mov = self.movement(x[..., :-4], valid_length=int(lengths.max()))
            m_lens = torch.clamp(lengths // self.unit_length, min=1)
            return self.motion(mov, m_lens)

    @torch.no_grad()
    def encode_text(self, word_embs: torch.Tensor, pos_ohot: torch.Tensor,
                    text_lengths: torch.Tensor) -> torch.Tensor:
        dev = self.device
        with _full_float32():
            return self.text(word_embs.to(dev, torch.float32),
                             pos_ohot.to(dev, torch.float32),
                             torch.as_tensor(text_lengths).cpu().long())


@torch.no_grad()
def eval_step(system, evaluator: T2MEvaluator, batch: Dict[str, torch.Tensor],
              cond: torch.Tensor, uncond: torch.Tensor,
              stage: str = "diffusion", *, mean_eval, std_eval,
              generator: Optional[torch.Generator] = None,
              init_latents: Optional[torch.Tensor] = None,
              eps: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
    """One evaluation batch (``make_eval_step``'s step): returns
    ``lat_t`` (text embeddings [B, 512]), ``lat_rm`` (generated or
    reconstructed motion's), ``lat_m`` (ground truth's), ``joints_rst``,
    ``joints_ref`` [B, T, J, 3] and ``z`` [B, max_it, D].

    ``batch``: "motion" [B, T, nfeats], "length" [B], "word_embs",
    "pos_ohot", "text_len".  ``cond`` / ``uncond`` [B, 1, 768] text
    features.  Stage ``diffusion`` samples from ``init_latents`` (drawn from
    ``generator`` when None); stage ``vae`` samples the encoder's latents
    with ``eps`` (likewise).  ``mean_eval`` / ``std_eval``: the evaluators'
    feature stats."""
    if getattr(system, "vae_type", "ladiff") == "no":
        raise NotImplementedError(
            "feature-space diffusion (vae_type 'no') is not ported to "
            "ladiff_torch yet (ROADMAP.md Queue 1 item 3)")
    if stage not in ("diffusion", "vae"):
        raise ValueError(f"unknown eval stage {stage}")
    dev = system.device
    motions = batch["motion"].to(dev, torch.float32)
    lengths = torch.as_tensor(batch["length"]).long()
    nframes = motions.shape[1]
    if stage == "diffusion":
        feats_rst, z = system.generate(
            cond, uncond, lengths, generator=generator, nframes=nframes,
            init_latents=None if init_latents is None
            else init_latents.to(dev))
    else:
        lengths_dev = lengths.to(dev)
        z, _, _, _ = system.vae.encode(
            motions, lengths_dev, generator=generator,
            eps=None if eps is None else eps.to(dev))
        feats_rst = system.vae.decode(z, lengths_dev, nframes)
    feats_rst = feats_rst.float()
    rst_renorm = system.renorm4t2m(feats_rst, mean_eval, std_eval)
    ref_renorm = system.renorm4t2m(motions, mean_eval, std_eval)
    return {
        "lat_t": evaluator.encode_text(batch["word_embs"], batch["pos_ohot"],
                                       batch["text_len"]),
        "lat_rm": evaluator.encode_motion(rst_renorm, lengths),
        "lat_m": evaluator.encode_motion(ref_renorm, lengths),
        "joints_rst": system.feats2joints(feats_rst),
        "joints_ref": system.feats2joints(motions),
        "z": z.float(),
    }
