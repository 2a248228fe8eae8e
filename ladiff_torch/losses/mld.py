"""Training losses (counterpart of ``ladiff_tpu/losses/mld.py``): pure
functions returning (total, dict of scalars).

  * stage "vae": SmoothL1 on features and on recovered joints, KL against
    N(0, 1) over all latent rows, inactive ones included, weighted by
    LAMBDA_REC / LAMBDA_JOINT / LAMBDA_KL;
  * stage "diffusion": MSE of the predicted noise (or of the predicted x0).

Every reduction runs in float32 whatever the compute type: a bf16 mean
over millions of elements loses mantissa, and the KL's exp needs the range.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

__all__ = ["smooth_l1", "kl_normal_standard", "LossWeights", "vae_loss",
           "diffusion_loss"]


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """``torch.nn.SmoothL1Loss(reduction='mean')``."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return loss.mean()


def kl_normal_standard(mu: torch.Tensor, logvar: torch.Tensor
                       ) -> torch.Tensor:
    """Mean elementwise KL(N(mu, sigma) || N(0, 1))."""
    return (0.5 * (torch.exp(logvar) + mu ** 2 - 1.0 - logvar)).mean()


@dataclasses.dataclass(frozen=True)
class LossWeights:
    lambda_rec: float = 1.0
    lambda_joint: float = 1.0
    lambda_kl: float = 1.0e-4
    lambda_gen: float = 1.0
    lambda_prior: float = 0.0

    @classmethod
    def from_cfg(cls, cfg) -> "LossWeights":
        """The weights of a configuration's LOSS section.  A nonzero
        LAMBDA_PRIOR raises, as in the JAX package: the reference loss reads
        a prior distribution no forward produces, and every published
        configuration sets 0."""
        L = cfg.LOSS
        prior = float(L.get("LAMBDA_PRIOR", 0.0))
        if prior != 0.0:
            raise ValueError(f"LOSS.LAMBDA_PRIOR={prior} is not supported: "
                             "the reference loss fails on any nonzero "
                             "value and every published configuration "
                             "uses 0.0")
        return cls(lambda_rec=float(L.get("LAMBDA_REC", 1.0)),
                   lambda_joint=float(L.get("LAMBDA_JOINT", 1.0)),
                   lambda_kl=float(L.get("LAMBDA_KL", 1.0e-4)),
                   lambda_gen=float(L.get("LAMBDA_GEN", 1.0)),
                   lambda_prior=prior)


def vae_loss(feats_rst: torch.Tensor, feats_ref: torch.Tensor,
             joints_rst: Optional[torch.Tensor],
             joints_ref: Optional[torch.Tensor], mu: torch.Tensor,
             logvar: torch.Tensor, weights: LossWeights
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    recons_feature = smooth_l1(feats_rst.float(), feats_ref.float())
    if joints_rst is not None:
        recons_joints = smooth_l1(joints_rst.float(), joints_ref.float())
    else:
        recons_joints = torch.zeros((), dtype=torch.float32,
                                    device=feats_rst.device)
    kl_motion = kl_normal_standard(mu.float(), logvar.float())
    total = (weights.lambda_rec * recons_feature
             + weights.lambda_joint * recons_joints
             + weights.lambda_kl * kl_motion)
    return total, {"recons_feature": recons_feature,
                   "recons_joints": recons_joints, "kl_motion": kl_motion,
                   "total": total}


def diffusion_loss(noise_pred: torch.Tensor, noise: torch.Tensor, *,
                   predict_epsilon: bool = True,
                   x0_pred: Optional[torch.Tensor] = None,
                   x0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if predict_epsilon:
        inst = ((noise_pred.float() - noise.float()) ** 2).mean()
        return inst, {"inst_loss": inst, "total": inst}
    x = ((x0_pred.float() - x0.float()) ** 2).mean()
    return x, {"x_loss": x, "total": x}
