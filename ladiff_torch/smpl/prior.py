"""Pose priors for SMPL fitting (counterpart of ``ladiff_tpu/smpl/prior.py``).

``MaxMixturePrior``: the SMPLify max-mixture GMM negative log-likelihood over
the 69-dim body pose, loaded from the standard ``gmm_%02d.pkl``, an
``nn.Module`` whose means, precisions and log weights are buffers, so it
moves to the card with the body model.  ``angle_prior`` (knee / elbow
bending direction) and ``l2_prior`` are plain functions of the pose.
``create_prior`` picks one, with the L2 prior where the GMM asset is absent.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch
from torch import nn

__all__ = ["MaxMixturePrior", "angle_prior", "l2_prior", "create_prior",
           "gmof", "synthetic_gmm"]


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """exp(pose[knee / elbow] * sign)^2 per joint: body_pose [..., 69] ->
    [..., 4].  The components are 55, 58, 12 and 15 of the 72-dim pose
    with the global orientation (3 less in the body pose), with the signs
    +, -, -, - (negation is exact, so no sign tensor goes to the device)."""
    bent = torch.stack([body_pose[..., 52], -body_pose[..., 55],
                        -body_pose[..., 9], -body_pose[..., 12]], dim=-1)
    return torch.exp(bent) ** 2


def l2_prior(body_pose: torch.Tensor, *_args) -> torch.Tensor:
    """Sum of squares over the pose (the fallback prior)."""
    return torch.sum(body_pose ** 2, dim=-1)


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure robust error."""
    x_sq = x ** 2
    s_sq = sigma ** 2
    return (s_sq * x_sq) / (s_sq + x_sq)


class MaxMixturePrior(nn.Module):
    """nll(pose) = min_m [0.5 (pose - mu_m)^T P_m (pose - mu_m) - log w'_m]
    with w'_m = weights_m / (const * sqrtdet_m / min(sqrtdet)), SMPLify's
    merged log-likelihood."""

    def __init__(self, means, precisions, log_nll_weights):
        super().__init__()
        for name, v in (("means", means), ("precisions", precisions),
                        ("log_nll_weights", log_nll_weights)):
            self.register_buffer(name, torch.from_numpy(
                np.array(v, np.float32)), persistent=False)

    @staticmethod
    def load(path: str, num_gaussians: int = 6
             ) -> Optional["MaxMixturePrior"]:
        """``gmm_{num_gaussians:02d}.pkl`` from a folder, or a file path;
        None where the asset is absent."""
        if os.path.isdir(path):
            path = os.path.join(path, f"gmm_{num_gaussians:02d}.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            gmm = pickle.load(f, encoding="latin1")
        if isinstance(gmm, dict):
            means, covs, weights = gmm["means"], gmm["covars"], gmm["weights"]
        else:  # a scikit-learn mixture
            means, covs, weights = gmm.means_, gmm.covars_, gmm.weights_
        return MaxMixturePrior.from_arrays(
            np.asarray(means, np.float64), np.asarray(covs, np.float64),
            np.asarray(weights, np.float64))

    @staticmethod
    def from_arrays(means: np.ndarray, covs: np.ndarray,
                    weights: np.ndarray) -> "MaxMixturePrior":
        """From the mixture's means [M, D], covariances [M, D, D] and
        weights [M] (float64 on the host, then float32 buffers)."""
        precisions = np.stack([np.linalg.inv(c) for c in covs])
        sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
        const = (2 * np.pi) ** (means.shape[1] / 2.0)
        nll_weights = weights / (const * (sqrdets / sqrdets.min()))
        return MaxMixturePrior(means, precisions, np.log(nll_weights))

    def forward(self, body_pose: torch.Tensor, *_args) -> torch.Tensor:
        """body_pose [B, D] -> the per-sample min-mixture NLL [B]."""
        diff = body_pose[:, None, :] - self.means                # [B, M, D]
        prod = torch.einsum("mij,bmj->bmi", self.precisions, diff)
        quad = torch.sum(prod * diff, dim=-1)                    # [B, M]
        nll = 0.5 * quad - self.log_nll_weights
        return torch.min(nll, dim=-1).values


def synthetic_gmm(seed: int = 0, num_gaussians: int = 6,
                  dim: int = 69) -> dict:
    """A stand-in for SMPLify's ``gmm_06.pkl``, as the dict that file holds:
    ``num_gaussians`` Gaussians over the ``dim``-dim body pose, with means,
    SPD covariances and weights drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    means = rng.randn(num_gaussians, dim) * 0.3
    covs = np.stack([a @ a.T + np.eye(dim) * 0.5 for a in
                     (rng.randn(dim, dim) * 0.05
                      for _ in range(num_gaussians))])
    w = rng.rand(num_gaussians)
    return {"means": means, "covars": covs, "weights": w / w.sum()}


def _no_prior(*_args):
    return 0.0


def create_prior(prior_type: str = "gmm", prior_folder: str = "deps/gmm",
                 num_gaussians: int = 6):
    """"gmm" (the L2 prior where ``gmm_06.pkl`` is absent), "l2", "angle"
    or "none"."""
    if prior_type == "gmm":
        prior = MaxMixturePrior.load(prior_folder, num_gaussians)
        return l2_prior if prior is None else prior
    if prior_type == "l2":
        return l2_prior
    if prior_type == "angle":
        return angle_prior
    if prior_type in (None, "none"):
        return _no_prior
    raise ValueError(f"Prior {prior_type} is not implemented")
