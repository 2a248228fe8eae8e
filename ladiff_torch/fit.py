"""SMPL fitting entry point of the port (counterpart of the root ``fit.py``):
generated joints -> SMPL pose parameters.

    python -m ladiff_torch.fit --npy sample.npy [--dir folder] [--iters 300]
        [--smpl deps/smpl_models/smpl/SMPL_NEUTRAL.pkl] [--gmm deps/gmm]
        [--num_joints 0|21|22] [--save_folder out] [--cpu]

SMPLify-3D recast: per-frame SMPL pose and translation and shared betas are
optimised with Adam through the differentiable LBS, every frame at once, on
the card unless ``--cpu`` (or ``device="cpu"``).  The loss is the JAX
package's: the Geman-McClure joint error, the GMM max-mixture pose prior
(the L2 prior where ``gmm_06.pkl`` is absent), the knee / elbow angle prior,
the betas prior and a temporal smoothness term, over T * J.  Each file's
parameters go to ``<name>_smpl.npz`` (``pose`` [T, 24, 3], ``betas`` [10],
``trans`` [T, 3]).  Without the SMPL ``.pkl`` the body is synthetic, with a
warning: the outputs are then only structurally valid.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Callable, Optional

import numpy as np
import torch

from ladiff_torch.smpl.prior import angle_prior, create_prior, gmof
from ladiff_torch.utils.device import resolve_device

__all__ = ["fit_sequence", "fit_loss", "main"]


def fit_loss(model, params, target: torch.Tensor, pose_prior: Callable,
             smooth_weight: float) -> torch.Tensor:
    """The fitting loss at ``params`` (pose [T, 24, 3], betas [10], trans
    [T, 3]) against target joints [T, J, 3]: the reference's
    ``body_fitting_loss_3d`` weights (joints 500^2 under Geman-McClure at
    sigma 100, pose prior (4.78 * 1.5)^2, angle prior 15.2^2, betas 5^2)
    plus ``smooth_weight`` times the frame-to-frame pose change, over
    T * J."""
    T, J, _ = target.shape
    scale = 1.0 / (T * J)
    pose, betas = params["pose"], params["betas"]
    joints = model(pose, betas, params["trans"])
    body_pose = pose[:, 1:].reshape(T, 69)
    jl = (500.0 ** 2) * gmof(joints[:, :J] - target, 100.0).sum((-1, -2))
    prior_l = ((4.78 * 1.5) ** 2) * pose_prior(body_pose, betas)
    ang_l = (15.2 ** 2) * angle_prior(body_pose).sum(-1)
    shape_l = (5.0 ** 2) * torch.sum(betas ** 2)
    smooth = smooth_weight * torch.sum((pose[1:] - pose[:-1]) ** 2)
    return scale * (torch.sum(jl + prior_l + ang_l) + shape_l + smooth)


def fit_sequence(model, target_joints: np.ndarray, iters: int = 300,
                 lr: float = 0.05, smooth_weight: float = 1e-3,
                 gmm_dir: str = "deps/gmm", verbose: bool = False,
                 device=None, pose_prior: Optional[Callable] = None):
    """target_joints [T, J <= 24, 3] -> ({"pose": [T, 24, 3], "betas": [10],
    "trans": [T, 3]} as numpy, the loss of the last step).

    Starts from zero pose and betas with each frame's root joint as its
    translation, then takes ``iters`` Adam steps (lr, b1 0.9, b2 0.999, eps
    1e-8).  The loss returned is the one the last step's gradient came from,
    before that step's update.  The pose prior is ``pose_prior`` where
    given (one that ``create_prior`` returns), else ``gmm_dir``'s
    ``gmm_06.pkl`` (the L2 prior where it is absent); the model and the
    prior move to ``device`` (the card unless "cpu")."""
    device = resolve_device(device)
    model = model.to(device)
    if pose_prior is None:
        pose_prior = create_prior("gmm", gmm_dir)
    if isinstance(pose_prior, torch.nn.Module):
        pose_prior = pose_prior.to(device)
    T = target_joints.shape[0]
    target = torch.as_tensor(np.array(target_joints, np.float32),
                             device=device)
    params = {
        "pose": torch.zeros(T, 24, 3, device=device),
        "betas": torch.zeros(10, device=device),
        "trans": torch.as_tensor(
            np.asarray(target_joints[:, :1].mean(1), np.float32),
            device=device),
    }
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    loss = None
    with torch.enable_grad():
        for i in range(iters):
            opt.zero_grad(set_to_none=True)
            loss = fit_loss(model, params, target, pose_prior, smooth_weight)
            loss.backward()
            opt.step()
            if verbose and (i % 50 == 0 or i == iters - 1):
                print(f"  iter {i:4d}  loss {float(loss.detach()):.6f}")
    return ({k: v.detach().cpu().numpy() for k, v in params.items()},
            float("nan") if loss is None else float(loss.detach()))


def main(argv=None):
    from ladiff_torch.data.framerate import subsample
    from ladiff_torch.smpl.body_model import SMPLModel
    from ladiff_torch.utils.joints import mmm_to_smplh_scaling_factor

    ap = argparse.ArgumentParser(prog="python -m ladiff_torch.fit")
    ap.add_argument("--npy", type=str, default=None)
    ap.add_argument("--dir", type=str, default=None)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--smpl", type=str,
                    default="deps/smpl_models/smpl/SMPL_NEUTRAL.pkl")
    ap.add_argument("--gmm", type=str, default="deps/gmm",
                    help="folder with gmm_06.pkl (SMPLify pose prior); "
                         "falls back to an L2 prior when absent")
    ap.add_argument("--num_joints", type=int, default=0,
                    help="22 = HumanML3D (no resample), 21 = KIT mmm "
                         "(100 -> 12.5 fps decimation + smplh scaling); "
                         "0 = infer from data")
    ap.add_argument("--save_folder", type=str, default=None,
                    help="write <name>_smpl.npz files here instead of "
                         "next to the inputs")
    ap.add_argument("--cpu", action="store_true",
                    help="fit on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    model = SMPLModel.load(args.smpl)
    if model is None:
        print(f"WARNING: SMPL model not found at {args.smpl}; using a "
              "synthetic body model (outputs are only structurally valid)")
        model = SMPLModel.synthetic()

    files = []
    if args.npy:
        files.append(args.npy)
    if args.dir:
        files.extend(sorted(glob.glob(os.path.join(args.dir, "*.npy"))))
    if not files:
        ap.error("provide --npy or --dir")

    for f in files:
        joints = np.load(f)
        if joints.ndim != 3:
            print(f"skipping {f}: expected [T, J, 3]")
            continue
        nj = args.num_joints or joints.shape[1]
        if nj == 21:
            # KIT mmm joints: 100 fps capture decimated to 12.5 fps and
            # rescaled into SMPL-H units
            joints = joints[subsample(len(joints), 100, 12.5)]
            joints = joints * mmm_to_smplh_scaling_factor
        print(f"fitting {f} ({joints.shape[0]} frames)...")
        params, loss = fit_sequence(model, joints, iters=args.iters,
                                    gmm_dir=args.gmm, verbose=True,
                                    device=device)
        out = f.rsplit(".", 1)[0] + "_smpl.npz"
        if args.save_folder:
            os.makedirs(args.save_folder, exist_ok=True)
            out = os.path.join(args.save_folder, os.path.basename(out))
        np.savez(out, **params)
        print(f"  -> {out} (final loss {loss:.6f})")


if __name__ == "__main__":
    main()
