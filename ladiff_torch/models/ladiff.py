"""LADiff system (counterpart of ``ladiff_tpu/models/ladiff.py``).

Generation: text embeddings -> CFG DDIM over the latent set -> LA-VAE
decode -> features (-> joints).  With ``ardiff`` (the ARDIFF family) the
latents are sampled one token at a time, each by its own guided DDIM loop
conditioned on the tokens before it (``diffusion_reverse_ar``), and stage 2
trains one token per sample conditioned on its predecessor
(``diffusion_forward_ar``).  Training, three stages:

  * ``vae_forward``: the reconstruction pass with its losses (encode ->
    decode -> SmoothL1 on features and joints + KL);
  * ``diffusion_forward``: a frozen eval-mode encode, caption dropout,
    ``add_noise``, the denoiser in training mode, the noise-prediction MSE;
  * ``vae_diffusion_forward``: both of these plus the generation losses of a
    short guided sampling run (no gradient) and an eval-mode decode of its
    latents whose gradients reach the decoder.

The denoiser predicts the noise, or with ``predict_epsilon`` false (the
``PREDICT_EPSILON`` ablation) the clean latents: the schedule's
``prediction_type`` is then "sample" and both diffusion losses compare
latents.  The LA-VAE's ablation switches (``lad``, ``max_it`` 0,
``mlp_dist``, ``test_efficiency``) are ``models/vae.py``'s; the sampler
masks latent rows by length and stage 2 re-zeroes the noisy inactive rows
only where the VAE is length-aware (``lad`` and ``max_it``), as the JAX
package does.  The text condition is either pooled CLIP
features [B, 1, 768] (the published configurations) or the full context
[B, 77, 768] (``last_hidden_state``).  ``vae_type`` "ladiff" diffuses the
LA-VAE's latents; "no" (feature-space diffusion, the novae family) has no
VAE at all (``self.vae`` is None, no ``vae.*`` key): the denoiser
(``diffusion_only``) diffuses the padded feature frames [B, max_frames,
nfeats] under the frame mask, and ``generate`` returns them as they are.
``md_trans`` picks the denoiser's wiring: the MD-trans skip stack (the
published LADiff model) or the plain skip transformer (the novae and the
action configurations).

The action family (``condition="action"``, ``vae_type="actor"``: the
HumanAct12 and UESTC configurations): the ActorVae's single latent
[B, 1, D] (``max_it`` 0, ``latent_dim[0]`` latents, no row mask) is
diffused under the condition of class ids through the denoiser's
``EmbedAction`` table (zeros the unconditional branch, ``embed_action``);
the features are rot6d (+ translation), 150 wide, and ``rot2xyz`` (an SMPL
forward pass, ``transforms/rotation2xyz.py``) turns them into vertices for
the stage-1 joints loss (``feats2joints_action``) and into 24 SMPL joints
for the HumanAct12 classifier (``feats2joints_action_eval``).
``num_layers`` is the denoiser's depth and the VAE's unless
``vae_num_layers`` gives the VAE its own (15 and 6 in the HumanAct12
configurations).

``dtype`` is the compute type (bf16 on CUDA by default; float32 there
takes the kernels' float32 chains, K1, K2 and kernels 5 to 13, and the
plain route of CLIP, whose kernels K3 and K4 the JAX package runs in bf16
only) and ``param_dtype`` the
parameters' storage type, the same unless given: the trainer keeps float32
parameters and computes in bf16 or, as the published configurations ask,
in float32.

The state dict carries ``vae.*`` and ``denoiser.*`` keys in the reference
torch LADiff layout.  ``diffusion_reverse`` computes the step-invariant work
once before the step loop: the text projection, the timestep-embedding
table of every step and, with one text token, each MD layer's text value
and AdaLN rows.  The sampler is DDIM (``eta`` 0 or above) or ancestral DDPM
(``scheduler_kind``).  ``md_stack=True`` runs the denoiser's whole skip
stack as one call of kernel 11 per step (the JAX package's
``LADIFF_MD_STACK=1``; in float32 its chain of 131 launches); off by
default, as there.  ``train_whole_layer``
("0", "1", "enc", "dec": the JAX package's ``LADIFF_TRAIN_WHOLE_LAYER``)
runs the VAE's training layers as the whole-layer kernels 12 (encoder) and
13 (decoder) where their shapes allow; off by default, as there.
``from_cfg`` builds the system of an assembled configuration.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ladiff_torch.data.humanml.motion_repr import recover_from_ric
from ladiff_torch.diffusion.sampling import ddim_sample, make_cfg_denoise_fn
from ladiff_torch.diffusion.schedulers import ddim_timesteps, make_schedule
from ladiff_torch.losses.mld import (LossWeights, diffusion_loss, smooth_l1,
                                     vae_loss)
from ladiff_torch.models.actor_vae import ActorVae
from ladiff_torch.models.denoiser import LADenoiser
from ladiff_torch.models.vae import LAVae
from ladiff_torch.ops.cuda_common import kernel_compute, kernel_dtypes
from ladiff_torch.ops.md_layer import md_layer_supported
from ladiff_torch.smpl.body_model import SMPLModel
from ladiff_torch.transforms.rotation2xyz import Rotation2xyz
from ladiff_torch.utils.device import resolve_device, resolve_dtype
from ladiff_torch.utils.masks import latent_valid_mask, lengths_to_mask

__all__ = ["LADiffSystem"]


def _mod_layers(m, key: str) -> Optional[int]:
    """A module's own ``num_layers`` in the assembled configuration
    (``model.<key>.params.num_layers``), None where it has none."""
    n = ((m.get(key) or {}).get("params") or {}).get("num_layers")
    return None if n is None else int(n)


@contextlib.contextmanager
def _mode(module: nn.Module, training: bool):
    """``module`` in training or eval mode inside the block, its own mode
    afterwards."""
    was_training = module.training
    module.train(training)
    try:
        yield
    finally:
        module.train(was_training)


class LADiffSystem(nn.Module):
    def __init__(self, nfeats: int, njoints: int, max_frames: int = 196,
                 latent_dim: Sequence[int] = (7, 256), ff_size: int = 1024,
                 num_layers: int = 9, num_heads: int = 4, max_it: int = 5,
                 frame_per_latent: int = 48, text_encoded_dim: int = 768,
                 guidance_scale: float = 7.5,
                 guidance_uncondp: float = 0.1,
                 num_inference_timesteps: int = 50,
                 num_train_timesteps: int = 1000,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None,
                 dropout: float = 0.0, dvae: bool = False,
                 percentage_noised: float = 0.0,
                 weights: Optional[LossWeights] = None,
                 eta: float = 0.0, scheduler_kind: str = "ddim",
                 md_stack: bool = False, train_whole_layer: str = "0",
                 md_trans: bool = True, vae_type: str = "ladiff",
                 lad: bool = True, mlp_dist: bool = False,
                 test_efficiency: bool = False, predict_epsilon: bool = True,
                 ardiff: bool = False,
                 motion_conditioning: str = "last",
                 condition: str = "text", nclasses: int = 12,
                 rot2xyz: Optional[nn.Module] = None,
                 vae_num_layers: Optional[int] = None,
                 device=None, dtype: Optional[torch.dtype] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        D = int(latent_dim[-1])
        if vae_type not in ("ladiff", "no", "actor"):
            raise ValueError(f"vae_type (VAE_TYPE) {vae_type!r}: ladiff, "
                             "actor or no")
        if motion_conditioning not in ("last", "full", "middle"):
            raise ValueError(f"motion_conditioning {motion_conditioning!r}: "
                             "last, full or middle")
        if ardiff and vae_type != "ladiff":
            raise ValueError(f"ardiff diffuses the LA-VAE's latent tokens; "
                             f"vae_type {vae_type!r} has none")
        # the diffused latents: the LA-VAE's max_it rows (under their row
        # mask where it is length-aware), or latent_dim[0] rows without one
        # (the fixed-size set of max_it 0, the ActorVae's 1)
        n_latents = max_it or int(latent_dim[0])
        if md_stack and not (md_trans and num_layers % 2
                             and md_layer_supported(1, n_latents, 2, D,
                                                    num_heads, 1024,
                                                    ff_size)):
            raise ValueError(
                "md_stack: the whole-stack kernel does not take the denoiser "
                f"shape T={n_latents} E=2 D={D} H={num_heads} "
                f"F=1024,{ff_size} L={num_layers} md_trans={md_trans}")
        want = torch.device("cuda" if device is None else device)
        if md_stack and not kernel_compute(resolve_dtype(want, dtype), want,
                                           "fused_md_stack"):
            raise ValueError(
                f"md_stack: the whole-stack kernel computes in "
                f"{kernel_dtypes('fused_md_stack')}, not {dtype} on {want}")
        if scheduler_kind not in ("ddim", "ddpm"):
            raise ValueError(f"unknown scheduler kind {scheduler_kind}")
        device = resolve_device(device)
        dtype = resolve_dtype(device, dtype)
        self.dtype = dtype
        self.weights = weights or LossWeights()
        self.nfeats, self.njoints = nfeats, njoints
        self.max_frames = max_frames
        self.latent_dim = tuple(int(v) for v in latent_dim)
        self.max_it = max_it
        self.frame_per_latent = frame_per_latent
        self.guidance_scale = guidance_scale
        self.guidance_uncondp = guidance_uncondp
        self.num_inference_timesteps = num_inference_timesteps
        self.eta = eta
        self.scheduler_kind = scheduler_kind
        self.md_stack = md_stack
        self.md_trans = md_trans
        self.vae_type = vae_type
        self.lad = lad
        self.predict_epsilon = predict_epsilon
        self.ardiff = ardiff
        self.motion_conditioning = motion_conditioning
        self.condition = condition
        self.n_latents = n_latents
        self.schedule = make_schedule(
            num_train_timesteps,
            prediction_type="epsilon" if predict_epsilon else "sample")
        self.vae = None
        vae_layers = vae_num_layers or num_layers
        if vae_type == "ladiff":
            self.vae = LAVae(nfeats, latent_dim, ff_size, vae_layers,
                             num_heads, max_it, frame_per_latent,
                             dropout=dropout, dvae=dvae,
                             percentage_noised=percentage_noised,
                             train_whole_layer=train_whole_layer, lad=lad,
                             mlp_dist=mlp_dist,
                             test_efficiency=test_efficiency)
        elif vae_type == "actor":
            self.vae = ActorVae(nfeats, latent_dim, ff_size, vae_layers,
                                num_heads, dropout=dropout,
                                train_whole_layer=train_whole_layer)
        if self.vae is not None:
            self.vae.compute_dtype = dtype
        self.denoiser = LADenoiser(nfeats, latent_dim, ff_size, num_layers,
                                   num_heads, text_encoded_dim,
                                   dropout=dropout, md_trans=md_trans,
                                   diffusion_only=vae_type == "no",
                                   condition=condition, nclasses=nclasses,
                                   guidance_uncondp=guidance_uncondp)
        self.denoiser.compute_dtype = dtype
        for name, v in (("mean", mean), ("std", std)):
            self.register_buffer(
                name, None if v is None else torch.as_tensor(
                    np.asarray(v, np.float32)), persistent=False)
        self.to(device=device, dtype=param_dtype or dtype)
        # the SMPL forward pass computes in float32 whatever the compute
        # type: it joins after the cast (the synthetic body where an action
        # system is given none)
        if rot2xyz is None and condition == "action":
            rot2xyz = Rotation2xyz(SMPLModel.synthetic())
        self.rot2xyz = None if rot2xyz is None else rot2xyz.to(device)
        self.eval()

    @classmethod
    def from_cfg(cls, cfg, nfeats: int, njoints: int, mean=None, std=None,
                 **kw) -> "LADiffSystem":
        """The system of an assembled configuration (``ladiff_torch.config``;
        the JAX package's ``LADiffSystem.from_cfg``); ``kw`` are the
        constructor's run options (``train_whole_layer``, ``device``,
        ``dtype``, ``param_dtype``, ``md_stack``).  The port has the text
        and the action condition (``model.condition``, the action family's
        ``DATASET.NCLASSES`` classes and SMPL body under
        ``DATASET.SMPL_PATH``, synthetic where the file is absent), the
        LA-VAE, the ActorVae (``VAE_TYPE`` "actor") or none ("no"), the
        MD-trans or the plain denoiser, each module at its own depth
        (``model.motion_vae.params.num_layers``,
        ``model.denoiser.params.num_layers``), autoregressive latent
        diffusion (``ARDIFF``, ``model.motion_conditioning``) and the
        ablation switches of ``TRAIN.ABLATION`` that the JAX package reads
        (``LAD``, ``MAX_IT``, ``MLP_DIST``, ``TEST_EFFICIENCY``,
        ``PREDICT_EPSILON``).  The JAX package reads neither
        ``model.activation`` (its modules compute GELU whatever the key
        says) nor the novae family's ``arch: trans_dec`` (it builds the
        skip encoder): the port follows the JAX package."""
        abl, m = cfg.TRAIN.ABLATION, cfg.model
        sched = m.get("scheduler") or {}
        layers = int(m.num_layers)
        vae_type = str(abl.get("VAE_TYPE", "ladiff"))
        # the LA-VAE's stage-1 configurations name the plain denoiser, which
        # their stage never runs: the port keeps the MD-trans one there, so
        # that a stage-1 system loads a stage-2 checkpoint (``test.py`` stage
        # vae).  The action family's stage-2 denoiser is the plain one.
        md_trans = bool(abl.get("MD_TRANS", False)) or (
            str(cfg.TRAIN.get("STAGE", "vae")) == "vae"
            and vae_type == "ladiff")
        condition = str(m.get("condition", "text"))
        text_dim = ((m.get("denoiser") or {}).get("params") or {}).get(
            "text_encoded_dim", 768)
        kind = str(sched.get("kind", "") or (
            "ddpm" if "DDPM" in str(sched.get("target", "")) else "ddim"))
        return cls(
            nfeats=nfeats, njoints=njoints,
            max_frames=int(cfg.DATASET.SAMPLER.MAX_LEN),
            latent_dim=tuple(m.latent_dim), ff_size=int(m.ff_size),
            num_layers=_mod_layers(m, "denoiser") or layers,
            num_heads=int(m.num_head),
            max_it=int(abl.get("MAX_IT", 5)),
            frame_per_latent=int(abl.get("FRAME_PER_LATENT", 48)),
            text_encoded_dim=int(text_dim),
            guidance_scale=float(m.guidance_scale),
            guidance_uncondp=float(m.guidance_uncondp),
            num_inference_timesteps=int(
                sched.get("num_inference_timesteps", 50)),
            num_train_timesteps=int((sched.get("params") or {}).get(
                "num_train_timesteps", 1000)),
            mean=mean, std=std,
            dropout=float(m.droupout),  # sic: the reference key's spelling
            dvae=bool(abl.get("DVAE", False)),
            percentage_noised=float(abl.get("PERCENTAGE_NOISED", 0.0)),
            weights=LossWeights.from_cfg(cfg),
            eta=float(sched.get("eta", 0.0)), scheduler_kind=kind,
            md_trans=md_trans, vae_type=vae_type,
            lad=bool(abl.get("LAD", True)),
            mlp_dist=bool(abl.get("MLP_DIST", False)),
            test_efficiency=bool(abl.get("TEST_EFFICIENCY", False)),
            predict_epsilon=bool(abl.get("PREDICT_EPSILON", True)),
            ardiff=bool(cfg.get("ARDIFF", False)),
            motion_conditioning=str(m.get("motion_conditioning", "last")),
            condition=condition,
            nclasses=int(cfg.DATASET.get("NCLASSES", 12)),
            rot2xyz=(Rotation2xyz.from_path(str(cfg.DATASET.get(
                "SMPL_PATH", "./deps/smpl_models/smpl")))
                if condition == "action" else None),
            vae_num_layers=_mod_layers(m, "motion_vae"),
            **kw)

    @property
    def device(self) -> torch.device:
        return self.denoiser.time_embedding.linear_1.weight.device

    def _require_vae(self, what: str) -> None:
        if self.vae is None:
            raise NotImplementedError(
                f"{what} needs a VAE; vae_type {self.vae_type!r} has none "
                "(feature-space diffusion trains the denoiser alone, as in "
                "the JAX package)")

    def feats2joints_action(self, feats: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
        """The action family's SMPL vertices [B, T, V, 3] (float32,
        ``vertstrans=False``): the stage-1 joints loss's."""
        return self.rot2xyz(feats, mask, jointstype="vertices",
                            vertstrans=False)

    def feats2joints_action_eval(self, feats: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
        """The action family's 24 SMPL joints [B, T, 24, 3] (float32,
        ``vertstrans=True``): what the HumanAct12 GRU classifier reads."""
        return self.rot2xyz(feats, mask, jointstype="smpl", vertstrans=True)

    def feats2joints(self, feats: torch.Tensor) -> torch.Tensor:
        """Denormalize + RIC recovery -> joints [..., T, J, 3]."""
        feats = feats.float()
        if self.mean is not None:
            feats = feats * self.std.float() + self.mean.float()
        return recover_from_ric(feats, self.njoints)

    def renorm4t2m(self, feats: torch.Tensor, mean_eval,
                   std_eval) -> torch.Tensor:
        """Features normalized by the training stats -> normalized by the
        T2M evaluators' (reference HumanML3D.py:57-65), in float32."""
        feats = feats.float() * self.std.float() + self.mean.float()
        mean_eval = torch.as_tensor(mean_eval, dtype=torch.float32,
                                    device=feats.device)
        std_eval = torch.as_tensor(std_eval, dtype=torch.float32,
                                   device=feats.device)
        return (feats - mean_eval) / std_eval

    @torch.no_grad()
    def diffusion_reverse(self, text_emb_cond: torch.Tensor,
                          text_emb_uncond: torch.Tensor,
                          lengths: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          num_inference_timesteps: Optional[int] = None,
                          init_latents: Optional[torch.Tensor] = None,
                          return_trajectory: bool = False):
        """CFG sampling of latents [B, n_latents, D] (float32; with
        ``vae_type`` "no" the feature frames [B, max_frames, nfeats], padded
        frames zero); with ``return_trajectory`` also every step's latents
        [steps, *shape].  With the action condition the two conditions are
        ``denoiser.embed_action``'s tokens [B, 1, D] (zeros unconditioned),
        which the projection passes through."""
        B = text_emb_cond.shape[0]
        dev = self.device
        lengths = lengths.to(dev)
        if self.vae is None:
            # the frame mask is the sampler's row mask and the denoiser's
            shape = (B, self.max_frames, self.nfeats)
            lat_valid = lengths_to_mask(lengths, self.max_frames)
        else:
            # rows masked by length where the LA-VAE is length-aware; the
            # fixed-size set and the ActorVae's single latent have no mask
            shape = (B, self.n_latents, self.latent_dim[-1])
            lat_valid = (latent_valid_mask(lengths, self.frame_per_latent,
                                           self.max_it)
                         if self.lad and self.max_it else None)
        steps = num_inference_timesteps or self.num_inference_timesteps
        den = self.denoiser
        text_cond = den.project_text(text_emb_cond.to(dev))
        text_uncond = den.project_text(text_emb_uncond.to(dev))
        ts, _ = ddim_timesteps(self.schedule.num_train_timesteps, steps,
                               1 if self.scheduler_kind == "ddim" else 0)
        time_table = den.compute_time_embedding(
            torch.as_tensor(ts.astype(np.int64), device=dev))
        text2 = (torch.cat([text_uncond, text_cond], dim=0)
                 if self.guidance_scale > 1.0 else text_cond)

        # the MD layers' step-invariant prep exists for one text token only
        # (the collapsed cross-attention); the stack takes it laid out by
        # layer, with the stacked tensors beside it
        ss_tables = stack = None
        if self.md_stack and text2.shape[1] != 1:
            raise ValueError("md_stack: the whole-stack kernel takes one "
                             f"text token, got {text2.shape[1]}")
        if self.md_trans and text2.shape[1] == 1:
            prep_all = den.precompute_md_prep(text2, time_table,
                                              with_params=not self.md_stack)
            if self.md_stack:
                values, ca_t, ffn_t = den.stack_md_prep(prep_all)
                stack = {"params": den.precompute_md_stack(),
                         "values": values}
                ss_tables = (ca_t, ffn_t)

        def denoise(latents, step, text, valid):
            time_emb = time_table[step][None].expand(latents.shape[0], -1)
            md_prep = None
            if stack is not None:
                md_prep = {"stack": {**stack, "ca_ss": ss_tables[0][step],
                                     "ffn_ss": ss_tables[1][step]}}
            elif self.md_trans and text.shape[1] == 1:
                md_prep = [{"value": p["value"], "ca_ss": p["ca_ss"][step],
                            "ffn_ss": p["ffn_ss"][step],
                            "params": p["params"]} for p in prep_all]
            return den(latents, latent_valid=valid, time_emb=time_emb,
                       text_emb_latent=text, md_prep=md_prep,
                       frame_valid=valid if self.vae is None else None)

        guided = make_cfg_denoise_fn(denoise, text_uncond, text_cond,
                                     self.guidance_scale)
        return ddim_sample(guided, self.schedule, shape, steps,
                           latent_valid=lat_valid, generator=generator,
                           init_latents=init_latents, device=dev,
                           eta=self.eta, kind=self.scheduler_kind,
                           return_trajectory=return_trajectory)

    @torch.no_grad()
    def diffusion_reverse_ar(self, text_emb_cond: torch.Tensor,
                             text_emb_uncond: torch.Tensor,
                             lengths: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             num_inference_timesteps: Optional[int] = None,
                             init_latents: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
        """Autoregressive CFG sampling of latents [B, max_it, D] (float32):
        one latent token at a time, each from its own noise [B, 1, D]
        (``torch.randn`` from ``generator``, or row k of ``init_latents``
        [B, max_it, D] for token k) through a DDIM loop over the
        guided denoiser, conditioned on the token before it
        (``motion_conditioning`` "last": one conditioning row, masked at
        token 0) or on every earlier token ("full", and "middle", which
        conditions like "full" at inference: all max_it rows, those not yet
        sampled masked).  It runs ``ceil(max(lengths) / frame_per_latent)``
        tokens, as the reference does; the rows past each sample's active
        count are zero at the end.  The text projection, the time-embedding
        table and, with one text token, each MD layer's text value and AdaLN
        rows are computed once for every token; the MD layers run as K1
        where they take the shape (never the whole stack)."""
        B = text_emb_cond.shape[0]
        D, M = self.latent_dim[-1], self.max_it
        if not M:
            raise ValueError(
                "diffusion_reverse_ar with max_it (MAX_IT) 0: the sampler "
                "has max_it token positions, so none to sample (the JAX "
                "package returns zero rows there)")
        dev = self.device
        lengths = lengths.to(dev)
        lat_valid = latent_valid_mask(lengths, self.frame_per_latent, M)
        steps = num_inference_timesteps or self.num_inference_timesteps
        den = self.denoiser
        text_cond = den.project_text(text_emb_cond.to(dev))
        text_uncond = den.project_text(text_emb_uncond.to(dev))
        ts, prev_ts = ddim_timesteps(self.schedule.num_train_timesteps, steps)
        time_table = den.compute_time_embedding(
            torch.as_tensor(ts.astype(np.int64), device=dev))
        do_cfg = self.guidance_scale > 1.0
        text2 = (torch.cat([text_uncond, text_cond], dim=0) if do_cfg
                 else text_cond)
        prep_all = None
        if self.md_trans and text2.shape[1] == 1:
            prep_all = den.precompute_md_prep(text2, time_table)

        def denoise(latents, step, text, enclat, enclat_valid):
            n = latents.shape[0]
            md_prep = None
            if prep_all is not None:
                md_prep = [{"value": p["value"], "ca_ss": p["ca_ss"][step],
                            "ffn_ss": p["ffn_ss"][step],
                            "params": p["params"]} for p in prep_all]
            return den(latents, time_emb=time_table[step][None].expand(n, -1),
                       text_emb_latent=text, md_prep=md_prep, enclat=enclat,
                       enclat_valid=enclat_valid)

        final = torch.zeros(B, M, D, device=dev)
        tokens = min(M, -(-int(lengths.max()) // self.frame_per_latent))
        for k in range(tokens):
            if init_latents is None:
                latents = torch.randn((B, 1, D), generator=generator,
                                      device=dev, dtype=torch.float32)
            else:
                latents = init_latents[:, k:k + 1].to(dev, torch.float32)
            latents = latents * self.schedule.init_noise_sigma
            if self.motion_conditioning == "last":
                j = max(k - 1, 0)
                enclat = final[:, j:j + 1]
                enclat_valid = torch.full((B, 1), k > 0, device=dev)
            else:
                enclat = final
                enclat_valid = (torch.arange(M, device=dev) < k)[None].expand(
                    B, M)
            if do_cfg:  # the guided batch [uncond; cond]
                enclat = torch.cat([enclat, enclat], dim=0)
                enclat_valid = torch.cat([enclat_valid, enclat_valid], dim=0)
            guided = make_cfg_denoise_fn(
                lambda x, i, text, valid: denoise(x, i, text, enclat,
                                                  enclat_valid),
                text_uncond, text_cond, self.guidance_scale)
            for i, (t, t_prev) in enumerate(zip(ts.tolist(),
                                                prev_ts.tolist())):
                latents = self.schedule.ddim_step(
                    guided(latents, i, None), t, t_prev, latents, eta=self.eta)
            final[:, k] = latents[:, 0]
        return torch.where(lat_valid[:, :, None], final,
                           torch.zeros((), device=dev))

    @torch.no_grad()
    def generate(self, text_emb_cond: torch.Tensor,
                 text_emb_uncond: torch.Tensor, lengths: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 nframes: Optional[int] = None,
                 num_inference_timesteps: Optional[int] = None,
                 init_latents: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Text embeddings, pooled [B, 1, 768] or the full context [B, N,
        768] (``last_hidden_state``), the unconditional ones of the same
        shape (the action condition: ``denoiser.embed_action``'s [B, 1, D]
        and zeros) -> (features [B, nframes, nfeats], latents [B,
        n_latents, D]).
        With ``vae_type`` "no" the sampled frames are the features: (z, z),
        [B, max_frames, nfeats] whatever ``nframes``, as in the JAX
        package.  With ``ardiff`` the latents come from
        ``diffusion_reverse_ar``, row k of ``init_latents`` being token k's
        initial noise."""
        if self.ardiff:
            z = self.diffusion_reverse_ar(text_emb_cond, text_emb_uncond,
                                          lengths, generator,
                                          num_inference_timesteps,
                                          init_latents)
        else:
            z = self.diffusion_reverse(text_emb_cond, text_emb_uncond,
                                       lengths, generator,
                                       num_inference_timesteps, init_latents)
        if self.vae is None:
            return z, z
        feats = self.vae.decode(z.to(self.dtype), lengths.to(self.device),
                                nframes or self.max_frames)
        return feats, z

    def vae_forward(self, batch: Dict[str, torch.Tensor], train: bool = True,
                    generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None):
        """Stage-1 reconstruction pass and its losses: returns
        ``(total, (logs, aux))``.  ``batch``: "motion" [B, T, nfeats] and
        "length" [B].  ``train`` switches the VAE's mode (dropout, the
        training kernels); differentiable in the VAE's parameters when
        ``train``; the VAE's mode is restored afterwards.  ``generator``
        drives dropout and, unless ``eps`` [B, n_latents, D] is given, the
        latent sample.  With the action condition the joints terms compare
        SMPL vertices (``feats2joints_action``) under the batch's "mask"
        [B, T] (the frame mask of "length" where it has none)."""
        self._require_vae("vae_forward (stage vae)")
        dev = self.device
        feats_ref = batch["motion"].to(dev)
        lengths = batch["length"].to(dev)
        with _mode(self.vae, train):
            z, mu, logvar, lat_valid = self.vae.encode(
                feats_ref, lengths, eps=eps, generator=generator)
            feats_rst = self.vae.decode(z, lengths, feats_ref.shape[1],
                                        generator=generator)
        if self.condition == "action":
            mask = batch.get("mask")
            mask = (lengths_to_mask(lengths, feats_ref.shape[1])
                    if mask is None else mask.to(dev))
            joints_rst = self.feats2joints_action(feats_rst, mask)
            joints_ref = self.feats2joints_action(feats_ref, mask)
        else:
            joints_rst = self.feats2joints(feats_rst)
            joints_ref = self.feats2joints(feats_ref)
        total, logs = vae_loss(feats_rst, feats_ref, joints_rst, joints_ref,
                               mu, logvar, self.weights)
        aux = {"feats_rst": feats_rst, "z": z, "latent_valid": lat_valid,
               "joints_rst": joints_rst, "joints_ref": joints_ref}
        return total, (logs, aux)

    def diffusion_forward(self, batch: Dict[str, torch.Tensor],
                          uncond_emb: torch.Tensor, train: bool = True,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None,
                          timesteps: Optional[torch.Tensor] = None,
                          cond_drop: Optional[torch.Tensor] = None,
                          eps: Optional[torch.Tensor] = None):
        """Stage-2 noise-prediction pass and its loss: returns ``(total,
        (logs, aux))``.  ``batch``: "motion" [B, T, nfeats], "length" [B]
        and "text_emb" [B, 1, text_encoded_dim] pooled text features;
        ``uncond_emb`` [1, 1, text_encoded_dim] replaces a caption with
        probability ``guidance_uncondp`` when ``train``.

        The VAE is frozen: the encode runs in eval mode without a graph, so
        no VAE parameter gets a gradient even where it requires one.
        ``train`` switches the denoiser's mode (dropout, the unfused MD
        layers with a backward); both modes are restored afterwards.  Every
        random draw comes from ``generator`` on the system's device unless
        given: ``eps`` [B, n_latents, D] the latent sample's noise,
        ``cond_drop`` [B, 1, 1] bool the captions to drop, ``noise`` [B,
        n_latents, D],
        ``timesteps`` [B].

        With ``vae_type`` "no" z is the features themselves (float32, no
        encode, ``eps`` unused), ``noise`` is [B, T, nfeats], the noisy
        frames are not re-zeroed and the denoiser zeroes its prediction on
        the padded frames (the JAX package's feature-space branch).

        With the action condition ``batch`` has "action" [B, 1] class ids in
        place of "text_emb", ``uncond_emb`` is unused, and ``cond_drop``
        [B, 1, 1] (drawn at the same point of the order) is the samples
        whose action token the denoiser's ``EmbedAction`` zeroes in
        training."""
        dev = self.device
        feats_ref = batch["motion"].to(dev)
        lengths = batch["length"].to(dev)
        action = self.condition == "action"
        cond = (batch["action"].to(dev)[:, 0] if action
                else batch["text_emb"].to(dev))
        B = feats_ref.shape[0]
        frame_valid = None
        if self.vae is None:
            z, lat_valid = feats_ref.float(), None
            frame_valid = lengths_to_mask(lengths, feats_ref.shape[1])
        else:
            with _mode(self.vae, False), torch.no_grad():
                z, _, _, lat_valid = self.vae.encode(
                    feats_ref, lengths, eps=eps, generator=generator)

        if train and self.guidance_uncondp > 0.0:
            if cond_drop is None:
                cond_drop = torch.rand(
                    (B, 1, 1), generator=generator,
                    device=dev) < self.guidance_uncondp
            if not action:
                cond = torch.where(
                    cond_drop.to(dev),
                    uncond_emb.to(device=dev, dtype=cond.dtype), cond)
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, device=dev)
        noise = noise.to(device=dev, dtype=z.dtype)
        if timesteps is None:
            timesteps = torch.randint(
                0, self.schedule.num_train_timesteps, (B,),
                generator=generator, device=dev)
        timesteps = timesteps.to(dev)
        noisy = self.schedule.add_noise(z, noise, timesteps)
        if self.lad and lat_valid is not None:
            # inactive latent rows stay zero after noising
            noisy = torch.where(lat_valid[:, :, None], noisy,
                                torch.zeros((), dtype=noisy.dtype,
                                            device=dev))
        with _mode(self.denoiser, train):
            pred = self.denoiser(
                noisy, timesteps, cond, lat_valid, generator=generator,
                frame_valid=frame_valid,
                cond_drop=cond_drop if action and train else None)
        total, logs = self._diffusion_loss(pred, noise, z)
        return total, (logs, {"latent_valid": lat_valid})

    def _diffusion_loss(self, pred, noise, x0):
        """The noise-prediction MSE, or with ``predict_epsilon`` false the
        MSE of the predicted clean latents ``x0``."""
        if self.predict_epsilon:
            return diffusion_loss(pred, noise)
        return diffusion_loss(pred, noise, predict_epsilon=False,
                              x0_pred=pred, x0=x0)

    def diffusion_forward_ar(self, batch: Dict[str, torch.Tensor],
                             uncond_emb: torch.Tensor, train: bool = True,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[torch.Tensor] = None,
                             timesteps: Optional[torch.Tensor] = None,
                             cond_drop: Optional[torch.Tensor] = None,
                             latent_idx: Optional[torch.Tensor] = None,
                             coin: Optional[torch.Tensor] = None,
                             eps: Optional[torch.Tensor] = None,
                             latent_u: Optional[torch.Tensor] = None):
        """Stage 2 of the autoregressive family: returns ``(total, (logs,
        aux))`` as ``diffusion_forward``.  The frozen encode gives each
        sample's latent tokens; one token per sample is noised and denoised
        with the token before it as its conditioning row (masked for token
        0).  The token is ``latent_idx`` [B] (an index in 1 .. n - 1 of a
        sample's n active tokens) unless ``coin`` (a bool, true with
        probability 1/3) or a sample with one active token sends it to token
        0, trained unconditioned.  Every draw comes from ``generator`` on the
        system's device unless given: ``eps`` [B, n_latents, D] the encode's
        noise, ``cond_drop`` [B, 1, 1], ``latent_idx`` [B] (or ``latent_u``
        [B], the uniform draw it is made from), ``coin`` [], ``noise`` [B, 1,
        D], ``timesteps`` [B]."""
        self._require_vae("diffusion_forward_ar")
        dev = self.device
        feats_ref = batch["motion"].to(dev)
        lengths = batch["length"].to(dev)
        cond = batch["text_emb"].to(dev)
        B, D = feats_ref.shape[0], self.latent_dim[-1]
        with _mode(self.vae, False), torch.no_grad():
            z, _, _, lat_valid = self.vae.encode(
                feats_ref, lengths, eps=eps, generator=generator)
        z = z.float()
        n_active = lat_valid.sum(dim=1)
        if train and self.guidance_uncondp > 0.0:
            if cond_drop is None:
                cond_drop = torch.rand(
                    (B, 1, 1), generator=generator,
                    device=dev) < self.guidance_uncondp
            cond = torch.where(cond_drop.to(dev),
                               uncond_emb.to(device=dev, dtype=cond.dtype),
                               cond)
        if latent_idx is None:
            u = (torch.rand((B,), generator=generator, device=dev)
                 if latent_u is None else latent_u.to(dev))
            latent_idx = 1 + torch.floor(
                u * (n_active - 1).clamp_min(1)).long()
            latent_idx = torch.minimum(latent_idx,
                                       (n_active - 1).clamp_min(0))
        if coin is None:
            coin = torch.rand((), generator=generator, device=dev) < 1.0 / 3
        latent_idx = torch.where(coin.to(dev) | (n_active <= 1),
                                 torch.zeros_like(n_active),
                                 latent_idx.to(dev))
        take = lambda idx: z.gather(1, idx[:, None, None].expand(B, 1, D))
        z_tok = take(latent_idx)
        cond_tok = take((latent_idx - 1).clamp_min(0))
        cond_valid = (latent_idx > 0)[:, None]
        if noise is None:
            noise = torch.randn(z_tok.shape, generator=generator, device=dev)
        noise = noise.to(device=dev, dtype=z_tok.dtype)
        if timesteps is None:
            timesteps = torch.randint(
                0, self.schedule.num_train_timesteps, (B,),
                generator=generator, device=dev)
        timesteps = timesteps.to(dev)
        noisy = self.schedule.add_noise(z_tok, noise, timesteps)
        with _mode(self.denoiser, train):
            pred = self.denoiser(noisy, timesteps, cond, generator=generator,
                                 enclat=cond_tok, enclat_valid=cond_valid)
        total, logs = self._diffusion_loss(pred, noise, z_tok)
        return total, (logs, {"latent_valid": lat_valid,
                              "latent_idx": latent_idx})

    def vae_diffusion_forward(self, batch: Dict[str, torch.Tensor],
                              uncond_emb: torch.Tensor, train: bool = True,
                              generator: Optional[torch.Generator] = None,
                              eps: Optional[torch.Tensor] = None,
                              diffusion_draws: Optional[Dict[
                                  str, torch.Tensor]] = None,
                              init_latents: Optional[torch.Tensor] = None):
        """Joint stage: ``vae_forward`` + ``diffusion_forward`` + the
        generation losses.  Returns ``(total, (logs, vae aux))`` with logs
        ``vae_*``, ``diff_*``, ``gen_feature``, ``gen_joints``, ``total``.

        The generation branch samples latents from the batch's captions
        with ``min(num_inference_timesteps, 10)`` guided DDIM steps, the
        denoiser in eval mode and no graph, and decodes them with the VAE
        in eval mode and a graph: the decoder layers then take their
        training route at rate 0, so the SmoothL1 losses on the generated
        features and joints (``lambda_gen``, ``lambda_joint``) reach the
        decoder's parameters.  ``eps`` is ``vae_forward``'s,
        ``diffusion_draws`` the optional tensors of ``diffusion_forward`` by
        name, ``init_latents`` the sampler's initial noise."""
        self._require_vae("vae_diffusion_forward (stage vae_diffusion)")
        vae_total, (vae_logs, vae_aux) = self.vae_forward(
            batch, train=train, generator=generator, eps=eps)
        diff_total, (diff_logs, _) = self.diffusion_forward(
            batch, uncond_emb, train=train, generator=generator,
            **(diffusion_draws or {}))

        dev = self.device
        feats_ref = batch["motion"].to(dev)
        lengths = batch["length"].to(dev)
        text_emb = batch["text_emb"].to(dev)
        with _mode(self.denoiser, False):
            z_gen = self.diffusion_reverse(
                text_emb, uncond_emb.to(dev).expand(text_emb.shape), lengths,
                generator, min(self.num_inference_timesteps, 10),
                init_latents)
        with _mode(self.vae, False):
            gen_feats = self.vae.decode(z_gen.to(self.dtype), lengths,
                                        feats_ref.shape[1])
        gen_feature = smooth_l1(gen_feats.float(), feats_ref.float())
        gen_joints = smooth_l1(self.feats2joints(gen_feats),
                               vae_aux["joints_ref"].float())
        w = self.weights
        total = (vae_total + diff_total + w.lambda_gen * gen_feature
                 + w.lambda_joint * gen_joints)
        logs = {**{f"vae_{k}": v for k, v in vae_logs.items()},
                **{f"diff_{k}": v for k, v in diff_logs.items()},
                "gen_feature": gen_feature, "gen_joints": gen_joints,
                "total": total}
        return total, (logs, vae_aux)
