"""LADiff system (counterpart of ``ladiff_tpu/models/ladiff.py``).

Generation: text embeddings -> CFG DDIM over the latent set -> LA-VAE
decode -> features (-> joints).  Training, three stages:

  * ``vae_forward``: the reconstruction pass with its losses (encode ->
    decode -> SmoothL1 on features and joints + KL);
  * ``diffusion_forward``: a frozen eval-mode encode, caption dropout,
    ``add_noise``, the denoiser in training mode, the noise-prediction MSE;
  * ``vae_diffusion_forward``: both of these plus the generation losses of a
    short guided sampling run (no gradient) and an eval-mode decode of its
    latents whose gradients reach the decoder.

Text condition, LA-VAE latents and epsilon prediction only.  The text is
either pooled CLIP features [B, 1, 768] (the published configurations) or
the full context [B, 77, 768] (``last_hidden_state``).

``dtype`` is the compute type (bf16 on CUDA by default, the kernels' type;
float32 there takes every module's plain route) and ``param_dtype`` the
parameters' storage type, the same unless given: the trainer keeps float32
parameters and computes in bf16 or, as the published configurations ask,
in float32.

The state dict carries ``vae.*`` and ``denoiser.*`` keys in the reference
torch LADiff layout.  ``diffusion_reverse`` computes the step-invariant work
once before the step loop: the text projection, the timestep-embedding
table of every step and, with one text token, each MD layer's text value
and AdaLN rows.  The sampler is DDIM (``eta`` 0 or above) or ancestral DDPM
(``scheduler_kind``).  ``md_stack=True`` runs the denoiser's whole skip
stack as one launch of kernel 11 per step (the JAX package's
``LADIFF_MD_STACK=1``); off by default, as there.  ``train_whole_layer``
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
from ladiff_torch.models.denoiser import LADenoiser
from ladiff_torch.models.vae import LAVae
from ladiff_torch.ops.cuda_common import kernel_compute
from ladiff_torch.ops.md_layer import md_layer_supported
from ladiff_torch.utils.device import resolve_device, resolve_dtype
from ladiff_torch.utils.masks import latent_valid_mask

__all__ = ["LADiffSystem"]


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
                 device=None, dtype: Optional[torch.dtype] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        D = int(latent_dim[-1])
        if md_stack and not (num_layers % 2 and md_layer_supported(
                1, max_it, 2, D, num_heads, 1024, ff_size)):
            raise ValueError(
                "md_stack: the whole-stack kernel does not take the denoiser "
                f"shape T={max_it} E=2 D={D} H={num_heads} F=1024,{ff_size} "
                f"L={num_layers}")
        want = torch.device("cuda" if device is None else device)
        if md_stack and not kernel_compute(resolve_dtype(want, dtype), want):
            raise ValueError(
                f"md_stack: the whole-stack kernel computes in bf16, not "
                f"{dtype} on {want}")
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
        self.schedule = make_schedule(num_train_timesteps)
        self.vae = LAVae(nfeats, latent_dim, ff_size, num_layers, num_heads,
                         max_it, frame_per_latent, dropout=dropout,
                         dvae=dvae, percentage_noised=percentage_noised,
                         train_whole_layer=train_whole_layer)
        self.vae.compute_dtype = dtype
        self.denoiser = LADenoiser(nfeats, latent_dim, ff_size, num_layers,
                                   num_heads, text_encoded_dim,
                                   dropout=dropout)
        self.denoiser.compute_dtype = dtype
        for name, v in (("mean", mean), ("std", std)):
            self.register_buffer(
                name, None if v is None else torch.as_tensor(
                    np.asarray(v, np.float32)), persistent=False)
        self.to(device=device, dtype=param_dtype or dtype)
        self.eval()

    @classmethod
    def from_cfg(cls, cfg, nfeats: int, njoints: int, mean=None, std=None,
                 **kw) -> "LADiffSystem":
        """The system of an assembled configuration (``ladiff_torch.config``;
        the JAX package's ``LADiffSystem.from_cfg``); ``kw`` are the
        constructor's run options (``train_whole_layer``, ``device``,
        ``dtype``, ``param_dtype``, ``md_stack``).  The port has the text
        condition, the LA-VAE, epsilon prediction and the MD-trans denoiser;
        a configuration that asks for anything else raises, naming it."""
        abl, m = cfg.TRAIN.ABLATION, cfg.model
        sched = m.get("scheduler") or {}
        layers = int(m.num_layers)
        stage = str(cfg.TRAIN.get("STAGE", "vae"))
        wanted = {
            "model.condition": (str(m.get("condition", "text")), "text"),
            "model.activation": (str(m.get("activation", "gelu")), "gelu"),
            "TRAIN.ABLATION.VAE_TYPE": (str(abl.get("VAE_TYPE", "ladiff")),
                                        "ladiff"),
            "TRAIN.ABLATION.LAD": (bool(abl.get("LAD", True)), True),
            "TRAIN.ABLATION.MLP_DIST": (bool(abl.get("MLP_DIST", False)),
                                        False),
            "TRAIN.ABLATION.TEST_EFFICIENCY": (
                bool(abl.get("TEST_EFFICIENCY", False)), False),
            "TRAIN.ABLATION.PREDICT_EPSILON": (
                bool(abl.get("PREDICT_EPSILON", True)), True),
            "ARDIFF": (bool(cfg.get("ARDIFF", False)), False),
        }
        # the stage-1 configurations name the plain denoiser, which their
        # stage never runs; the port's denoiser is the MD-trans one
        if stage != "vae":
            wanted["TRAIN.ABLATION.MD_TRANS"] = (
                bool(abl.get("MD_TRANS", False)), True)
        for key in ("motion_vae", "denoiser"):
            n = ((m.get(key) or {}).get("params") or {}).get("num_layers")
            if n is not None:
                wanted[f"model.{key}.params.num_layers"] = (int(n), layers)
        for key, (got, need) in wanted.items():
            if got != need:
                raise NotImplementedError(
                    f"{key}={got!r}: ladiff_torch runs {need!r} only")
        text_dim = ((m.get("denoiser") or {}).get("params") or {}).get(
            "text_encoded_dim", 768)
        kind = str(sched.get("kind", "") or (
            "ddpm" if "DDPM" in str(sched.get("target", "")) else "ddim"))
        return cls(
            nfeats=nfeats, njoints=njoints,
            max_frames=int(cfg.DATASET.SAMPLER.MAX_LEN),
            latent_dim=tuple(m.latent_dim), ff_size=int(m.ff_size),
            num_layers=layers, num_heads=int(m.num_head),
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
            eta=float(sched.get("eta", 0.0)), scheduler_kind=kind, **kw)

    @property
    def device(self) -> torch.device:
        return self.denoiser.query_pos.pe.device

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
        """CFG sampling of latents [B, max_it, D] (float32); with
        ``return_trajectory`` also every step's latents [steps, B, max_it,
        D]."""
        B = text_emb_cond.shape[0]
        D = self.latent_dim[-1]
        dev = self.device
        lengths = lengths.to(dev)
        lat_valid = latent_valid_mask(lengths, self.frame_per_latent,
                                      self.max_it)
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
        if text2.shape[1] == 1:
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
            elif text.shape[1] == 1:
                md_prep = [{"value": p["value"], "ca_ss": p["ca_ss"][step],
                            "ffn_ss": p["ffn_ss"][step],
                            "params": p["params"]} for p in prep_all]
            return den(latents, latent_valid=valid, time_emb=time_emb,
                       text_emb_latent=text, md_prep=md_prep)

        guided = make_cfg_denoise_fn(denoise, text_uncond, text_cond,
                                     self.guidance_scale)
        return ddim_sample(guided, self.schedule, (B, self.max_it, D), steps,
                           latent_valid=lat_valid, generator=generator,
                           init_latents=init_latents, device=dev,
                           eta=self.eta, kind=self.scheduler_kind,
                           return_trajectory=return_trajectory)

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
        shape -> (features [B, nframes, nfeats], latents [B, max_it, D])."""
        z = self.diffusion_reverse(text_emb_cond, text_emb_uncond, lengths,
                                   generator, num_inference_timesteps,
                                   init_latents)
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
        drives dropout and, unless ``eps`` [B, max_it, D] is given, the
        latent sample."""
        dev = self.device
        feats_ref = batch["motion"].to(dev)
        lengths = batch["length"].to(dev)
        with _mode(self.vae, train):
            z, mu, logvar, lat_valid = self.vae.encode(
                feats_ref, lengths, eps=eps, generator=generator)
            feats_rst = self.vae.decode(z, lengths, feats_ref.shape[1],
                                        generator=generator)
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
        given: ``eps`` [B, max_it, D] the latent sample's noise, ``cond_drop``
        [B, 1, 1] bool the captions to drop, ``noise`` [B, max_it, D],
        ``timesteps`` [B]."""
        dev = self.device
        feats_ref = batch["motion"].to(dev)
        lengths = batch["length"].to(dev)
        cond = batch["text_emb"].to(dev)
        B = feats_ref.shape[0]
        with _mode(self.vae, False), torch.no_grad():
            z, _, _, lat_valid = self.vae.encode(
                feats_ref, lengths, eps=eps, generator=generator)

        if train and self.guidance_uncondp > 0.0:
            if cond_drop is None:
                cond_drop = torch.rand(
                    (B, 1, 1), generator=generator,
                    device=dev) < self.guidance_uncondp
            cond = torch.where(cond_drop.to(dev),
                               uncond_emb.to(device=dev, dtype=cond.dtype),
                               cond)
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, device=dev)
        noise = noise.to(device=dev, dtype=z.dtype)
        if timesteps is None:
            timesteps = torch.randint(
                0, self.schedule.num_train_timesteps, (B,),
                generator=generator, device=dev)
        timesteps = timesteps.to(dev)
        noisy = self.schedule.add_noise(z, noise, timesteps)
        # inactive latent rows stay zero after noising
        noisy = torch.where(lat_valid[:, :, None], noisy,
                            torch.zeros((), dtype=noisy.dtype, device=dev))
        with _mode(self.denoiser, train):
            noise_pred = self.denoiser(noisy, timesteps, cond, lat_valid,
                                       generator=generator)
        total, logs = diffusion_loss(noise_pred, noise)
        return total, (logs, {"latent_valid": lat_valid})

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
