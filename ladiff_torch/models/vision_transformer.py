"""MAED-style spatio-temporal Vision Transformer (counterpart of
``ladiff_tpu/models/vision_transformer.py``).

Patch (or hybrid CNN) embedding of NCHW images, a cls token, learned
position (and, in the coupling / parallel / series modes, temporal)
embeddings, pre-norm blocks with stochastic depth, the optional pre-logits
layer and the classifier head.  A clip of ``seqlen`` frames is stacked in
the batch axis: ``x`` is [clips * seqlen, C, H, W], and ``seqlen`` is a
Python int.  The five MAED attention modes: ``vanilla`` (per-frame spatial),
``temporal`` (spatially pooled, over frames; its [B, 1, C] output
broadcasts into the residual), ``coupling`` (joint over all T * N
space-time tokens), ``parallel`` (spatial and temporal mixed by a learned
per-channel softmax gate) and ``series`` (spatial, then temporal on a
second pass of the same ``qkv``).

Parameter names are timm's (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``temp_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,
attn.ts_attn,norm2,mlp.fc1,mlp.fc2}``, ``norm``, ``pre_logits.fc``,
``head``), so a timm / MAED state dict loads as it is (a flattened patchify
weight reshaped to OIHW first, as the reference's ``_conv_filter`` does).
Dropout and ``DropPath`` draw from the ``generator`` passed to ``forward``,
in training mode.  Plain PyTorch on every device: the JAX package runs its
attention in XLA, not in a kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.transformer import _drop
from ladiff_torch.utils.device import resolve_device

__all__ = [
    "DropPath", "Mlp", "Attention", "Block", "PatchEmbed", "HybridEmbed",
    "VisionTransformer", "vit_small_patch16_224", "vit_base_patch16_224",
    "vit_base_patch16_384", "vit_base_patch32_384", "vit_large_patch16_224",
    "vit_large_patch16_384", "vit_large_patch32_384", "vit_huge_patch16_224",
    "vit_huge_patch32_384",
]

ST_MODES = ("vanilla", "temporal", "coupling", "parallel", "series")
# the modes that add a learned temporal embedding over the frame axis
TEMP_EMBED_MODES = ("coupling", "parallel", "series")


class DropPath(nn.Module):
    """Stochastic depth: in training mode each sample's whole branch is
    zeroed with probability ``rate`` (a uniform draw at least 1 - rate)
    and the rest scaled by 1 / (1 - rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                       generator=generator, device=x.device)
        return torch.where(u < keep, x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, drop: float = 0.0):
        super().__init__()
        self.drop = drop
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        rate = self.drop if self.training else 0.0
        x = _drop(F.gelu(self.fc1(x)), rate, generator)
        return _drop(self.fc2(x), rate, generator)


class Attention(nn.Module):
    """The five MAED attention modes over ``[B, N, C]``, ``B`` = clips x
    ``seqlen`` frames of ``N`` spatial tokens."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, st_mode: str = "vanilla"):
        super().__init__()
        if st_mode not in ST_MODES:
            raise NotImplementedError(st_mode)
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.st_mode = st_mode
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if st_mode == "parallel":
            self.ts_attn = nn.Linear(dim * 2, dim * 2)

    def _qkv(self, x: torch.Tensor):
        """[B, N, C] -> q, k, v [B, H, N, c]."""
        B, N, C = x.shape
        H = self.num_heads
        return tuple(t.reshape(B, N, H, C // H).transpose(1, 2)
                     for t in self.qkv(x).chunk(3, dim=-1))

    def _attend(self, q, k, v, generator):
        probs = torch.softmax(q @ k.transpose(-1, -2) * self.scale, dim=-1)
        probs = _drop(probs, self.attn_drop if self.training else 0.0,
                      generator)
        return probs @ v

    def _spatial(self, q, k, v, generator):
        """Each frame's attention over its N tokens."""
        out = self._attend(q, k, v, generator)  # [B, H, N, c]
        B, H, N, c = out.shape
        return out.transpose(1, 2).reshape(B, N, H * c)

    def _temporal(self, q, k, v, seqlen: int, generator):
        """Attention over the frame axis at each spatial location."""
        B, H, N, c = q.shape

        def to_t(x):  # [b, H, N, T, c]
            return x.reshape(-1, seqlen, H, N, c).permute(0, 2, 3, 1, 4)

        out = self._attend(to_t(q), to_t(k), to_t(v), generator)
        return out.permute(0, 3, 2, 1, 4).reshape(B, N, H * c)

    def _coupling(self, q, k, v, seqlen: int, generator):
        """Joint attention over all T * N space-time tokens."""
        B, H, N, c = q.shape

        def to_tn(x):  # [b, H, T * N, c]
            x = x.reshape(-1, seqlen, H, N, c).permute(0, 2, 1, 3, 4)
            return x.reshape(-1, H, seqlen * N, c)

        out = self._attend(to_tn(q), to_tn(k), to_tn(v), generator)
        out = out.reshape(-1, H, seqlen, N, c).permute(0, 2, 3, 1, 4)
        return out.reshape(B, N, H * c)

    def forward(self, x: torch.Tensor, seqlen: int = 1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, N, C = x.shape
        if self.st_mode == "series":
            x = self._spatial(*self._qkv(x), generator)
            x = self._temporal(*self._qkv(x), seqlen, generator)
        elif self.st_mode == "parallel":
            q, k, v = self._qkv(x)
            x_t = self._temporal(q, k, v, seqlen, generator)
            x_s = self._spatial(q, k, v, generator)
            alpha = torch.cat([x_s, x_t], dim=-1).mean(dim=1, keepdim=True)
            alpha = torch.softmax(self.ts_attn(alpha).reshape(B, 1, C, 2),
                                  dim=-1)
            x = x_t * alpha[..., 1] + x_s * alpha[..., 0]
        elif self.st_mode == "coupling":
            x = self._coupling(*self._qkv(x), seqlen, generator)
        elif self.st_mode == "vanilla":
            x = self._spatial(*self._qkv(x), generator)
        else:  # temporal: pool space, then attend over frames -> [B, 1, C]
            x = self._temporal(*self._qkv(x.mean(dim=1, keepdim=True)),
                               seqlen, generator)
        return _drop(self.proj(x), self.proj_drop if self.training else 0.0,
                     generator)


class Block(nn.Module):
    """Pre-norm block with stochastic depth."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, norm_eps: float = 1e-5,
                 st_mode: str = "vanilla"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, attn_drop,
                              drop, st_mode)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop)

    def forward(self, x: torch.Tensor, seqlen: int = 1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x), seqlen, generator),
                               generator)
        return x + self.drop_path(self.mlp(self.norm2(x), generator),
                                  generator)


class PatchEmbed(nn.Module):
    """NCHW images -> patch tokens [B, N, embed_dim] by a stride-``patch``
    conv."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, embed_dim: int = 768):
        super().__init__()
        self.img_size = img_size
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        if H != self.img_size or W != self.img_size:
            raise ValueError(
                f"Input image size ({H}*{W}) doesn't match model "
                f"({self.img_size}*{self.img_size}).")
        return self.proj(x).flatten(2).transpose(1, 2)


class HybridEmbed(nn.Module):
    """A CNN backbone's last NCHW feature map (of ``feature_dim`` channels,
    ``feature_size`` spatially; a list or tuple of maps: the last),
    1x1-projected to the embedding width."""

    def __init__(self, backbone: nn.Module, feature_size: Sequence[int],
                 feature_dim: int, embed_dim: int = 768):
        super().__init__()
        self.backbone = backbone
        self.num_patches = int(feature_size[0]) * int(feature_size[1])
        self.proj = nn.Conv2d(feature_dim, embed_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.backbone(x)
        if isinstance(x, (list, tuple)):
            x = x[-1]
        return self.proj(x).flatten(2).transpose(1, 2)


class _PreLogits(nn.Module):
    def __init__(self, dim: int, size: int):
        super().__init__()
        self.fc = nn.Linear(dim, size)

    def forward(self, x):
        return torch.tanh(self.fc(x))


class VisionTransformer(nn.Module):
    """NCHW images [clips * seqlen, in_chans, H, W] -> logits [clips *
    seqlen, num_classes] (the pooled feature where ``num_classes`` is 0).
    A hybrid input stage takes ``hybrid_backbone`` with its
    ``hybrid_feature_size`` and ``hybrid_feature_dim``."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None,
                 representation_size: Optional[int] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, norm_eps: float = 1e-5,
                 st_mode: str = "vanilla", max_seqlen: int = 16,
                 hybrid_backbone: Optional[nn.Module] = None,
                 hybrid_feature_size: Optional[Sequence[int]] = None,
                 hybrid_feature_dim: Optional[int] = None, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.st_mode = st_mode
        self.drop_rate = drop_rate
        self.num_classes = num_classes
        if hybrid_backbone is not None:
            self.patch_embed = HybridEmbed(hybrid_backbone,
                                           hybrid_feature_size,
                                           hybrid_feature_dim, embed_dim)
        else:
            self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                          embed_dim)
        n = self.patch_embed.num_patches
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        for p in (self.cls_token, self.pos_embed):
            nn.init.trunc_normal_(p, std=0.02)
        if st_mode in TEMP_EMBED_MODES:
            self.temp_embed = nn.Parameter(
                nn.init.trunc_normal_(torch.zeros(1, max_seqlen, 1,
                                                  embed_dim), std=0.02))
        # stochastic depth grows linearly over the blocks
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale,
                  drop_rate, attn_drop_rate, float(dpr[i]), norm_eps,
                  st_mode) for i in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=norm_eps)
        self.pre_logits = (_PreLogits(embed_dim, representation_size)
                           if representation_size else None)
        self.head = (nn.Linear(representation_size or embed_dim, num_classes)
                     if num_classes > 0 else None)
        self.to(resolve_device(device))

    def forward_features(self, x: torch.Tensor, seqlen: int = 1,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        """Images -> the pooled (cls-token) feature [B, F]."""
        x = self.patch_embed(x.to(self.pos_embed.dtype))
        B, _, C = x.shape
        x = torch.cat([self.cls_token.expand(B, 1, C), x], dim=1)
        x = x + self.pos_embed
        if self.st_mode in TEMP_EMBED_MODES:
            N = x.shape[1]
            x = (x.reshape(-1, seqlen, N, C)
                 + self.temp_embed[:, :seqlen]).reshape(B, N, C)
        x = _drop(x, self.drop_rate if self.training else 0.0, generator)
        for blk in self.blocks:
            x = blk(x, seqlen, generator)
        x = self.norm(x)[:, 0]
        return self.pre_logits(x) if self.pre_logits is not None else x

    def forward(self, x: torch.Tensor, seqlen: int = 1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.forward_features(x, seqlen, generator)
        return self.head(x) if self.head is not None else x


def _variant(**defaults):
    def factory(**kwargs) -> VisionTransformer:
        return VisionTransformer(**{**defaults, **kwargs})
    return factory


# the pure-ViT factories of the reference; a timm state dict loads into
# them as it is (vit_small's pretrained weights want qk_scale=768 ** -0.5,
# as the reference notes)
vit_small_patch16_224 = _variant(patch_size=16, embed_dim=768, depth=8,
                                 num_heads=8, mlp_ratio=3.0)
vit_base_patch16_224 = _variant(patch_size=16, embed_dim=768, depth=12,
                                num_heads=12, mlp_ratio=4.0, qkv_bias=True,
                                norm_eps=1e-6)
vit_base_patch16_384 = _variant(img_size=384, patch_size=16, embed_dim=768,
                                depth=12, num_heads=12, mlp_ratio=4.0,
                                qkv_bias=True, norm_eps=1e-6)
vit_base_patch32_384 = _variant(img_size=384, patch_size=32, embed_dim=768,
                                depth=12, num_heads=12, mlp_ratio=4.0,
                                qkv_bias=True, norm_eps=1e-6)
vit_large_patch16_224 = _variant(patch_size=16, embed_dim=1024, depth=24,
                                 num_heads=16, mlp_ratio=4.0, qkv_bias=True,
                                 norm_eps=1e-6)
vit_large_patch16_384 = _variant(img_size=384, patch_size=16, embed_dim=1024,
                                 depth=24, num_heads=16, mlp_ratio=4.0,
                                 qkv_bias=True, norm_eps=1e-6)
vit_large_patch32_384 = _variant(img_size=384, patch_size=32, embed_dim=1024,
                                 depth=24, num_heads=16, mlp_ratio=4.0,
                                 qkv_bias=True, norm_eps=1e-6)
vit_huge_patch16_224 = _variant(patch_size=16, embed_dim=1280, depth=32,
                                num_heads=16, mlp_ratio=4.0)
vit_huge_patch32_384 = _variant(img_size=384, patch_size=32, embed_dim=1280,
                                depth=32, num_heads=16, mlp_ratio=4.0)
