"""The U-Net family's extras (reference ``src/unet.py:666-894``;
``confild_tpu/models/unet_extras.py``), channels-first:

* :class:`SuperResModel` doubles the input channels and concatenates a
  bilinearly resized low-resolution conditioning image (``unet.py:666-681``);
* :class:`EncoderUNetModel` is the encoder torso and a pooling head, the
  classifier of classifier guidance (``unet.py:683-894``); pools
  ``adaptive`` (global average and a zero 1x1 convolution), ``attention``
  (:class:`AttentionPool2d`), ``spatial`` / ``spatial_v2`` (an MLP over the
  concatenated per-stage means).

State-dict keys are the reference's: the encoder's head is ``out``, an
``nn.Sequential`` laid out as the reference's (``out.0`` the GroupNorm,
``out.3`` the adaptive pool's convolution; ``out.2.positional_embedding``
``(C, N + 1)``, ``out.2.qkv_proj``, ``out.2.c_proj`` for the attention pool;
``out.0`` / ``out.2`` (``out.0``, ``out.1``, ``out.3`` for ``spatial_v2``)
for the MLP).  The encoder's attention blocks route as the U-Net's do
(``models/unet.py``): dense unless ``use_flash_attention``, per block
under ``flash_auto``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from confild_tpu_torch.models import nn as tnn
from confild_tpu_torch.models.unet import (TimestepEmbedSequential, UNetConfig, UNetModel,
                                          _layer, build_plan, reset_unet_parameters)


def _resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """``(in_size, out_size)`` weights of ``jax.image.resize``'s linear
    kernel along one axis (``jax/_src/image/scale.py::compute_weight_mat``,
    antialiased): a triangle of half-width ``max(in / out, 1)`` at the
    half-pixel sample positions, normalised over the taps inside the
    input."""
    inv_scale = np.float32(in_size) / np.float32(out_size)
    kernel_scale = max(float(inv_scale), 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    weights = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def bilinear_resize(x: torch.Tensor, new_hw: tuple[int, int]) -> torch.Tensor:
    """Channels-first bilinear resize of ``x`` ``(B, C, H, W)`` to ``new_hw``,
    as ``jax.image.resize(..., method="bilinear")``: upsampling equals
    ``F.interpolate(mode="bilinear", align_corners=False)``; downsampling
    antialiases (the triangle widens by the scale)."""
    wh = _resize_weights(x.shape[2], new_hw[0]).to(x.device, x.dtype)
    ww = _resize_weights(x.shape[3], new_hw[1]).to(x.device, x.dtype)
    return torch.einsum("bchw,hH,wW->bcHW", x, wh, ww)


class SuperResModel(UNetModel):
    """A U-Net conditioned on an upsampled low-resolution image:
    ``model(x, timesteps, low_res=, y=None)``."""

    def __init__(self, cfg: UNetConfig, **kwargs):
        super().__init__(dataclasses.replace(cfg, in_channels=cfg.in_channels * 2), **kwargs)

    def forward(self, x, timesteps, low_res=None, y=None):
        if low_res is None:
            raise ValueError("SuperResModel needs low_res")
        upsampled = bilinear_resize(low_res, tuple(x.shape[2:]))
        return super().forward(torch.cat([x, upsampled], dim=1), timesteps, y)


# ---------------------------------------------------------------------------
# EncoderUNetModel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EncoderPlan:
    input_blocks: tuple
    middle_block: tuple
    ch_final: int
    feature_size: int


def build_encoder_plan(cfg: UNetConfig) -> EncoderPlan:
    """The U-Net plan's input and middle blocks, with the final width and
    the ``spatial`` pools' feature size (the running sum of each stage's
    channels, reference bookkeeping)."""
    full = build_plan(cfg)
    ch = int(cfg.channel_mult[0] * cfg.model_channels)
    feature = ch
    for block in full.input_blocks[1:]:
        last = block[-1]
        ch = getattr(last, "out_ch", getattr(last, "ch", ch))
        feature += ch
    feature += ch  # middle block
    return EncoderPlan(full.input_blocks, full.middle_block, ch, feature)


class AttentionPool2d(nn.Module):
    """The CLIP-style attention pool (reference ``AttentionPool2d``,
    ``src/unet.py:22-51``): the spatial mean prepended as a token, a learned
    positional embedding ``(C, N + 1)``, one new-order QKV attention with the
    two-sided ``1/sqrt(sqrt(d))`` scale and a float32 softmax, the output
    projection, token 0."""

    def __init__(self, n_tokens: int, embed_dim: int, num_head_channels: int,
                 output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.empty(embed_dim, n_tokens + 1))
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim, 1)
        self.num_heads = embed_dim // num_head_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        x = x.reshape(b, c, -1)
        x = torch.cat([x.mean(dim=-1, keepdim=True), x], dim=-1)
        x = x + self.positional_embedding[None].to(x.dtype)
        n = x.shape[-1]
        heads = self.num_heads
        d = c // heads
        q, k, v = (t.reshape(b * heads, d, n) for t in self.qkv_proj(x).chunk(3, dim=1))
        scale = 1.0 / math.sqrt(math.sqrt(d))
        up = torch.promote_types(q.dtype, torch.float32)    # float32 logits, or float64
        logits = torch.einsum("bct,bcs->bts", q.to(up) * scale, k.to(up) * scale)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bts,bcs->bct", weights, v).reshape(b, c, n)
        return self.c_proj(out)[:, :, 0]


class EncoderUNetModel(nn.Module):
    """``model(x, timesteps)`` -> ``(B, out_channels)`` logits: the U-Net's
    input and middle blocks, then the ``pool`` head."""

    def __init__(self, cfg: UNetConfig, pool: str = "adaptive",
                 encoder_out_channels: int | None = None):
        super().__init__()
        self.cfg, self.pool = cfg, pool
        self.plan = plan = build_encoder_plan(cfg)
        self.out_channels = (encoder_out_channels if encoder_out_channels is not None
                             else cfg.out_channels)
        mc, emb_ch = cfg.model_channels, cfg.emb_ch
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        self.input_blocks = nn.ModuleList(
            TimestepEmbedSequential(*map(_layer, block)) for block in plan.input_blocks)
        self.middle_block = TimestepEmbedSequential(*map(_layer, plan.middle_block))
        ch, dims = plan.ch_final, cfg.dims
        if pool == "adaptive":
            self.out = nn.Sequential(
                tnn.GroupNorm32(ch), nn.SiLU(),
                {1: nn.AdaptiveAvgPool1d, 2: nn.AdaptiveAvgPool2d,
                 3: nn.AdaptiveAvgPool3d}[dims]((1,) * dims),
                tnn.conv_nd(dims, ch, self.out_channels, 1), nn.Flatten())
            zeroed = [self.out[3]]
        elif pool == "attention":
            if cfg.num_head_channels == -1:
                raise ValueError("the attention pool needs num_head_channels")
            ds = 2 ** (len(cfg.channel_mult) - 1)
            # a 3-D torso downsamples the last two axes only (DownSpec's
            # (1, 2, 2) windows): the depth axis keeps its extent
            if dims == 3:
                n_tokens = cfg.image_size * (cfg.image_size // ds) ** 2
            else:
                n_tokens = (cfg.image_size // ds) ** dims
            self.out = nn.Sequential(
                tnn.GroupNorm32(ch), nn.SiLU(),
                AttentionPool2d(n_tokens, ch, cfg.num_head_channels, self.out_channels))
            zeroed = []
        elif pool == "spatial":
            self.out = nn.Sequential(nn.Linear(plan.feature_size, 2048), nn.ReLU(),
                                     nn.Linear(2048, self.out_channels))
            zeroed = []
        elif pool == "spatial_v2":
            self.out = nn.Sequential(nn.Linear(plan.feature_size, 2048),
                                     tnn.GroupNorm32(2048), nn.SiLU(),
                                     nn.Linear(2048, self.out_channels))
            zeroed = []
        else:
            raise NotImplementedError(f"Unexpected {pool} pooling")
        self._zeroed = zeroed

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> "EncoderUNetModel":
        """The JAX ``init``'s distributions from ``generator``: torch's
        default ``±1/sqrt(fan_in)`` uniform, unit GroupNorms, the zero
        layers zeroed (each ResBlock's output convolution, each attention
        projection, the adaptive pool's convolution), the attention pool's
        positional embedding normal over ``sqrt(C)``."""
        reset_unet_parameters(self, self._zeroed, generator)
        if self.pool == "attention":
            pe = self.out[2].positional_embedding
            pe.copy_(torch.randn(pe.shape, generator=generator) / pe.shape[0] ** 0.5)
        return self

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, *,
                channels_first: bool = True) -> torch.Tensor:
        """``x`` ``(B, C, *spatial)`` when ``channels_first`` (the reference
        contract) else ``(B, *spatial, C)``."""
        cfg = self.cfg
        if not channels_first:
            x = torch.movedim(x, -1, 1)
        emb = self.time_embed(tnn.timestep_embedding(timesteps, cfg.model_channels).to(
            self.time_embed[0].weight.dtype))
        spatial = tuple(range(2, x.ndim))
        results = []
        h = x.to(cfg.torso_dtype)
        for block in self.input_blocks:
            h = block(h, emb)
            if self.pool.startswith("spatial"):
                results.append(h.to(x.dtype).mean(dim=spatial))
        h = self.middle_block(h, emb)
        if self.pool.startswith("spatial"):
            results.append(h.to(x.dtype).mean(dim=spatial))
            return self.out(torch.cat(results, dim=-1))
        return self.out(h.to(x.dtype))


def create_classifier(
    image_size: int,
    classifier_width: int = 128,
    classifier_depth: int = 2,
    classifier_attention_resolutions: str = "32,16,8",
    classifier_use_scale_shift_norm: bool = True,
    classifier_resblock_updown: bool = True,
    classifier_pool: str = "attention",
    in_channels: int = 1,
    out_channels: int = 1000,
    dims: int = 2,
) -> EncoderUNetModel:
    """The classifier of upstream guided-diffusion's ``create_classifier``
    (``script_util.py:189-251``) with its defaults, the 256x256 published
    classifier's flags; dense attention, as ``UNetConfig``'s default."""
    channel_mult = {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
                    128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}.get(image_size, (1, 2))
    attention_ds = tuple(image_size // int(r)
                         for r in classifier_attention_resolutions.split(","))
    cfg = UNetConfig(
        image_size=image_size, in_channels=in_channels, model_channels=classifier_width,
        out_channels=out_channels, num_res_blocks=classifier_depth,
        attention_resolutions=attention_ds, channel_mult=channel_mult, dims=dims,
        num_head_channels=64, use_scale_shift_norm=classifier_use_scale_shift_norm,
        resblock_updown=classifier_resblock_updown)
    return EncoderUNetModel(cfg, pool=classifier_pool, encoder_out_channels=out_channels)


def create_sr_model(
    large_size: int,
    small_size: int,
    num_channels: int,
    num_res_blocks: int,
    out_channels: int = 1,
    learn_sigma: bool = False,
    attention_resolutions: str = "16",
    num_heads: int = 1,
    num_head_channels: int = -1,
    use_scale_shift_norm: bool = False,
    dropout: float = 0.0,
    dims: int = 2,
) -> SuperResModel:
    """The super-resolution model (reference ``script_util.py:253-321``
    ``sr_create_model``)."""
    if large_size in (512, 256):
        channel_mult = (1, 1, 2, 2, 4, 4)
    elif large_size == 64:
        channel_mult = (1, 2, 3, 4)
    else:
        channel_mult = (1, 2, 4)
    attention_ds = tuple(large_size // int(r) for r in attention_resolutions.split(","))
    cfg = UNetConfig(
        image_size=large_size, in_channels=out_channels, model_channels=num_channels,
        out_channels=out_channels if not learn_sigma else 2 * out_channels,
        num_res_blocks=num_res_blocks, attention_resolutions=attention_ds,
        channel_mult=channel_mult, dims=dims, num_heads=num_heads,
        num_head_channels=num_head_channels, use_scale_shift_norm=use_scale_shift_norm,
        dropout=dropout)
    return SuperResModel(cfg)
