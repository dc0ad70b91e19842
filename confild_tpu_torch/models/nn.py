"""NN primitives for the diffusion U-Net (reference
``UnconditionalDiffusionTraining_and_Generation/src/nn.py``), channels-first.

Normalizations compute their statistics in float32 whatever the activation
dtype (the reference's ``GroupNorm32``).  The JAX package's custom VJPs for
convolutions and GroupNorm (``confild_tpu/models/nn.py:93-156,249-460``) are
TPU/XLA memory tricks and have no counterpart here: autograd differentiates
``group_norm`` and ``conv2d`` directly.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims."""
    return x.mean(dim=tuple(range(1, x.ndim)))


@torch.no_grad()
def update_ema(ema_params, new_params, rate: float = 0.9999) -> None:
    """EMA lerp in place: ``ema = rate * ema + (1 - rate) * new``
    (``src/nn.py:70-80``, ``confild_tpu/models/nn.py:472-476``)."""
    for e, p in zip(ema_params, new_params):
        e.mul_(rate).add_(p.to(e.dtype), alpha=1.0 - rate)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings, ``cos`` then ``sin`` halves as the reference
    (``src/nn.py:118-136``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with float32 statistics (``src/nn.py:17-19``); torch's eps
    default 1e-5; ``min(32, channels)`` groups as the JAX package."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__(min(num_groups, channels), channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).type(x.dtype)


def group_norm_silu(norm: GroupNorm32, x: torch.Tensor,
                    film_scale: torch.Tensor | None = None,
                    film_shift: torch.Tensor | None = None) -> torch.Tensor:
    """``silu(norm(x) * (1 + film_scale) + film_shift)``, the ResBlock chain
    of ``src/unet.py:233-241`` with the optional scale-shift modulation."""
    h = norm(x)
    if film_scale is not None:
        h = h * (1 + film_scale) + film_shift
    return F.silu(h)


def conv_nd(dims: int, *args, **kwargs) -> nn.Module:
    return {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}[dims](*args, **kwargs)


def nearest_upsample(x: torch.Tensor, dims: int) -> torch.Tensor:
    """2x nearest upsample over the inner two spatial dims for 3-D and all
    spatial dims otherwise (``src/unet.py:100-110``)."""
    if dims == 3:
        return F.interpolate(x, (x.shape[2], x.shape[3] * 2, x.shape[4] * 2),
                             mode="nearest")
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Average pool with stride == window."""
    pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[len(window)]
    return pool(x, kernel_size=tuple(window), stride=tuple(window))
