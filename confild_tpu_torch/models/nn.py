"""NN primitives for the diffusion U-Net (reference
``UnconditionalDiffusionTraining_and_Generation/src/nn.py``), channels-first.

Normalizations compute their statistics in float32 whatever the activation
dtype (the reference's ``GroupNorm32``).  Convolutions cast their weight and
bias to the activation dtype at use (``confild_tpu/models/nn.py:63-64,
159-177``), so a bf16 torso trains on float32 parameters with float32
gradients.  The JAX package's shifted-matmul convolution backward
(``confild_tpu/models/nn.py:93-156``) is a TPU/XLA trick with no
counterpart here.  Its fused GroupNorm(+FiLM)(+SiLU) custom VJP (``:249-460``)
is repeated only off float32 (:class:`_GroupNormLowp`), for where it rounds;
a float32 input takes torch's ``group_norm`` and autograd.
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


# activation dtypes whose GroupNorm is torch's own (statistics in that dtype)
_FULL_PRECISION = (torch.float32, torch.float64)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with float32 statistics (``src/nn.py:17-19``), the output
    in the activation dtype; torch's eps default 1e-5; ``min(32,
    channels)`` groups as the JAX package.  A float32 input (or a float64
    one, a reference run) takes torch's ``group_norm``; any other (the bf16
    torso) :class:`_GroupNormLowp`."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__(min(num_groups, channels), channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in _FULL_PRECISION:
            return super().forward(x)
        return _GroupNormLowp.apply(x, self.weight, self.bias, None, None, self.num_groups,
                                    self.eps, False)


def _expand(v, c):
    """(B, G) group values -> (B, C) channel values."""
    return v.repeat_interleave(c // v.shape[1], dim=1)


def _bc(v, x):
    """A (B, C) float32 array as ``x``'s dtype, broadcast over its spatial
    dims."""
    return v.reshape(*v.shape, *(1,) * (x.ndim - 2)).to(x.dtype)


def _sigmoid(z):
    """JAX's ``sigmoid`` off float32: ``1 / (1 + exp(-z))``, each step
    rounded to ``z``'s dtype."""
    return 1 / (1 + torch.exp(-z))


class _GroupNormLowp(torch.autograd.Function):
    """``silu?(norm(x) * (1 + film_scale) + film_shift)`` on activations in
    a low-precision dtype, rounded where the JAX package's custom VJPs round
    (``confild_tpu/models/nn.py:201-441``): the float32 group statistics
    fold with the affine and the FiLM terms into per-(batch, channel)
    float32 coefficients, cast to the activation dtype for one pass
    ``x * a + b`` in that dtype; the backward reduces in float32 and forms
    ``dx = dz * p + x * q + r`` in the activation dtype."""

    @staticmethod
    def _coefficients(weight, bias, s, t, mean, inv, c):
        gam = weight.float()[None] * (1 + s)
        bet = bias.float()[None] * (1 + s) + t
        return gam, _expand(inv, c) * gam, bet - _expand(mean * inv, c) * gam

    @staticmethod
    def forward(ctx, x, weight, bias, film_scale, film_shift, groups, eps, with_silu):
        b, c = x.shape[:2]
        var, mean = torch.var_mean(x.float().reshape(b, groups, -1), dim=-1, correction=0)
        inv = torch.rsqrt(var + eps)
        zero = x.new_zeros((b, c), dtype=torch.float32)
        s = zero if film_scale is None else film_scale.float().reshape(b, c)
        t = zero if film_shift is None else film_shift.float().reshape(b, c)
        _, a, b2 = _GroupNormLowp._coefficients(weight, bias, s, t, mean, inv, c)
        ctx.save_for_backward(x, weight, bias, s, t, mean, inv)
        ctx.with_silu = with_silu
        ctx.film = None if film_scale is None else [(f.shape, f.dtype)
                                                    for f in (film_scale, film_shift)]
        z = x * _bc(a, x) + _bc(b2, x)
        return z * _sigmoid(z) if with_silu else z

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, s, t, mean, inv = ctx.saved_tensors
        b, c = x.shape[:2]
        groups = mean.shape[1]
        n = x[0, 0].numel() * (c // groups)
        gam, a, b2 = _GroupNormLowp._coefficients(weight, bias, s, t, mean, inv, c)
        dz = dy.to(x.dtype)
        if ctx.with_silu:
            z = x * _bc(a, x) + _bc(b2, x)
            sig = _sigmoid(z)
            dz = dz * (sig * (1 + z * (1 - sig)))
        red = tuple(range(2, x.ndim))
        dzf = dz.float()
        r1 = dzf.sum(dim=red)                                   # (B, C)
        r2 = (dzf * x.float()).sum(dim=red)
        t1 = (gam * r1).reshape(b, groups, -1).sum(-1)          # (B, G)
        t2 = (gam * (r2 - _expand(mean, c) * r1)).reshape(b, groups, -1).sum(-1)
        m1, m2 = t1 / n, inv * t2 / n
        p = _expand(inv, c) * gam
        q = _expand(-inv * inv * m2, c)
        r = _expand(inv * inv * mean * m2 - inv * m1, c)
        dx = dz * _bc(p, x) + x * _bc(q, x) + _bc(r, x)
        xhat_sum = _expand(inv, c) * (r2 - _expand(mean, c) * r1)
        dweight = ((1 + s) * xhat_sum).sum(0)
        dbias = ((1 + s) * r1).sum(0)
        ds = dt = None
        if ctx.film is not None:
            (s_shape, s_dtype), (t_shape, t_dtype) = ctx.film
            ds = (weight.float()[None] * xhat_sum + bias.float()[None] * r1)
            ds, dt = ds.reshape(s_shape).to(s_dtype), r1.reshape(t_shape).to(t_dtype)
        return dx, dweight, dbias, ds, dt, None, None, None


def group_norm_silu(norm: GroupNorm32, x: torch.Tensor,
                    film_scale: torch.Tensor | None = None,
                    film_shift: torch.Tensor | None = None) -> torch.Tensor:
    """``silu(norm(x) * (1 + film_scale) + film_shift)``, the ResBlock chain
    of ``src/unet.py:233-241`` with the optional scale-shift modulation
    (below float32 one :class:`_GroupNormLowp`)."""
    if x.dtype not in _FULL_PRECISION:
        return _GroupNormLowp.apply(x, norm.weight, norm.bias, film_scale, film_shift,
                                    norm.num_groups, norm.eps, True)
    h = norm(x)
    if film_scale is not None:
        h = h * (1 + film_scale) + film_shift
    return F.silu(h)


class _CastConv:
    """A convolution whose weight and bias are cast to the input's dtype at
    use (a no-op when they are that dtype already); off float32 the bias is
    added to the rounded product, as in JAX (``nn.py:177``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight.to(x.dtype)
        if x.dtype == torch.float32 or self.bias is None:
            return self._conv_forward(x, weight, self.bias)
        bias = self.bias.to(x.dtype).reshape(-1, *(1,) * (x.ndim - 2))
        return self._conv_forward(x, weight, None) + bias


class Conv1d(_CastConv, nn.Conv1d):
    pass


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv3d(_CastConv, nn.Conv3d):
    pass


def conv_nd(dims: int, *args, **kwargs) -> nn.Module:
    return {1: Conv1d, 2: Conv2d, 3: Conv3d}[dims](*args, **kwargs)


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
