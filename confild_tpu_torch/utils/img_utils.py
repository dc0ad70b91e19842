"""Inpainting masks, dynamic thresholding and a bicubic resize, the port of
``confild_tpu/utils/img_utils.py`` (reference ``ConditionalDiffusionGeneration/
src/util/img_utils.py``).

Masks are built on the host with numpy from an explicit
``numpy.random.Generator`` (``mask_generator`` seeds one from ``seed``), so
that the same seed gives the JAX package's masks, and are returned as float32
tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize(img: torch.Tensor, s: float = 0.95) -> torch.Tensor:
    scaling = torch.quantile(img.abs().flatten(), s)
    return img * scaling


def dynamic_thresholding(img: torch.Tensor, s: float = 0.95) -> torch.Tensor:
    return normalize(img, s).clamp(-1.0, 1.0)


def random_sq_bbox(shape, mask_shape, image_size: int = 256, margin=(16, 16),
                   rng: np.random.Generator | None = None):
    """Random square inpainting mask (``img_utils.py:17-34``).  ``shape``:
    (B, C, H, W); ``rng`` is required."""
    if rng is None:
        raise ValueError("random_sq_bbox draws from an explicit numpy Generator: pass rng")
    h, w = mask_shape
    margin_height, margin_width = margin
    maxt = image_size - margin_height - h
    maxl = image_size - margin_width - w
    t = int(rng.integers(margin_height, maxt))
    l = int(rng.integers(margin_width, maxl))
    mask = np.ones(shape, np.float32)
    mask[..., t:t + h, l:l + w] = 0
    return torch.from_numpy(mask), t, t + h, l, l + w


class mask_generator:
    """box / random / extreme / std_box inpainting masks
    (``img_utils.py:36-102``), drawn from ``numpy.random.default_rng(seed)``."""

    def __init__(self, mask_type: str, mask_len_range=None, mask_prob_range=None,
                 image_size: int = 256, margin=(16, 16), std_box_hstart: int = 0,
                 std_box_wstart: int = 0, h: int = 1, w: int = 1, seed=None):
        if mask_type not in ("box", "random", "both", "extreme", "std_box"):
            raise ValueError(f"unknown mask type {mask_type!r}")
        self.mask_type = mask_type
        self.mask_len_range = mask_len_range
        self.mask_prob_range = mask_prob_range
        self.image_size = image_size
        self.margin = margin
        self.std_box = (std_box_hstart, std_box_wstart, h, w)
        self.rng = np.random.default_rng(seed)

    def _retrieve_std_box(self, shape):
        t, l, h, w = self.std_box
        mask = np.ones(shape, np.float32)
        mask[..., t:t + h, l:l + w] = 0
        return torch.from_numpy(mask)

    def _retrieve_box(self, shape):
        lo, hi = map(int, self.mask_len_range)
        mask_h = int(self.rng.integers(lo, hi))
        mask_w = int(self.rng.integers(lo, hi))
        return random_sq_bbox(shape, (mask_h, mask_w), self.image_size, self.margin, self.rng)

    def _retrieve_random(self, shape):
        total = self.image_size ** 2
        lo, hi = self.mask_prob_range
        prob = float(self.rng.uniform(lo, hi))
        mask_vec = np.ones(total, np.float32)
        samples = self.rng.choice(total, int(total * prob), replace=False)
        mask_vec[samples] = 0
        mask_b = mask_vec.reshape(self.image_size, self.image_size)
        return torch.from_numpy(np.broadcast_to(mask_b, shape).copy())

    def __call__(self, img_or_shape):
        shape = (img_or_shape if isinstance(img_or_shape, tuple)
                 else tuple(img_or_shape.shape))
        if self.mask_type == "random":
            return self._retrieve_random(shape)
        if self.mask_type == "box":
            return self._retrieve_box(shape)[0]
        if self.mask_type == "extreme":
            return 1.0 - self._retrieve_box(shape)[0]
        if self.mask_type == "std_box":
            return self._retrieve_std_box(shape)
        raise NotImplementedError(self.mask_type)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel (a = -0.5) of ``|x|``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """``(in, out)`` weights of ``jax.image.resize(method="cubic")``: the
    kernel stretched by the inverse scale when downsampling (antialias),
    each column normalized to sum to 1, columns that sample outside the
    input zeroed."""
    inv_scale = in_size / out_size
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size)[:, None]) / max(inv_scale, 1.0)
    weights = _keys_cubic(x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0.0)


def bicubic_resize(img: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Differentiable resize of channels-first ``(B, C, H, W)``: the JAX
    package's ``jax.image.resize(..., method="cubic")`` (Keys cubic,
    antialiased when downsampling), as two separable weighted sums."""
    b, c, h, w = img.shape
    new_h, new_w = int(h * scale_factor), int(w * scale_factor)
    if new_h != h:
        wh = torch.as_tensor(_cubic_weights(h, new_h), dtype=img.dtype, device=img.device)
        img = torch.einsum("bchw,hH->bcHw", img, wh)
    if new_w != w:
        ww = torch.as_tensor(_cubic_weights(w, new_w), dtype=img.dtype, device=img.device)
        img = torch.einsum("bchw,wW->bchW", img, ww)
    return img
