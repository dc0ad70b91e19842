"""Measurement operators A for guided generation: y = A(x) (+ noise)
(reference ``ConditionalDiffusionGeneration/src/guided_diffusion/
measurements.py``).

The reference's ``case2/case3/case4`` operators are one parameterized
``CNFDecodeOperator`` (they differ only in SIREN size, normalizer source and
mesh; ``measurements.py:58-226``), built through the same registry names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from confild_tpu_torch.core import normalize as norm
from confild_tpu_torch.core.packing import unit_interval_to_minmax
from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.io import convert
from confild_tpu_torch.models.cnf import SirenFilm
from confild_tpu_torch.ops.siren_decode import (fused_siren_decode_frozen,
                                                siren_decode)

__OPERATOR__: dict[str, Callable[..., Any]] = {}

# rows x points above which the DPS decode takes the fused kernels
# (forward + dz) instead of the plain autograd decode.  Chosen on a TPU
# (confild_tpu/guidance/operators.py:124-133) and kept for parity.  On an
# H100 (chip_smoke.py phase 4 [crossover], 384 rows, 10 to 2048 sensors)
# forward + dz took 0.60-0.93 of the plain path's time at every size in
# three runs, and above 65536 pairs their peak memory stays at 1.6 GiB while
# the plain path's grows with the pairs (10.7 GiB at 393216, 21.4 at
# 786432); so every size that this rule routes to the kernels is faster
# there, and the sizes below it would be too (PERF.md §6).
FUSED_MIN_PAIRS = 65536


def register_operator(name: str):
    def wrapper(cls):
        if name in __OPERATOR__:
            raise NameError(f"Name {name} is already registered!")
        __OPERATOR__[name] = cls
        return cls
    return wrapper


def get_operator(name: str, **kwargs):
    if name not in __OPERATOR__:
        raise NameError(f"Name {name} is not defined.")
    # notebook-style *_path kwargs load from disk (reference notebook cell 13)
    for key in ("coords", "max_val", "min_val"):
        pkey = f"{key}_path"
        if pkey in kwargs:
            kwargs[key] = np.load(kwargs.pop(pkey))
    return __OPERATOR__[name](**kwargs)


@register_operator(name="inpainting")
@dataclasses.dataclass
class InpaintingOperator:
    """Mask multiply (reference ``measurements.py:40-56``)."""

    mask: Any = None

    def forward(self, data, mask=None, **kwargs):
        m = mask if mask is not None else self.mask
        if m is None:
            raise ValueError("Require mask")
        return data * m

    def transpose(self, data, **kwargs):
        return data

    def ortho_project(self, data, **kwargs):
        return data - self.forward(data, **kwargs)

    def project(self, data, measurement, **kwargs):
        """Observed entries from the measurement, the rest from the sample."""
        return self.ortho_project(data, **kwargs) + self.forward(measurement, **kwargs)


@dataclasses.dataclass
class CNFDecodeOperator:
    """Latent image -> sensor fields through the frozen CNF decoder.

    forward(data):
      1. ``_unnorm``: diffusion [-1, 1] -> latent range via (max_val, min_val)
         (reference ``measurements.py:88-89``),
      2. flatten ``(s, c, t, l) -> (s*c*t, l)`` latent rows,
      3. decode at ``coords`` with the CNF x/y normalizers,
      4. apply the sensor ``mask``.
    """

    model: SirenFilm                   # frozen decoder, on ``device``
    coords: Any                        # (M, dims) physical query points
    x_normalizer: norm.Normalizer
    y_normalizer: norm.Normalizer
    max_val: Any                       # latent-range scalers
    min_val: Any
    mask: Any = None                   # sensor mask, broadcastable to fields
    w0: float = 30.0
    # None = by workload size (see decode_latents); a bool forces a path
    use_pallas: bool | None = None
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device).requires_grad_(False)
        self.x_normalizer = self.x_normalizer.to(self.device)
        self.y_normalizer = self.y_normalizer.to(self.device)
        self.norm_coords = self.x_normalizer.normalize(
            torch.as_tensor(np.asarray(self.coords), dtype=torch.float32,
                            device=self.device)).contiguous()
        self._max = torch.as_tensor(np.asarray(self.max_val), dtype=torch.float32,
                                    device=self.device)
        self._min = torch.as_tensor(np.asarray(self.min_val), dtype=torch.float32,
                                    device=self.device)

    def _unnorm(self, data):
        return unit_interval_to_minmax(data, self._max, self._min)

    def fused_route(self, rows: int) -> bool:
        """Whether a decode of ``rows`` latent rows takes the kernels: by
        ``use_pallas``, else when ``rows x points > FUSED_MIN_PAIRS`` (the
        rows of the batch this operator sees: a rank's shard of an ensemble
        may take the plain route where the whole ensemble takes the
        kernels)."""
        if self.use_pallas is not None:
            return self.use_pallas
        return rows * self.norm_coords.shape[0] > FUSED_MIN_PAIRS

    def decode_latents(self, latents):
        """(T, L) latent rows -> (T, M, C_out) physical fields.

        With ``rows x points > FUSED_MIN_PAIRS`` (or ``use_pallas=True``) the
        decode is the frozen fused op, whose backward is the dz kernel;
        otherwise the plain ``torch.sin`` layer loop under autograd."""
        if self.fused_route(latents.shape[0]):
            fields = fused_siren_decode_frozen(self.model, self.norm_coords, latents, self.w0)
        else:
            fields = siren_decode(self.model, self.norm_coords, latents, self.w0,
                                  use_pallas=False)
        return self.y_normalizer.denormalize(fields)

    def forward(self, data, mask=None, **kwargs):
        """data: (S, 1, T, L) latent image in [-1, 1] -> masked fields
        (S*T, M, C_out)."""
        m = mask if mask is not None else self.mask
        lat = self._unnorm(data)
        s, c, t, l = lat.shape
        fields = self.decode_latents(lat.reshape(s * c * t, l))
        if m is not None:
            fields = fields * m
        return fields


def _normalizers(x_params, y_params):
    return norm.Normalizer(x_params, "-11", 0), norm.Normalizer(y_params, "-11", 0)


def _cnf_model(ckpt_path: str) -> SirenFilm:
    state, _ = convert.load_cnf_checkpoint(ckpt_path)
    return SirenFilm.from_state_dict(state)


@register_operator(name="case2")
def case2_operator(ckpt_path: str, max_val, min_val, coords, batch_size=None,
                   device=None, **kw):
    """Channel-flow operator with the reference's hard-coded normalizer
    constants (``measurements.py:58-97``)."""
    x_norm, y_norm = _normalizers(
        (np.array([1.0, 1.0], np.float32), np.array([0.0, 0.0], np.float32)),
        (np.array([[0.9617, 0.2666, 0.2869, 0.0290]], np.float32),
         np.array([[-0.0051, -0.2073, -0.2619, -0.0419]], np.float32)))
    return CNFDecodeOperator(_cnf_model(ckpt_path), coords, x_norm, y_norm,
                             np.asarray(max_val), np.asarray(min_val), device=device)


@register_operator(name="case3")
def case3_operator(coords, max_val, min_val, normalizer_params_path,
                   ckpt_path, batch_size=None, device=None, **kw):
    """y params trimmed to the first 2 channels (``measurements.py:99-137``)."""
    raw = convert.load_normalizer_file(normalizer_params_path)
    y = raw["y_normalizer_params"]
    x_norm, y_norm = _normalizers(raw["x_normalizer_params"],
                                  (y[0][..., :2], y[1][..., :2]))
    return CNFDecodeOperator(_cnf_model(ckpt_path), coords, x_norm, y_norm,
                             np.asarray(max_val), np.asarray(min_val), device=device)


@register_operator(name="case3_gappy")
def case3_gappy_operator(**kw):
    """Gappy variant: same decode, the mask zeroes a field block
    (``measurements.py:139-181``); pass the gappy mask as ``mask``."""
    return case3_operator(**kw)


@register_operator(name="case4")
def case4_operator(coords, max_val, min_val, normalizer_params_path,
                   ckpt_path, batch_size=None, device=None, **kw):
    """3-D cube operator (``measurements.py:183-226``); the published
    normalizer file uses hierarchical ``y_normalizer0u/0l_params`` keys."""
    raw = convert.load_normalizer_file(normalizer_params_path)
    if "y_normalizer0u_params" in raw:
        y_par = (raw["y_normalizer0u_params"], raw["y_normalizer0l_params"])
    else:
        y_par = raw["y_normalizer_params"]
    x_norm, y_norm = _normalizers(raw["x_normalizer_params"], y_par)
    return CNFDecodeOperator(_cnf_model(ckpt_path), coords, x_norm, y_norm,
                             np.asarray(max_val), np.asarray(min_val), device=device)
