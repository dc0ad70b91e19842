"""Field/coordinate normalizers (reference
``ConditionalNeuralField/cnf/utils/normalize.py:99-120``), on tensors and
numpy arrays.

* ``'-11'``  : ``(x - min) / (max - min) * 2 - 1``      params = (max, min)
* ``'01'``   : ``(x - min) / (max - min)``              params = (max, min)
* ``'ms'``   : ``(x - mean) / std``                     params = (mean, std)
* ``'none'`` : identity                                 params = None

Fitting (:func:`fit`, ``Normalizer.fit_normalize``) runs on numpy arrays
on the host, as the CNF trainer does before it moves the data to the
device.  It matches the torch reference: a reduction over ``dim`` with
``keepdims`` (a global scalar when ``dim`` is None) and a Bessel-corrected
std.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

METHODS = ("-11", "01", "ms", "none")


def fit(data: np.ndarray, method: str = "-11", dim: int | None = None):
    """Normalizer params of ``data``: an ``(a, b)`` pair, or None for
    ``'none'`` (``confild_tpu/core/normalize.py:27-47``)."""
    if method == "none":
        return None
    if method in ("-11", "01"):
        if dim is None:
            return np.max(data), np.min(data)
        return np.max(data, axis=dim, keepdims=True), np.min(data, axis=dim, keepdims=True)
    if method == "ms":
        if dim is None:
            return np.mean(data), np.std(data, ddof=1)
        return (np.mean(data, axis=dim, keepdims=True),
                np.std(data, axis=dim, keepdims=True, ddof=1))
    raise ValueError(f"unknown normalizer method {method!r}")


def _tensor(p, dtype, device) -> torch.Tensor:
    if not isinstance(p, torch.Tensor):
        p = np.asarray(p)
    return torch.as_tensor(p, dtype=dtype, device=device)


def _like(params, data):
    """Params as the same kind (and, for tensors, device/dtype) as data."""
    if isinstance(data, torch.Tensor):
        return tuple(_tensor(p, data.dtype, data.device) for p in params)
    return params


def normalize(data, params, method: str = "-11"):
    if method == "none":
        return data
    a, b = _like(params, data)
    if method == "-11":
        return (data - b) / (a - b) * 2 - 1
    if method == "01":
        return (data - b) / (a - b)
    if method == "ms":
        return (data - a) / b
    raise ValueError(f"unknown normalizer method {method!r}")


def denormalize(data_norm, params, method: str = "-11"):
    if method == "none":
        return data_norm
    a, b = _like(params, data_norm)
    if method == "-11":
        return (data_norm + 1) / 2 * (a - b) + b
    if method == "01":
        return data_norm * (a - b) + b
    if method == "ms":
        return data_norm * b + a
    raise ValueError(f"unknown normalizer method {method!r}")


class Normalizer:
    """The reference ``Normalizer_ts`` API (``fit_normalize`` /
    ``normalize`` / ``denormalize`` / ``get_params``); ``params`` is the
    fitted (a, b) pair, or None before fitting."""

    def __init__(self, params: Sequence[Any] = (), method: str = "-11",
                 dim: int | None = None):
        self.params = tuple(params) if params is not None and len(params) else None
        self.method = method
        self.dim = dim

    def fit_normalize(self, data):
        if self.params is None and self.method != "none":
            self.params = fit(data, self.method, self.dim)
        return normalize(data, self.params, self.method)

    def normalize(self, data):
        return normalize(data, self.params, self.method)

    def denormalize(self, data_norm):
        return denormalize(data_norm, self.params, self.method)

    def get_params(self):
        return self.params

    def to(self, device: torch.device | str) -> "Normalizer":
        """A copy with params as float32 tensors on ``device``."""
        if self.params is None:
            return Normalizer((), self.method, self.dim)
        params = tuple(_tensor(p, torch.float32, device) for p in self.params)
        return Normalizer(params, self.method, self.dim)
