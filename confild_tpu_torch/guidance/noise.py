"""Measurement noise models (reference ``measurements.py:232-314``).  Each
draws from an explicit ``torch.Generator``; without one it is the identity,
as the JAX package is without a key."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__NOISE__: dict[str, Callable[..., Any]] = {}


def register_noise(name: str):
    def wrapper(cls):
        if name in __NOISE__:
            raise NameError(f"Name {name} is already defined!")
        cls.name = name
        __NOISE__[name] = cls
        return cls
    return wrapper


def get_noise(name: str, **kwargs):
    if name not in __NOISE__:
        raise NameError(f"Name {name} is not defined.")
    return __NOISE__[name](**kwargs)


@register_noise("clean")
@dataclasses.dataclass
class Clean:
    def apply(self, data, generator: torch.Generator | None = None):
        return data

    __call__ = apply


@register_noise("gaussian")
@dataclasses.dataclass
class GaussianNoise:
    sigma: float = 0.0

    def apply(self, data, generator: torch.Generator | None = None):
        if generator is None or self.sigma == 0.0:
            return data
        return data + self.sigma * torch.randn(data.shape, generator=generator,
                                               device=data.device, dtype=data.dtype)

    __call__ = apply


@register_noise("poisson")
@dataclasses.dataclass
class PoissonNoise:
    rate: float = 1.0

    def apply(self, data, generator: torch.Generator | None = None):
        """Poisson shot noise on [0, 1]-scaled data
        (reference ``measurements.py:285-314``)."""
        if generator is None:
            return data
        lam = ((data + 1.0) / 2.0).clamp(0, 1) * 255.0 * self.rate
        noisy = torch.poisson(lam, generator=generator).to(data.dtype)
        return noisy / (255.0 * self.rate) * 2.0 - 1.0

    __call__ = apply
