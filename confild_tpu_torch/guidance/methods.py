"""Conditioning methods for guided diffusion (DPS and friends; reference
``ConditionalDiffusionGeneration/src/guided_diffusion/condition_methods.py``).

The batch dimension holds independent samples (the JAX package vmaps
them), so :meth:`ConditioningMethod.misfit` returns one norm per sample,
``||y - A(x0_hat_s)||_2``; the sampler differentiates their sum, which
gives each sample exactly its own gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

__CONDITIONING_METHOD__: dict[str, Callable[..., Any]] = {}


def register_conditioning_method(name: str):
    def wrapper(cls):
        if name in __CONDITIONING_METHOD__:
            raise NameError(f"Name {name} is already registered!")
        __CONDITIONING_METHOD__[name] = cls
        return cls
    return wrapper


def get_conditioning_method(name: str, operator, noiser, **kwargs):
    if name not in __CONDITIONING_METHOD__:
        raise NameError(f"Name {name} is not defined!")
    return __CONDITIONING_METHOD__[name](operator=operator, noiser=noiser, **kwargs)


def _per_sample(t: torch.Tensor, b: int, per_sample_numel: int) -> torch.Tensor:
    """``t`` as ``(1 | b, per_sample_numel)``: a measurement shared by every
    sample, or one per sample."""
    if t.numel() == per_sample_numel:
        return t.reshape(1, per_sample_numel)
    return t.reshape(b, per_sample_numel)


@dataclasses.dataclass
class ConditioningMethod:
    operator: Any
    noiser: Any = None

    # does the sampler need grad(misfit) wrt x_prev?  False skips the whole
    # backward (vanilla/projection)
    needs_grad: bool = dataclasses.field(default=True, init=False)

    def project(self, data, noisy_measurement, **kwargs):
        return self.operator.project(data=data, measurement=noisy_measurement, **kwargs)

    def _norms(self, x0_hat, measurement, **kwargs) -> torch.Tensor:
        """Per-sample ``||y - A(x0_hat)||_2``, shape ``(B,)``; Poisson noise
        normalizes by |y| (reference ``condition_methods.py:28-44``)."""
        b = x0_hat.shape[0]
        fields = self.operator.forward(x0_hat, **kwargs)
        per = fields.numel() // b
        diff = _per_sample(measurement, b, per) - fields.reshape(b, per)
        nrm = torch.linalg.vector_norm(diff, dim=1)
        if getattr(self.noiser, "name", "") == "poisson":
            nrm = (nrm[:, None] / _per_sample(measurement, b, per).abs()).mean(dim=1)
        return nrm

    def misfit(self, x0_hat, measurement, generator=None, noise=None, **kwargs):
        return self._norms(x0_hat, measurement, **kwargs)

    def apply_guidance(self, x_t, grad, norm, *, noisy_measurement=None,
                       step_frac=1.0, **kwargs):
        """Post-sample update given the misfit gradient; default: identity."""
        return x_t, norm


@register_conditioning_method("vanilla")
class Identity(ConditioningMethod):
    def __post_init__(self):
        self.needs_grad = False

    def apply_guidance(self, x_t, grad, norm, **kwargs):
        return x_t, None


@register_conditioning_method("projection")
class Projection(ConditioningMethod):
    def __post_init__(self):
        self.needs_grad = False

    def apply_guidance(self, x_t, grad, norm, *, noisy_measurement=None, **kwargs):
        return self.project(x_t, noisy_measurement), None


@register_conditioning_method("mcg")
@dataclasses.dataclass
class ManifoldConstraintGradient(ConditioningMethod):
    scale: float = 1.0

    def apply_guidance(self, x_t, grad, norm, *, noisy_measurement=None, **kwargs):
        return self.project(x_t - grad * self.scale, noisy_measurement), norm


@register_conditioning_method("ps")
@dataclasses.dataclass
class PosteriorSampling(ConditioningMethod):
    """DPS: x_t <- x_t - scale * grad_{x_prev} ||y - A(x0_hat)||
    (reference ``condition_methods.py:78-87``)."""

    scale: float = 1.0

    def apply_guidance(self, x_t, grad, norm, **kwargs):
        return x_t - grad * self.scale, norm


@register_conditioning_method("ps_linear_decay")
@dataclasses.dataclass
class PosteriorSamplingLinearDecay(ConditioningMethod):
    """Scale decays linearly from start_scale to end_scale over the reverse
    trajectory (reference ``condition_methods.py:89-108``); ``step_frac``
    is the step index over the step count (1 at t = T)."""

    scale: float = 1.0
    start_scale: float = 20.0
    end_scale: float = 1.0

    def apply_guidance(self, x_t, grad, norm, *, step_frac=1.0, **kwargs):
        scale = (self.start_scale - self.end_scale) * step_frac + self.end_scale
        return x_t - grad * scale, norm


@register_conditioning_method("ps+")
@dataclasses.dataclass
class PosteriorSamplingPlus(ConditioningMethod):
    """Average of the misfits of ``num_sampling`` perturbed x0_hat
    (reference ``condition_methods.py:110-127``).  The perturbations are
    ``0.05 * U[0, 1)``; ``noise`` supplies the uniforms, else ``generator``
    draws them."""

    num_sampling: int = 5
    scale: float = 1.0

    def misfit(self, x0_hat, measurement, generator=None,
               noise: Sequence[torch.Tensor] | None = None, **kwargs):
        total = 0.0
        for i in range(self.num_sampling):
            u = (noise[i] if noise is not None else
                 torch.rand(x0_hat.shape, generator=generator, device=x0_hat.device,
                            dtype=x0_hat.dtype))
            total = total + self._norms(x0_hat + 0.05 * u, measurement, **kwargs) / self.num_sampling
        return total

    def apply_guidance(self, x_t, grad, norm, **kwargs):
        return x_t - grad * self.scale, norm
