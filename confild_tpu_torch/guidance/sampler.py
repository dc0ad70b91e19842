"""Guided (DPS) sampling loops (reference ``ConditionalDiffusionGeneration/
src/guided_diffusion/gaussian_diffusion.py:169-206``).

The JAX package runs the trajectory as one ``lax.scan`` with
``jax.value_and_grad`` in its body.  Here it is a Python loop; each step runs
one U-Net forward with ``x_prev.requires_grad_(True)``, one
``torch.autograd.grad`` of the summed per-sample misfit with respect to
``x_prev``, then detaches.  The batch dimension holds independent samples.

Registry names match the reference ``create_sampler``
(``gaussian_diffusion.py:30-52``): ``ddpm`` (ancestral) and ``ddim``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from confild_tpu_torch.core import schedules as sched
from confild_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                                  MEAN_PROCESSORS,
                                                  VAR_PROCESSORS)

__SAMPLER__: dict[str, Any] = {}


def register_sampler(name: str):
    def wrapper(cls):
        if name in __SAMPLER__:
            raise NameError(f"Name {name} is already registered!")
        __SAMPLER__[name] = cls
        return cls
    return wrapper


def create_sampler(sampler: str = "ddpm", steps: int = 1000,
                   noise_schedule: str = "cosine", model_mean_type: str = "epsilon",
                   model_var_type: str = "fixed_large", dynamic_threshold: bool = False,
                   clip_denoised: bool = True, rescale_timesteps: bool = False,
                   timestep_respacing: str | None = None):
    """Build a guided sampler (reference ``create_sampler`` signature)."""
    schedule = sched.named_schedule(noise_schedule, steps, timestep_respacing or None)
    diffusion = GaussianDiffusion(
        schedule, model_mean_type=MEAN_PROCESSORS[model_mean_type],
        model_var_type=VAR_PROCESSORS[model_var_type],
        rescale_timesteps=rescale_timesteps)
    return __SAMPLER__[sampler](diffusion=diffusion, clip_denoised=clip_denoised,
                                dynamic_threshold=dynamic_threshold)


def dynamic_thresholding(x: torch.Tensor, percentile: float = 0.95) -> torch.Tensor:
    """Imagen-style per-sample dynamic thresholding."""
    s = torch.quantile(x.abs().reshape(x.shape[0], -1), percentile, dim=-1)
    s = s.clamp(min=1.0).reshape(-1, *(1,) * (x.ndim - 1))
    return x.clamp(-s, s) / s


# noise for step i of the loop: (sample noise, measurement noise, misfit
# noise); any entry may be None, to be drawn from the generator
NoiseFn = Callable[[int], tuple]


@dataclasses.dataclass
class GuidedSampler:
    diffusion: GaussianDiffusion
    clip_denoised: bool = True
    dynamic_threshold: bool = False

    def _denoised_fn(self):
        return dynamic_thresholding if self.dynamic_threshold else None

    def _one_step(self, model, img, t, measurement, cond_method, generator=None,
                  noise=None, measurement_noise=None, misfit_noise=None,
                  step_frac=1.0, mask=None):
        """One guided reverse step; returns ``(x_t, per-sample misfit or
        None)``.  ``noise`` is the step's sample noise, ``measurement_noise``
        that of the noisy measurement (``projection``/``mcg``),
        ``misfit_noise`` the ``ps+`` perturbations; each is drawn from
        ``generator`` when not given."""
        kwargs = {"mask": mask} if mask is not None else {}
        if cond_method.needs_grad:
            with torch.enable_grad():
                x_prev = img.detach().requires_grad_(True)
                out = self._inner_sample(model, x_prev, t, generator, noise)
                norm = cond_method.misfit(out["pred_xstart"], measurement,
                                          generator=generator, noise=misfit_noise, **kwargs)
                (grad,) = torch.autograd.grad(norm.sum(), x_prev)
            norm = norm.detach()
        else:
            with torch.no_grad():
                out = self._inner_sample(model, img, t, generator, noise)
            grad = norm = None
        if measurement_noise is None:
            measurement_noise = torch.randn(measurement.shape, generator=generator,
                                            device=measurement.device,
                                            dtype=measurement.dtype)
        # every sample shares the step index: index the schedule with t[:1]
        noisy_measurement = self.diffusion.q_sample(measurement, t[:1], measurement_noise)
        x_t, distance = cond_method.apply_guidance(
            out["sample"].detach(), grad, norm,
            noisy_measurement=noisy_measurement, step_frac=step_frac)
        return x_t.detach(), distance

    def p_sample_loop(self, model, x_start, measurement, cond_method,
                      generator: torch.Generator | None = None,
                      noise_fn: NoiseFn | None = None, mask=None,
                      return_distances: bool = False):
        """Guided reverse trajectory from ``x_T = x_start`` (reference
        ``gaussian_diffusion.py:169-206``).  ``noise_fn(i)`` supplies step
        i's noise; otherwise ``generator`` draws it.  With
        ``return_distances`` also returns the ``(steps, B)`` misfits."""
        n = self.diffusion.num_timesteps
        b = x_start.shape[0]
        img = x_start
        distances = []
        for i in range(n - 1, -1, -1):
            t = torch.full((b,), i, dtype=torch.long)
            noise, m_noise, f_noise = noise_fn(i) if noise_fn is not None else (None,) * 3
            img, distance = self._one_step(
                model, img, t, measurement, cond_method, generator=generator,
                noise=noise, measurement_noise=m_noise, misfit_noise=f_noise,
                step_frac=i / n, mask=mask)
            distances.append(distance if distance is not None
                             else torch.zeros(b, device=img.device))
        if return_distances:
            return img, torch.stack(distances)
        return img

    @staticmethod
    def sharded_noise_fn(shape, measurement, cond_method, generator: torch.Generator,
                         rows: slice) -> NoiseFn:
        """Each step's noise drawn for the whole ensemble of ``shape``, in
        the order in which one process draws it (the sample noise, the
        ``ps+`` perturbations, the measurement noise), keeping the ensemble
        members ``rows``: a shard of the ensemble then follows the same
        trajectories as it does in the whole."""
        n_misfit = getattr(cond_method, "num_sampling", 0) if cond_method.needs_grad else 0

        def noise_fn(i):
            noise = torch.randn(shape, generator=generator, device=generator.device)
            misfit = [torch.rand(shape, generator=generator, device=generator.device)[rows]
                      for _ in range(n_misfit)]
            m_noise = torch.randn(measurement.shape, generator=generator,
                                  device=measurement.device, dtype=measurement.dtype)
            return noise[rows], m_noise, misfit or None
        return noise_fn

    def _inner_sample(self, model, x, t, generator, noise) -> dict:
        """The unconditional reverse step of the subclass."""
        raise NotImplementedError


@register_sampler("ddpm")
@dataclasses.dataclass
class DDPM(GuidedSampler):
    def _inner_sample(self, model, x, t, generator, noise):
        return self.diffusion.p_sample(model, x, t, generator, noise,
                                       clip_denoised=self.clip_denoised,
                                       denoised_fn=self._denoised_fn())


@register_sampler("ddim")
@dataclasses.dataclass
class DDIM(GuidedSampler):
    eta: float = 0.0

    def _inner_sample(self, model, x, t, generator, noise):
        return self.diffusion.ddim_sample(model, x, t, generator, noise,
                                          clip_denoised=self.clip_denoised,
                                          denoised_fn=self._denoised_fn(), eta=self.eta)
