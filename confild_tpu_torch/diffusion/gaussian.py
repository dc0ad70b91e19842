"""Gaussian (DDPM/DDIM) diffusion steps (reference ``UnconditionalDiffusion
Training_and_Generation/src/gaussian_diffusion.py`` and the guided stage's
``posterior_mean_variance.py``).

The schedule tables stay float64 numpy on the host and become float32 only
at the gather (:func:`confild_tpu_torch.core.schedules.extract`).
Respacing is folded into the schedule; the model receives original-process
indices through ``timestep_map`` (the ``_WrappedModel`` contract,
``respace.py:110-128``).  Every step that draws noise takes an explicit
``noise`` tensor or a ``torch.Generator``.
"""

from __future__ import annotations

import enum
from typing import Callable, Sequence

import numpy as np
import torch

from confild_tpu_torch.core import schedules as sched

ModelFn = Callable[..., torch.Tensor]  # model(x, t, **kwargs) -> output
_ext = sched.extract


class ModelMeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType(enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


def _noise_like(x: torch.Tensor, noise: torch.Tensor | None,
                generator: torch.Generator | None) -> torch.Tensor:
    if noise is not None:
        return noise
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


class GaussianDiffusion:
    """Diffusion ops over a precomputed float64 schedule.

    The ``model`` passed to every method is ``model(x, t, **kwargs)`` and
    receives original-process timesteps.  Timesteps ``t`` are int64 tensors
    that may stay on the host; :meth:`model_t` moves them to ``x``'s device.
    """

    def __init__(self, schedule: sched.DiffusionSchedule,
                 model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
                 model_var_type: ModelVarType = ModelVarType.FIXED_LARGE,
                 rescale_timesteps: bool = False):
        self.s = schedule
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.rescale_timesteps = rescale_timesteps
        self.num_timesteps = schedule.num_timesteps
        # derived tables the steps gather from (float64, host)
        self._log_betas = np.log(schedule.betas)
        self._recip_coef1 = 1.0 / schedule.posterior_mean_coef1
        self._coef2_over_coef1 = schedule.posterior_mean_coef2 / schedule.posterior_mean_coef1

    def model_t(self, t: torch.Tensor, device) -> torch.Tensor:
        """Internal index -> what the model sees (map + optional rescale)."""
        mapped = torch.as_tensor(self.s.timestep_map[t.detach().cpu().numpy()], device=device)
        if self.rescale_timesteps:
            return mapped.float() * (1000.0 / self.s.original_num_steps)
        return mapped

    # -- q process ----------------------------------------------------------

    def q_sample(self, x_start, t, noise):
        return (_ext(self.s.sqrt_alphas_cumprod, t, x_start) * x_start
                + _ext(self.s.sqrt_one_minus_alphas_cumprod, t, x_start) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        mean = (_ext(self.s.posterior_mean_coef1, t, x_t) * x_start
                + _ext(self.s.posterior_mean_coef2, t, x_t) * x_t)
        variance = _ext(self.s.posterior_variance, t, x_t)
        log_variance = _ext(self.s.posterior_log_variance_clipped, t, x_t)
        return mean, variance, log_variance

    # -- p process ----------------------------------------------------------

    def p_mean_variance(self, model: ModelFn, x, t, clip_denoised: bool = True,
                        denoised_fn=None, model_kwargs=None) -> dict:
        model_output = model(x, self.model_t(t, x.device), **(model_kwargs or {}))

        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = model_output.chunk(2, dim=1)
            if self.model_var_type == ModelVarType.LEARNED:
                model_log_variance = model_var_values
            else:
                min_log = _ext(self.s.posterior_log_variance_clipped, t, x)
                max_log = _ext(self._log_betas, t, x)
                frac = (model_var_values + 1) / 2
                model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.model_var_type == ModelVarType.FIXED_LARGE:
            model_variance = _ext(self.s.fixed_large_variance, t, x)
            model_log_variance = _ext(self.s.fixed_large_log_variance, t, x)
        else:  # FIXED_SMALL
            model_variance = _ext(self.s.posterior_variance, t, x)
            model_log_variance = _ext(self.s.posterior_log_variance_clipped, t, x)

        def process_xstart(xs):
            if denoised_fn is not None:
                xs = denoised_fn(xs)
            if clip_denoised:
                # zero gradient outside [-1, 1], as the DPS gradient expects
                xs = xs.clamp(-1.0, 1.0)
            return xs

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(self._predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        else:
            if self.model_mean_type == ModelMeanType.START_X:
                pred_xstart = process_xstart(model_output)
            else:
                pred_xstart = process_xstart(self._predict_xstart_from_eps(x, t, model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)

        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart}

    def _predict_xstart_from_eps(self, x_t, t, eps):
        return (_ext(self.s.sqrt_recip_alphas_cumprod, t, x_t) * x_t
                - _ext(self.s.sqrt_recipm1_alphas_cumprod, t, x_t) * eps)

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        return (_ext(self._recip_coef1, t, x_t) * xprev
                - _ext(self._coef2_over_coef1, t, x_t) * x_t)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        return ((_ext(self.s.sqrt_recip_alphas_cumprod, t, x_t) * x_t - pred_xstart)
                / _ext(self.s.sqrt_recipm1_alphas_cumprod, t, x_t))

    # -- sampling steps -------------------------------------------------------

    def p_sample(self, model: ModelFn, x, t, generator=None, noise=None,
                 clip_denoised=True, denoised_fn=None, model_kwargs=None) -> dict:
        """One ancestral step; ``noise`` (else drawn from ``generator``) is the
        JAX loop's ``normal(fold_in(key, i))`` (``gaussian.py:204``)."""
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs)
        noise = _noise_like(x, noise, generator)
        nonzero_mask = (t != 0).to(x.device, x.dtype).reshape(-1, *(1,) * (x.ndim - 1))
        sample = out["mean"] + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(self, model: ModelFn, x, t, generator=None, noise=None,
                    clip_denoised=True, denoised_fn=None, model_kwargs=None,
                    eta: float = 0.0) -> dict:
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = _ext(self.s.alphas_cumprod, t, x)
        alpha_bar_prev = _ext(self.s.alphas_cumprod_prev, t, x)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        noise = _noise_like(x, noise, generator)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        nonzero_mask = (t != 0).to(x.device, x.dtype).reshape(-1, *(1,) * (x.ndim - 1))
        sample = mean_pred + nonzero_mask * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}


# ---------------------------------------------------------------------------
# factory mirroring reference create_gaussian_diffusion (script_util.py:388-426)
# ---------------------------------------------------------------------------

def create_gaussian_diffusion(*, steps: int = 1000, learn_sigma: bool = False,
                              sigma_small: bool = False, noise_schedule: str = "linear",
                              predict_xstart: bool = False, rescale_timesteps: bool = False,
                              timestep_respacing: str | Sequence[int] | None = None,
                              ) -> GaussianDiffusion:
    schedule = sched.named_schedule(noise_schedule, steps, timestep_respacing)
    if not learn_sigma:
        var_type = ModelVarType.FIXED_SMALL if sigma_small else ModelVarType.FIXED_LARGE
    else:
        var_type = ModelVarType.LEARNED_RANGE
    return GaussianDiffusion(
        schedule,
        model_mean_type=ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON,
        model_var_type=var_type, rescale_timesteps=rescale_timesteps)


# string registries of the guided stage (reference
# posterior_mean_variance.py:24-44,145-160)
MEAN_PROCESSORS = {
    "previous_x": ModelMeanType.PREVIOUS_X,
    "start_x": ModelMeanType.START_X,
    "epsilon": ModelMeanType.EPSILON,
}
VAR_PROCESSORS = {
    "learned": ModelVarType.LEARNED,
    "fixed_small": ModelVarType.FIXED_SMALL,
    "fixed_large": ModelVarType.FIXED_LARGE,
    "learned_range": ModelVarType.LEARNED_RANGE,
}
