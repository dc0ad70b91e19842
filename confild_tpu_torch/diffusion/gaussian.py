"""Gaussian (DDPM/DDIM) diffusion steps (reference ``UnconditionalDiffusion
Training_and_Generation/src/gaussian_diffusion.py`` and the guided stage's
``posterior_mean_variance.py``).

The schedule tables stay float64 numpy on the host and become float32 only
at the gather (:func:`confild_tpu_torch.core.schedules.extract`).
Respacing is folded into the schedule; the model receives original-process
indices through ``timestep_map`` (the ``_WrappedModel`` contract,
``respace.py:110-128``).  Every step that draws noise takes an explicit
``noise`` tensor or a ``torch.Generator``; the loops take the initial image
(``noise``) and each step's draw (``step_noise(i)``, ``i`` the respaced
index) the same way, so that fed the JAX loop's draws (the first half of
``split(key)`` for the image, ``normal(fold_in(loop_key, i))`` for step
``i``) they give the JAX result.  Python loops take the place of the JAX
package's ``lax.scan``.  ``training_losses`` is the training objective
(``confild_tpu/diffusion/gaussian.py:303-367``).
"""

from __future__ import annotations

import contextlib
import enum
from typing import Callable, Sequence

import numpy as np
import torch

from confild_tpu_torch.core import schedules as sched
from confild_tpu_torch.diffusion.losses import discretized_gaussian_log_likelihood, normal_kl
from confild_tpu_torch.models.nn import mean_flat

ModelFn = Callable[..., torch.Tensor]  # model(x, t, **kwargs) -> output
StepNoise = Callable[[int], torch.Tensor]  # respaced index i -> step i's draw
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


class LossType(enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


def _noise_like(x: torch.Tensor, noise: torch.Tensor | None,
                generator: torch.Generator | None) -> torch.Tensor:
    if noise is not None:
        return noise
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def _initial_image(shape, noise, generator) -> torch.Tensor:
    if noise is not None:
        return noise
    return torch.randn(tuple(shape), generator=generator,
                       device=None if generator is None else generator.device)


class GaussianDiffusion:
    """Diffusion ops over a precomputed float64 schedule.

    The ``model`` passed to every method is ``model(x, t, **kwargs)`` and
    receives original-process timesteps.  Timesteps ``t`` are int64 tensors
    that may stay on the host; :meth:`model_t` moves them to ``x``'s device.
    """

    def __init__(self, schedule: sched.DiffusionSchedule,
                 model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
                 model_var_type: ModelVarType = ModelVarType.FIXED_LARGE,
                 loss_type: LossType = LossType.MSE,
                 rescale_timesteps: bool = False):
        self.s = schedule
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type
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

    def q_mean_variance(self, x_start, t):
        mean = _ext(self.s.sqrt_alphas_cumprod, t, x_start) * x_start
        variance = _ext(1.0 - self.s.alphas_cumprod, t, x_start)
        log_variance = _ext(self.s.log_one_minus_alphas_cumprod, t, x_start)
        return mean, variance, log_variance

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

    # -- classifier guidance (reference gaussian_diffusion.py:356-393) ------

    def condition_mean(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        """The mean shifted by the variance times ``cond_fn``'s gradient of
        the log-likelihood."""
        gradient = cond_fn(x, self.model_t(t, x.device), **(model_kwargs or {}))
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn, p_mean_var, x, t, model_kwargs=None) -> dict:
        """The score-based conditioning of DDIM: eps shifted by
        ``sqrt(1 - alpha_bar)`` times the gradient, x0 and the mean
        recomputed from it."""
        alpha_bar = _ext(self.s.alphas_cumprod, t, x)
        eps = self._predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(
            x, self.model_t(t, x.device), **(model_kwargs or {}))
        out = dict(p_mean_var)
        out["pred_xstart"] = self._predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    # -- sampling steps -------------------------------------------------------

    def p_sample(self, model: ModelFn, x, t, generator=None, noise=None,
                 clip_denoised=True, denoised_fn=None, cond_fn=None,
                 model_kwargs=None) -> dict:
        """One ancestral step; ``noise`` (else drawn from ``generator``) is the
        JAX loop's ``normal(fold_in(key, i))`` (``gaussian.py:204``)."""
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs)
        noise = _noise_like(x, noise, generator)
        nonzero_mask = (t != 0).to(x.device, x.dtype).reshape(-1, *(1,) * (x.ndim - 1))
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t, model_kwargs)
        sample = out["mean"] + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(self, model: ModelFn, x, t, generator=None, noise=None,
                    clip_denoised=True, denoised_fn=None, cond_fn=None,
                    model_kwargs=None, eta: float = 0.0) -> dict:
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs)
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

    def ddim_reverse_sample(self, model: ModelFn, x, t, clip_denoised=True,
                            denoised_fn=None, model_kwargs=None) -> dict:
        """Deterministic reverse ODE step x_t -> x_{t+1} (reference
        ``gaussian_diffusion.py:588-621``)."""
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_next = _ext(self.s.alphas_cumprod_next, t, x)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                     + torch.sqrt(1 - alpha_bar_next) * eps)
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    # -- sampling loops -------------------------------------------------------

    def _loop(self, step_fn, shape, noise, generator, step_noise, cond_fn,
              step_hook) -> torch.Tensor:
        """``x_T`` (``noise``, else drawn) through every step from the last
        respaced index down to 0; without ``cond_fn`` under ``no_grad``."""
        grad_mode = torch.no_grad() if cond_fn is None else contextlib.nullcontext()
        with grad_mode:
            img = _initial_image(shape, noise, generator)
            for i in range(self.num_timesteps - 1, -1, -1):
                t = torch.full((img.shape[0],), i, dtype=torch.long)
                out = step_fn(img, t, None if step_noise is None else step_noise(i))
                nxt = out["sample"]
                if step_hook is not None:
                    nxt = step_hook(x_t=nxt, x_prev=img, t=t, pred_xstart=out["pred_xstart"])
                img = nxt
        return img

    def p_sample_loop(self, model: ModelFn, shape: Sequence[int], noise=None,
                      generator=None, step_noise: StepNoise | None = None,
                      clip_denoised=True, denoised_fn=None, cond_fn=None,
                      model_kwargs=None, step_hook=None) -> torch.Tensor:
        """The ancestral loop (``confild_tpu/diffusion/gaussian.py:213-241``).
        ``step_hook(x_t=, x_prev=, t=, pred_xstart=) -> x_next`` may replace
        each step's result; draws not passed in come from ``generator``, on
        its device."""
        def step(img, t, draw):
            return self.p_sample(model, img, t, generator, draw, clip_denoised,
                                 denoised_fn, cond_fn, model_kwargs)
        return self._loop(step, shape, noise, generator, step_noise, cond_fn, step_hook)

    def ddim_sample_loop(self, model: ModelFn, shape: Sequence[int], noise=None,
                         generator=None, step_noise: StepNoise | None = None,
                         clip_denoised=True, denoised_fn=None, cond_fn=None,
                         model_kwargs=None, eta: float = 0.0,
                         step_hook=None) -> torch.Tensor:
        """The DDIM loop (``confild_tpu/diffusion/gaussian.py:277-301``); the
        draws as in :meth:`p_sample_loop` (at ``eta`` 0 they do not enter)."""
        def step(img, t, draw):
            return self.ddim_sample(model, img, t, generator, draw, clip_denoised,
                                    denoised_fn, cond_fn, model_kwargs, eta)
        return self._loop(step, shape, noise, generator, step_noise, cond_fn, step_hook)

    # -- training losses ------------------------------------------------------

    def _vb_terms_bpd(self, model: ModelFn, x_start, x_t, t, clip_denoised=True,
                      model_kwargs=None) -> dict:
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model, x_t, t, clip_denoised, model_kwargs=model_kwargs)
        kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"],
                                 out["log_variance"])) / np.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = mean_flat(decoder_nll) / np.log(2.0)
        output = torch.where((t == 0).to(kl.device), decoder_nll, kl)
        return {"output": output, "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model: ModelFn, x_start, t, model_kwargs=None, noise=None,
                        valid: bool = False, generator=None) -> dict:
        """Per-sample losses (reference ``gaussian_diffusion.py:744-821``);
        ``noise`` (else drawn from ``generator``) is the JAX function's
        ``normal(key)``.  ``valid=True`` renames mse to valid_mse."""
        model_kwargs = model_kwargs or {}
        noise = _noise_like(x_start, noise, generator)
        x_t = self.q_sample(x_start, t, noise)
        terms: dict[str, torch.Tensor] = {}
        mse_name = "valid_mse" if valid else "mse"

        if self.loss_type.is_vb():
            terms["loss"] = self._vb_terms_bpd(model, x_start, x_t, t,
                                               model_kwargs=model_kwargs)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output = model(x_t, self.model_t(t, x_t.device), **model_kwargs)
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = model_output.chunk(2, dim=1)
            # the variance's VLB with the mean frozen (the reference's
            # frozen_out, :784-800)
            frozen = torch.cat([model_output.detach(), model_var_values], dim=1)
            terms["vb"] = self._vb_terms_bpd(lambda *a, **k: frozen, x_start, x_t, t,
                                             model_kwargs=model_kwargs)["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * self.num_timesteps / 1000.0

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        else:
            target = x_start if self.model_mean_type == ModelMeanType.START_X else noise
        terms[mse_name] = mean_flat((target - model_output) ** 2)
        terms["loss"] = terms[mse_name] + terms["vb"] if "vb" in terms else terms[mse_name]
        return terms


    def _prior_bpd(self, x_start) -> torch.Tensor:
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        kl_prior = normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)
        return mean_flat(kl_prior) / np.log(2.0)

    @torch.no_grad()
    def calc_bpd_loop(self, model: ModelFn, x_start, generator=None,
                      step_noise: StepNoise | None = None, clip_denoised=True,
                      model_kwargs=None) -> dict:
        """Bits per dimension over every timestep (reference
        ``gaussian_diffusion.py:841-896``): ``vb``, ``xstart_mse`` and ``mse``
        as ``(B, T)`` with t descending, as the JAX package returns them.
        ``step_noise(i)`` is the JAX loop's ``normal(fold_in(key, i))``."""
        vb, xstart_mse, mse = [], [], []
        for i in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((x_start.shape[0],), i, dtype=torch.long)
            noise = _noise_like(x_start, None if step_noise is None else step_noise(i),
                                generator)
            x_t = self.q_sample(x_start, t, noise)
            out = self._vb_terms_bpd(model, x_start, x_t, t, clip_denoised, model_kwargs)
            eps = self._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            mse.append(mean_flat((eps - noise) ** 2))
        vb = torch.stack(vb, dim=1)
        prior_bpd = self._prior_bpd(x_start)
        return {"total_bpd": vb.sum(dim=1) + prior_bpd, "prior_bpd": prior_bpd, "vb": vb,
                "xstart_mse": torch.stack(xstart_mse, dim=1),
                "mse": torch.stack(mse, dim=1)}


# ---------------------------------------------------------------------------
# factory mirroring reference create_gaussian_diffusion (script_util.py:388-426)
# ---------------------------------------------------------------------------

def create_gaussian_diffusion(*, steps: int = 1000, learn_sigma: bool = False,
                              sigma_small: bool = False, noise_schedule: str = "linear",
                              use_kl: bool = False, predict_xstart: bool = False,
                              rescale_timesteps: bool = False,
                              rescale_learned_sigmas: bool = False,
                              timestep_respacing: str | Sequence[int] | None = None,
                              ) -> GaussianDiffusion:
    schedule = sched.named_schedule(noise_schedule, steps, timestep_respacing)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if not learn_sigma:
        var_type = ModelVarType.FIXED_SMALL if sigma_small else ModelVarType.FIXED_LARGE
    else:
        var_type = ModelVarType.LEARNED_RANGE
    return GaussianDiffusion(
        schedule,
        model_mean_type=ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON,
        model_var_type=var_type, loss_type=loss_type, rescale_timesteps=rescale_timesteps)


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
