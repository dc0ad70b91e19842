"""Diffusion noise schedules and derived coefficient tables.

As in the reference (``gaussian_diffusion.py:18-62,118-169``), betas and
every derived table are float64 numpy on the host.  They become float32
tensors only at the gather (:func:`extract`).  Timestep respacing follows
``respace.py:7-86`` (section counts and ``"ddimN"`` strides).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Named beta schedule in float64 (reference ``gaussian_diffusion.py:18-42``)."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def space_timesteps(num_timesteps: int, section_counts) -> set[int]:
    """Pick a subset of base timesteps (reference ``respace.py:7-60``).

    ``section_counts`` may be a list of per-section counts, a comma-separated
    string, or ``"ddimN"`` for the DDIM paper's fixed stride.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}"
            )
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken = []
        for _ in range(section_count):
            taken.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Frozen float64 tables of DDPM coefficients, each ``(num_timesteps,)``.

    ``timestep_map`` maps the (possibly respaced) internal step index back to
    the original process index the model was trained with (identity when not
    respaced) — the ``SpacedDiffusion._WrappedModel`` contract
    (``respace.py:110-128``).
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    # FIXED_LARGE variance table: posterior_variance[1] prepended to betas[1:]
    # (reference gaussian_diffusion.py:282-284).
    fixed_large_variance: np.ndarray
    fixed_large_log_variance: np.ndarray
    timestep_map: np.ndarray
    original_num_steps: int

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(betas: Sequence[float] | np.ndarray,
                  timestep_map: np.ndarray | None = None,
                  original_num_steps: int | None = None) -> DiffusionSchedule:
    betas = np.asarray(betas, dtype=np.float64)
    if not (betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-d array in (0, 1]")
    n = betas.shape[0]

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )
    fixed_large_variance = np.append(posterior_variance[1], betas[1:])

    if timestep_map is None:
        timestep_map = np.arange(n, dtype=np.int64)
    if original_num_steps is None:
        original_num_steps = n

    return DiffusionSchedule(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        alphas_cumprod_next=alphas_cumprod_next,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=posterior_log_variance_clipped,
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
        fixed_large_variance=fixed_large_variance,
        fixed_large_log_variance=np.log(fixed_large_variance),
        timestep_map=np.asarray(timestep_map, dtype=np.int64),
        original_num_steps=int(original_num_steps),
    )


def named_schedule(schedule_name: str, steps: int,
                   timestep_respacing: str | Sequence[int] | None = None) -> DiffusionSchedule:
    """Build a (possibly respaced) schedule by name.

    When respacing, the kept-step betas are rebuilt so that the cumulative
    alpha products match the base process on the kept subset (reference
    ``respace.py:78-86``).
    """
    base_betas = get_named_beta_schedule(schedule_name, steps)
    if not timestep_respacing:
        return make_schedule(base_betas)

    use_timesteps = space_timesteps(steps, timestep_respacing)
    base = make_schedule(base_betas)
    last_alpha_cumprod = 1.0
    new_betas, timestep_map = [], []
    for i, alpha_cumprod in enumerate(base.alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return make_schedule(
        np.array(new_betas, dtype=np.float64),
        timestep_map=np.array(timestep_map, dtype=np.int64),
        original_num_steps=steps,
    )


def extract(table: np.ndarray, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``table[t]`` as float32 on ``like``'s device, shaped ``(B, 1, ...)``
    to broadcast against ``like`` (the reference's ``_extract_into_tensor``).

    ``t`` is gathered on the host (the guided loop keeps it there), so no
    device synchronisation happens."""
    idx = t.detach().cpu().numpy()
    out = torch.as_tensor(table[idx], dtype=torch.float32).to(like.device)
    return out.reshape(out.shape + (1,) * (like.ndim - 1))
