"""Gaussian diffusion: sampling steps and loops, training losses, the
bits-per-dimension loop and timestep samplers."""

from confild_tpu_torch.diffusion.gaussian import (  # noqa: F401
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
    create_gaussian_diffusion,
)
