"""Gaussian diffusion.  ``training_losses`` and ``calc_bpd_loop`` of the JAX
package belong to the diffusion-training slice of the port."""

from confild_tpu_torch.diffusion.gaussian import (  # noqa: F401
    GaussianDiffusion,
    ModelMeanType,
    ModelVarType,
    create_gaussian_diffusion,
)
