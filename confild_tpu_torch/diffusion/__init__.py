"""Gaussian diffusion: sampling steps, training losses and timestep
samplers.  ``calc_bpd_loop`` and the unguided sample loops of the JAX
package are still to port (ROADMAP.md Queue 1, item 10)."""

from confild_tpu_torch.diffusion.gaussian import (  # noqa: F401
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
    create_gaussian_diffusion,
)
