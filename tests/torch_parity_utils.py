"""Shared set-up for the ``test_torch_*`` parity tests: the same numpy
inputs go through the JAX package and the PyTorch port on the CPU."""

import jax
import numpy as np
import torch

from confild_tpu.models import cnf as jcnf
from confild_tpu_torch.io.convert import cnf_state_dict_from_jax
from confild_tpu_torch.models.cnf import SirenFilm


def limit_torch_threads():
    """Several test workers share the host: keep torch to 2 threads."""
    torch.set_num_threads(2)


def jax_siren(c_in=3, latent=16, c_out=3, layers=2, hidden=32, seed=0):
    """JAX SIREN-FiLM params (3 modulated layers x 32 wide by default) as a
    numpy pytree, and the port's decoder carrying the same weights."""
    m = jcnf.create_nf("SIRENAutodecoder_film", in_coord_features=c_in,
                       in_latent_features=latent, out_features=c_out,
                       num_hidden_layers=layers, hidden_features=hidden)
    params = jax.tree.map(np.asarray, m.init_params(jax.random.key(seed)))
    return params, SirenFilm.from_state_dict(cnf_state_dict_from_jax(params))


def perturbed(params, rng, scale=0.05):
    """Every leaf plus seeded noise: the JAX U-Net init zeroes its output
    convolutions, which would make the parity tests vacuous."""
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        params)


def f64_decode(params, coords, latents, w0=30.0):
    """Float64 numpy decode, the truth the decode criteria are held to."""
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    x = np.asarray(coords, np.float64)[None]
    z = np.asarray(latents, np.float64)
    for l1, l2 in zip(p["net1"][:-1], p["net2"]):
        x = np.sin(w0 * (x @ l1["kernel"] + l1["bias"] + (z @ l2["kernel"])[:, None, :]))
    return x @ p["net1"][-1]["kernel"] + p["net1"][-1]["bias"]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())
