"""Port vs JAX package for the diffusion steps given the same noise, also
respaced.  The model is an analytic function of (x, t) so that the tests
hold the diffusion arithmetic alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu.diffusion import gaussian as jg
from confild_tpu.guidance import sampler as jsampler
from confild_tpu_torch.diffusion import gaussian as tg
from confild_tpu_torch.guidance import sampler as tsampler
from torch_parity_utils import limit_torch_threads, t

# f32 tables on the JAX side are cast before derived arithmetic, the port's
# after it: agreement to a few f32 ulps
RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _jax_model(out_channels=1):
    def model(x, tm):
        y = jnp.tanh(0.7 * x) + 1e-3 * tm.astype(jnp.float32).reshape(-1, 1, 1, 1)
        return jnp.concatenate([y, 0.3 * y], axis=1) if out_channels == 2 else y
    return model


def _torch_model(out_channels=1):
    def model(x, tm):
        y = torch.tanh(0.7 * x) + 1e-3 * tm.float().reshape(-1, 1, 1, 1)
        return torch.cat([y, 0.3 * y], dim=1) if out_channels == 2 else y
    return model


def _pair(respacing=None, **kw):
    j = jg.create_gaussian_diffusion(steps=100, noise_schedule="cosine",
                                     timestep_respacing=respacing, **kw)
    p = tg.create_gaussian_diffusion(steps=100, noise_schedule="cosine",
                                     timestep_respacing=respacing, **kw)
    return j, p


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 1, 4, 5)).astype(np.float32) * 1.5
    noise = rng.standard_normal(x.shape).astype(np.float32)
    return x, noise


@pytest.mark.parametrize("respacing", [None, "10"])
def test_q_sample(respacing):
    j, p = _pair(respacing)
    x, noise = _data()
    ts = np.array([0, 4, p.num_timesteps - 1])
    want = np.asarray(j.q_sample(jnp.asarray(x), jnp.asarray(ts), jnp.asarray(noise)))
    got = p.q_sample(t(x), torch.from_numpy(ts), t(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("respacing,kw", [
    (None, {}),
    ("10", {}),
    ("10", {"sigma_small": True}),
    (None, {"predict_xstart": True}),
    ("10", {"learn_sigma": True}),
])
def test_p_mean_variance(respacing, kw):
    j, p = _pair(respacing, **kw)
    x, _ = _data()
    ts = np.array([0, 4, p.num_timesteps - 1])
    oc = 2 if kw.get("learn_sigma") else 1
    want = j.p_mean_variance(_jax_model(oc), jnp.asarray(x), jnp.asarray(ts))
    got = p.p_mean_variance(_torch_model(oc), t(x), torch.from_numpy(ts))
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(np.broadcast_to(got[k].numpy(), x.shape),
                                   np.broadcast_to(np.asarray(want[k]), x.shape),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("respacing", [None, "10"])
def test_p_sample_and_ddim_given_noise(respacing):
    """Fed the JAX step's own noise (``normal(key, x.shape)``), the port's
    steps give the JAX samples."""
    j, p = _pair(respacing)
    x, _ = _data()
    key = jax.random.key(4)
    noise = np.asarray(jax.random.normal(key, x.shape))
    for i in (0, 3):
        ts = np.full((3,), i)
        want = j.p_sample(_jax_model(), jnp.asarray(x), jnp.asarray(ts), key)
        got = p.p_sample(_torch_model(), t(x), torch.from_numpy(ts), noise=t(noise))
        np.testing.assert_allclose(got["sample"].numpy(), np.asarray(want["sample"]),
                                   rtol=RTOL, atol=ATOL)
        want = j.ddim_sample(_jax_model(), jnp.asarray(x), jnp.asarray(ts), key, eta=0.5)
        got = p.ddim_sample(_torch_model(), t(x), torch.from_numpy(ts), noise=t(noise),
                            eta=0.5)
        np.testing.assert_allclose(got["sample"].numpy(), np.asarray(want["sample"]),
                                   rtol=RTOL, atol=ATOL)


def test_dynamic_thresholding_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 1, 6, 6)).astype(np.float32) * 2
    np.testing.assert_allclose(tsampler.dynamic_thresholding(t(x)).numpy(),
                               np.asarray(jsampler.dynamic_thresholding(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
