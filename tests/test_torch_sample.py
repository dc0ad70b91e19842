"""Port vs JAX package for unconditional generation: the DDPM and DDIM
loops (with and without respacing and ``step_hook``), the reverse DDIM step,
the ``cond_fn`` conditioning and the bits-per-dimension loop, on a tiny
U-Net whose weights are converted from the JAX parameters.  The port is fed
the JAX loops' own draws: ``split(key)`` for the initial image and
``normal(fold_in(loop_key, i))`` for step ``i`` (the respaced index)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu.core import packing as jpacking
from confild_tpu.diffusion import gaussian as jg
from confild_tpu.models import unet as junet
from confild_tpu_torch.core import packing as tpacking
from confild_tpu_torch.diffusion import gaussian as tg
from confild_tpu_torch.io.convert import unet_state_dict_from_jax
from confild_tpu_torch.models import unet as tunet
from torch_parity_utils import limit_torch_threads, perturbed, t

RTOL, ATOL = 1e-5, 1e-5
UNET = dict(image_size=8, num_channels=32, num_res_blocks=1, channel_mult="1,2",
            attention_resolutions="4", num_heads=2)
SHAPE = (2, 1, 8, 8)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


@pytest.fixture(scope="module")
def nets():
    jnet = junet.create_model(**UNET)
    params = perturbed(jax.tree.map(np.asarray, jnet.init(jax.random.key(0))),
                       np.random.default_rng(1), scale=0.02)
    tnet = tunet.create_model(**UNET)
    tnet.load_state_dict(unet_state_dict_from_jax(params, tnet))
    tnet.eval().requires_grad_(False)
    jparams = jax.tree.map(jnp.asarray, params)
    return (lambda x, tm: jnet.apply(jparams, x, tm)), (lambda x, tm: tnet(x, tm))


def _pair(respacing):
    steps = 5 if respacing is None else 20
    j = jg.create_gaussian_diffusion(steps=steps, noise_schedule="cosine",
                                     timestep_respacing=respacing)
    p = tg.create_gaussian_diffusion(steps=steps, noise_schedule="cosine",
                                     timestep_respacing=respacing)
    assert p.num_timesteps == j.num_timesteps == 5
    return j, p


def _jax_draws(key, shape, n):
    """The initial image and step i's draw exactly as the JAX loops take them."""
    noise_key, loop_key = jax.random.split(key)
    img = np.asarray(jax.random.normal(noise_key, shape, jnp.float32))
    steps = {i: np.asarray(jax.random.normal(jax.random.fold_in(loop_key, i), shape,
                                             jnp.float32)) for i in range(n)}
    return img, steps


def _hooks():
    """The same ``step_hook`` in both packages: mixes in the x0 estimate and
    reads the step index."""
    def jhook(x_t, x_prev, t, pred_xstart):
        return 0.9 * x_t + 0.1 * pred_xstart + 1e-3 * t.reshape(-1, 1, 1, 1) * x_prev

    def thook(x_t, x_prev, t, pred_xstart):
        return (0.9 * x_t + 0.1 * pred_xstart
                + 1e-3 * t.to(x_t.device, x_t.dtype).reshape(-1, 1, 1, 1) * x_prev)
    return jhook, thook


@pytest.mark.parametrize("respacing", [None, "5"])
@pytest.mark.parametrize("hook", [False, True])
def test_p_sample_loop_matches_jax(nets, respacing, hook):
    jmodel, tmodel = nets
    j, p = _pair(respacing)
    key = jax.random.key(7)
    img, draws = _jax_draws(key, SHAPE, p.num_timesteps)
    jhook, thook = _hooks() if hook else (None, None)
    want = np.asarray(j.p_sample_loop(jmodel, SHAPE, key, step_hook=jhook))
    got = p.p_sample_loop(tmodel, SHAPE, noise=t(img), step_noise=lambda i: t(draws[i]),
                          step_hook=thook)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("respacing", [None, "5"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_matches_jax(nets, respacing, eta):
    jmodel, tmodel = nets
    j, p = _pair(respacing)
    key = jax.random.key(8)
    img, draws = _jax_draws(key, SHAPE, p.num_timesteps)
    want = np.asarray(j.ddim_sample_loop(jmodel, SHAPE, key, eta=eta))
    got = p.ddim_sample_loop(tmodel, SHAPE, noise=t(img), step_noise=lambda i: t(draws[i]),
                             eta=eta)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_ddim_sample_loop_with_hook_matches_jax(nets):
    jmodel, tmodel = nets
    j, p = _pair("5")
    key = jax.random.key(9)
    img, draws = _jax_draws(key, SHAPE, p.num_timesteps)
    jhook, thook = _hooks()
    want = np.asarray(j.ddim_sample_loop(jmodel, SHAPE, key, eta=0.5, step_hook=jhook))
    got = p.ddim_sample_loop(tmodel, SHAPE, noise=t(img), step_noise=lambda i: t(draws[i]),
                             eta=0.5, step_hook=thook)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_loop_draws_from_generator_when_not_given(nets):
    """Without draws passed in, the loop draws from the generator: the same
    seed gives the same samples, another seed others."""
    _, tmodel = nets
    _, p = _pair(None)
    runs = [p.p_sample_loop(tmodel, SHAPE, generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and not torch.allclose(runs[0], runs[2])
    assert runs[0].shape == SHAPE and torch.isfinite(runs[0]).all()


@pytest.mark.parametrize("respacing", [None, "5"])
def test_ddim_reverse_sample_matches_jax(nets, respacing):
    jmodel, tmodel = nets
    j, p = _pair(respacing)
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    for i in (0, 2, p.num_timesteps - 2):
        ts = np.full((SHAPE[0],), i)
        want = j.ddim_reverse_sample(jmodel, jnp.asarray(x), jnp.asarray(ts))
        got = p.ddim_reverse_sample(tmodel, t(x), torch.from_numpy(ts))
        for k in ("sample", "pred_xstart"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def _cond_fns():
    """The gradient of log p(y | x) = -|x|^2 / 2, which is -x, and reads the
    model's timestep."""
    def jcond(x, tm):
        return -x + 1e-4 * tm.astype(jnp.float32).reshape(-1, 1, 1, 1)

    def tcond(x, tm):
        return -x + 1e-4 * tm.float().reshape(-1, 1, 1, 1)
    return jcond, tcond


@pytest.mark.parametrize("respacing", [None, "5"])
def test_condition_mean_and_score_match_jax(nets, respacing):
    jmodel, tmodel = nets
    j, p = _pair(respacing)
    jcond, tcond = _cond_fns()
    x = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    for i in (1, p.num_timesteps - 1):
        ts = np.full((SHAPE[0],), i)
        jout = j.p_mean_variance(jmodel, jnp.asarray(x), jnp.asarray(ts))
        tout = p.p_mean_variance(tmodel, t(x), torch.from_numpy(ts))
        want = j.condition_mean(jcond, jout, jnp.asarray(x), jnp.asarray(ts))
        got = p.condition_mean(tcond, tout, t(x), torch.from_numpy(ts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        want = j.condition_score(jcond, jout, jnp.asarray(x), jnp.asarray(ts))
        got = p.condition_score(tcond, tout, t(x), torch.from_numpy(ts))
        for k in ("mean", "pred_xstart"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_cond_fn_loops_match_jax(nets, sampler):
    """``cond_fn`` through the steps and loops: ``condition_mean`` in DDPM,
    ``condition_score`` in DDIM."""
    jmodel, tmodel = nets
    j, p = _pair("5")
    jcond, tcond = _cond_fns()
    key = jax.random.key(10)
    img, draws = _jax_draws(key, SHAPE, p.num_timesteps)
    if sampler == "ddpm":
        want = j.p_sample_loop(jmodel, SHAPE, key, cond_fn=jcond)
        got = p.p_sample_loop(tmodel, SHAPE, noise=t(img), step_noise=lambda i: t(draws[i]),
                              cond_fn=tcond)
    else:
        want = j.ddim_sample_loop(jmodel, SHAPE, key, cond_fn=jcond, eta=0.5)
        got = p.ddim_sample_loop(tmodel, SHAPE, noise=t(img),
                                 step_noise=lambda i: t(draws[i]), cond_fn=tcond, eta=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("respacing", [None, "5"])
def test_calc_bpd_loop_matches_jax(nets, respacing):
    jmodel, tmodel = nets
    j, p = _pair(respacing)
    x0 = np.clip(np.random.default_rng(5).standard_normal(SHAPE), -1, 1).astype(np.float32)
    key = jax.random.key(11)
    draws = {i: np.asarray(jax.random.normal(jax.random.fold_in(key, i), SHAPE, jnp.float32))
             for i in range(p.num_timesteps)}
    want = j.calc_bpd_loop(jmodel, jnp.asarray(x0), key)
    got = p.calc_bpd_loop(tmodel, t(x0), step_noise=lambda i: t(draws[i]))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == np.shape(want[k]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert tuple(got["vb"].shape) == (SHAPE[0], p.num_timesteps)
    # column 0 is the last timestep (t descending); column -1 is t = 0, the
    # decoder's NLL term
    x_t = p.q_sample(t(x0), torch.zeros(SHAPE[0], dtype=torch.long), t(draws[0]))
    nll = p._vb_terms_bpd(tmodel, t(x0), x_t, torch.zeros(SHAPE[0], dtype=torch.long))
    np.testing.assert_allclose(got["vb"][:, -1].numpy(), nll["output"].numpy(), rtol=1e-6)


def test_packing_matches_jax():
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((3, 5, 4)).astype(np.float32)
    img = tpacking.pack_latents(t(lat))
    assert tuple(img.shape) == (3, 1, 5, 4)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jpacking.pack_latents(lat)))
    np.testing.assert_array_equal(tpacking.unpack_latents(img).numpy(), lat)
    with pytest.raises(ValueError, match="1-channel"):
        tpacking.unpack_latents(torch.zeros(2, 2, 3, 3))
    grid = tpacking.create_coordinates_grid((3, 4, 2))
    np.testing.assert_array_equal(tpacking.flatten_grid(grid),
                                  jpacking.flatten_grid(jpacking.create_coordinates_grid((3, 4, 2))))
    mx, mn = 2.5, -0.5
    unit = tpacking.minmax_to_unit_interval(t(lat), mx, mn)
    np.testing.assert_allclose(unit.numpy(),
                               np.asarray(jpacking.minmax_to_unit_interval(lat, mx, mn)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tpacking.unit_interval_to_minmax(unit, mx, mn).numpy(), lat,
                               rtol=1e-6, atol=1e-6)
