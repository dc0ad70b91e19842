"""Port vs JAX package for the CNF decoder, its weight converter and the
decode kernels' plain versions (the JAX Pallas kernels run in interpret
mode, as ``tests/test_siren_decode.py`` runs them).

A deep w0 = 30 SIREN amplifies f32 round-off chaotically, so decode outputs
are held to the JAX tests' own criterion: the error against a float64 numpy
truth is at most twice the JAX plain f32 path's error plus 1e-6
(``tests/test_siren_decode.py:34-48``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu import config as jconfig
from confild_tpu.io.torch_export import cnf_state_dict
from confild_tpu.models import cnf as jcnf
from confild_tpu.ops import siren_decode as jsd
from confild_tpu_torch import config as tconfig
from confild_tpu_torch.models import cnf as tcnf
from confild_tpu_torch.ops import siren_decode as tsd
from torch_parity_utils import f64_decode, jax_siren, limit_torch_threads, t


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


@pytest.fixture(scope="module")
def setup():
    params, model = jax_siren(c_in=3, latent=16, c_out=3, layers=2, hidden=32)
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    latents = (0.1 * rng.standard_normal((5, 16))).astype(np.float32)
    g = rng.standard_normal((5, 300, 3)).astype(np.float32)
    return params, model, coords, latents, g


def _err(a, truth):
    return np.abs(np.asarray(a, np.float64) - truth).max()


def test_converter_round_trip_matches_torch_export(setup):
    """cnf_state_dict_from_jax gives exactly the JAX package's own export."""
    params, model, *_ = setup
    ref = cnf_state_dict(params)
    ours = model.state_dict()
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy(), err_msg=k)


def test_siren_film_apply_matches_jax(setup):
    params, model, coords, latents, _ = setup
    truth = f64_decode(params, coords, latents)
    jax_out = np.asarray(jsd.siren_decode(params, coords, latents, use_pallas=False))
    with torch.no_grad():
        ours = tcnf.siren_film_apply(model, t(coords)[None], t(latents)[:, None]).numpy()
    assert ours.shape == (5, 300, 3)
    assert _err(ours, truth) <= 2 * _err(jax_out, truth) + 1e-6


def test_forward_plain_matches_pallas_interpret(setup):
    """The forward kernel's plain version against ``_decode_kernel`` in
    interpret mode, both held to the float64 truth."""
    params, model, coords, latents, _ = setup
    truth = f64_decode(params, coords, latents)
    jax_plain = np.asarray(jsd.siren_decode(params, coords, latents, use_pallas=False))
    pallas = np.asarray(jsd.fused_siren_decode(params, coords, latents, 30.0, 2, 128, True))
    with torch.no_grad():
        ours = tsd.fused_siren_decode(model, t(coords), t(latents)).numpy()
    bound = 2 * _err(jax_plain, truth) + 1e-6
    assert _err(ours, truth) <= bound and _err(pallas, truth) <= bound
    # same folded arithmetic, same polynomial: agree to f32 round-off
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=2e-6)


def test_dz_plain_matches_pallas_interpret(setup):
    """dL/dlatents from the dz kernel's plain version against
    ``_decode_dz_kernel`` in interpret mode; both are f32 evaluations of the
    same recompute-and-walk-back, summed in another order."""
    params, model, coords, latents, g = setup
    pallas = np.asarray(jsd.fused_siren_decode_dz(params, coords, latents, g, 30.0, 8, 128, True))
    ours = tsd.fused_siren_decode_dz(model, t(coords), t(latents), t(g)).numpy()
    np.testing.assert_allclose(ours, pallas, rtol=1e-4, atol=1e-5)


def test_dlatents_matches_jax_grad(setup):
    """The frozen op's gradient (dz plain version on the CPU) against
    ``jax.grad`` of the plain decode, at the JAX tests' tolerance for the
    same comparison (``tests/test_siren_decode.py:80-95``)."""
    params, model, coords, latents, g = setup
    want = jax.grad(lambda z: jnp.sum(
        jsd.siren_decode(params, coords, z, use_pallas=False) * g))(latents)
    lat = t(latents).requires_grad_(True)
    (tsd.fused_siren_decode_frozen(model, t(coords), lat) * t(g)).sum().backward()
    np.testing.assert_allclose(lat.grad.numpy(), np.asarray(want), rtol=5e-3, atol=1e-4)
    assert all(p.grad is None for p in model.parameters())


def test_single_modulated_layer():
    """num_hidden_layers = 0: no middle weights (the n_mid = 0 edge)."""
    params, model = jax_siren(c_in=2, latent=8, c_out=2, layers=0, hidden=32, seed=3)
    rng = np.random.default_rng(2)
    coords = rng.uniform(size=(64, 2)).astype(np.float32)
    latents = rng.standard_normal((3, 8)).astype(np.float32)
    truth = f64_decode(params, coords, latents)
    jax_plain = np.asarray(jsd.siren_decode(params, coords, latents, use_pallas=False))
    with torch.no_grad():
        ours = tsd.fused_siren_decode(model, t(coords), t(latents)).numpy()
    assert _err(ours, truth) <= 2 * _err(jax_plain, truth) + 1e-6
    g = rng.standard_normal((3, 64, 2)).astype(np.float32)
    want = jax.grad(lambda z: jnp.sum(
        jsd.siren_decode(params, coords, z, use_pallas=False) * g))(latents)
    np.testing.assert_allclose(
        tsd.fused_siren_decode_dz(model, t(coords), t(latents), t(g)).numpy(),
        np.asarray(want), rtol=5e-3, atol=1e-4)


def test_from_recipe_and_registry(tmp_path):
    path = tmp_path / "cnf.yml"
    path.write_text("dims: 3\nhidden_size: 16\nNF:\n  name: SIRENAutodecoder_film\n"
                    "  out_features: 3\n  num_hidden_layers: 2\n  hidden_features: 32\n"
                    "  omega_0: 25.0\n")
    j = jcnf.siren_film_from_recipe(jconfig.basic_input(str(path)))
    p = tcnf.siren_film_from_recipe(tconfig.basic_input(str(path)))
    assert p.w0 == j.config.w0 == 25.0 and p.n_modulated == j.config.n_modulated
    jp = jax.tree.map(np.asarray, j.init_params(jax.random.key(0)))
    assert [tuple(w.shape) for w in p.state_dict().values()] == \
        [tuple(w.shape) for w in cnf_state_dict(jp).values()]
    with pytest.raises(KeyError):
        tcnf.create_nf("nope")


def test_pass_through_model_batch_matches_jax(setup):
    """The differentiable batched decode with normalizers, against the JAX
    package's ``pass_through_model_batch`` (plain path on both sides)."""
    from confild_tpu.core.normalize import Normalizer as JNormalizer
    from confild_tpu.inference import pass_through_model_batch as jpass
    from confild_tpu_torch.core.normalize import Normalizer as TNormalizer
    from confild_tpu_torch.inference import pass_through_model_batch as tpass
    params, model, coords, latents, _ = setup
    xp = (np.full(3, 1.0, np.float32), np.full(3, -1.0, np.float32))
    yp = (np.full((1, 3), 3.0, np.float32), np.full((1, 3), -1.0, np.float32))
    want = np.asarray(jpass(coords, latents, params, JNormalizer(xp, "-11", 0),
                            JNormalizer(yp, "-11", 0), batch_size=2, use_pallas=False))
    got = tpass(coords, latents, model, TNormalizer(xp, "-11", 0), TNormalizer(yp, "-11", 0),
                batch_size=2, use_pallas=False, device="cpu")
    assert got.shape == want.shape == (5, 300, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)
