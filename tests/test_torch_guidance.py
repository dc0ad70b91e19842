"""Port vs JAX package for guided generation: the CNF decode operator on
both paths, each conditioning method for one step, and a 4-step guided DDPM
trajectory through U-Net and CNF fed the JAX loop's own per-step noise."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu.core import normalize as jnorm
from confild_tpu.guidance import create_sampler as j_create_sampler
from confild_tpu.guidance import get_conditioning_method as j_method
from confild_tpu.guidance import get_noise as j_noise
from confild_tpu.guidance import get_operator as j_operator
from confild_tpu.guidance.operators import CNFDecodeOperator as JOperator
from confild_tpu.models import unet as junet
from confild_tpu_torch.core import normalize as tnorm
from confild_tpu_torch.guidance import create_sampler as t_create_sampler
from confild_tpu_torch.guidance import get_conditioning_method as t_method
from confild_tpu_torch.guidance import get_noise as t_noise
from confild_tpu_torch.guidance import get_operator as t_operator
from confild_tpu_torch.guidance.operators import CNFDecodeOperator as TOperator
from confild_tpu_torch.io.convert import unet_state_dict_from_jax
from confild_tpu_torch.models import unet as tunet
from torch_parity_utils import jax_siren, limit_torch_threads, perturbed, t

METHODS = ["vanilla", "projection", "mcg", "ps", "ps_linear_decay", "ps+"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _normalizer_params():
    return ((np.full(3, 1.0, np.float32), np.zeros(3, np.float32)),
            (np.full((1, 3), 2.0, np.float32), np.full((1, 3), -2.0, np.float32)))


def _operators(latent=16, n_sensors=5, use_pallas=None, seed=0):
    params, model = jax_siren(c_in=3, latent=latent, c_out=3, layers=2, hidden=32, seed=seed)
    coords = np.random.default_rng(seed).uniform(size=(n_sensors, 3)).astype(np.float32)
    xp, yp = _normalizer_params()
    jop = JOperator(params, coords, jnorm.Normalizer(xp, "-11", 0),
                    jnorm.Normalizer(yp, "-11", 0), np.float32(3.0), np.float32(-3.0),
                    use_pallas=use_pallas)
    top = TOperator(model, coords, tnorm.Normalizer(xp, "-11", 0),
                    tnorm.Normalizer(yp, "-11", 0), np.float32(3.0), np.float32(-3.0),
                    use_pallas=use_pallas, device="cpu")
    return jop, top


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cnf_operator_forward_and_gradient(use_pallas):
    """Both decode paths; the Pallas one runs the kernels in interpret mode
    on the JAX side and their plain versions in the port.  Gradients are
    held at the JAX tests' tolerance for latent gradients."""
    jop, top = _operators(use_pallas=use_pallas)
    rng = np.random.default_rng(1)
    data = (0.3 * rng.standard_normal((2, 1, 4, 16))).astype(np.float32)
    w = rng.standard_normal((8, 5, 3)).astype(np.float32)
    want = np.asarray(jop.forward(jnp.asarray(data)))
    want_g = jax.grad(lambda d: jnp.sum(jop.forward(d) * w))(jnp.asarray(data))
    d = t(data).requires_grad_(True)
    fields = top.forward(d)
    (fields * t(w)).sum().backward()
    assert fields.shape == want.shape == (8, 5, 3)
    np.testing.assert_allclose(fields.detach().numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_g), rtol=5e-3, atol=1e-4)


def test_decode_path_rule():
    """rows x points > 65536 takes the fused path, as in the JAX package."""
    _, top = _operators(latent=16, n_sensors=200)
    calls = []
    # the plain loop calls the Linear modules; the fused path reads weights
    top.model.net1[0].register_forward_hook(lambda *a: calls.append("plain"))
    top.decode_latents(torch.zeros(300, 16))      # 60000 pairs: plain loop
    assert calls == ["plain"]
    top.decode_latents(torch.zeros(400, 16))      # 80000 pairs: fused path
    assert calls == ["plain"]


def _oracle_models():
    def jmodel(x, tm):
        return jnp.tanh(0.8 * x) + 1e-3 * tm.astype(jnp.float32).reshape(-1, 1, 1, 1)

    def tmodel(x, tm):
        return torch.tanh(0.8 * x) + 1e-3 * tm.float().reshape(-1, 1, 1, 1)
    return jmodel, tmodel


@pytest.mark.parametrize("name", METHODS)
def test_conditioning_method_one_step(name):
    """One guided step of each method on the inpainting operator, the port
    fed the JAX step's noise: the sample noise normal(key), the noisy
    measurement's normal(fold_in(key, 1)) and, for ps+, the perturbations
    uniform(fold_in(fold_in(key, 2), i)) (``guidance/sampler.py:92-110``,
    ``methods.py:147-157``)."""
    shape = (1, 1, 6, 6)
    rng = np.random.default_rng(2)
    mask = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    y = (0.5 * mask * rng.standard_normal(shape)).astype(np.float32)
    img = rng.standard_normal(shape).astype(np.float32)
    kw = {"scale": 0.7} if name != "ps+" else {"scale": 0.7, "num_sampling": 3}
    if name in ("vanilla", "projection"):
        kw = {}
    jsampler = j_create_sampler("ddpm", steps=10, noise_schedule="cosine")
    tsampler = t_create_sampler("ddpm", steps=10, noise_schedule="cosine")
    jm = j_method(name, j_operator("inpainting", mask=jnp.asarray(mask)),
                  j_noise("clean"), **kw)
    tm = t_method(name, t_operator("inpainting", mask=t(mask)), t_noise("clean"), **kw)
    jmodel, tmodel = _oracle_models()

    key = jax.random.key(7)
    i = 6
    ts = np.full((1,), i)
    want, want_d = jsampler._one_step(jmodel, jnp.asarray(img), jnp.asarray(ts), key,
                                      jnp.asarray(y), jm, step_frac=i / 10)
    pert = [t(jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, 2), k), shape))
            for k in range(3)]
    got, got_d = tsampler._one_step(
        tmodel, t(img), torch.from_numpy(ts), t(y), tm,
        noise=t(jax.random.normal(key, shape)),
        measurement_noise=t(jax.random.normal(jax.random.fold_in(key, 1), shape)),
        misfit_noise=pert, step_frac=i / 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    if want_d is None:
        assert got_d is None
    else:
        np.testing.assert_allclose(got_d.numpy(), np.reshape(np.asarray(want_d), (1,)),
                                   rtol=2e-5, atol=1e-6)


def test_guided_ddpm_trajectory_matches_jax():
    """4 guided DDPM steps (ps) through a U-Net and the CNF operator for two
    independent samples: the JAX loop vmapped over per-sample keys, the port
    batched and fed normal(fold_in(key_s, i)) for step i.  Four steps of
    f32 U-Net + SIREN + gradient, in other summation orders: 1e-4."""
    kw = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
              attention_resolutions="8", num_heads=2, use_scale_shift_norm=True)
    jnet = junet.create_model(**kw)
    uparams = perturbed(jax.tree.map(np.asarray, jnet.init(jax.random.key(0))),
                        np.random.default_rng(3), scale=0.02)
    tnet = tunet.create_model(**kw)
    tnet.load_state_dict(unet_state_dict_from_jax(uparams, tnet))
    tnet.requires_grad_(False)

    jop, top = _operators(latent=16, n_sensors=5)
    rng = np.random.default_rng(4)
    truth = np.tanh(rng.standard_normal((1, 1, 16, 16))).astype(np.float32)
    y = np.asarray(jop.forward(jnp.asarray(truth)))             # (16, 5, 3)
    x_start = rng.standard_normal((2, 1, 1, 16, 16)).astype(np.float32)
    keys = jax.random.split(jax.random.key(5), 2)

    jsampler = j_create_sampler("ddpm", steps=4, noise_schedule="cosine")
    jmeth = j_method("ps", jop, j_noise("gaussian", sigma=0.0), scale=0.5)

    def run_one(x0, k):
        return jsampler.p_sample_loop(lambda x, tm: jnet.apply(uparams, x, tm), x0,
                                      jnp.asarray(y), jmeth, k, return_distances=True)
    want, want_d = jax.vmap(run_one)(jnp.asarray(x_start), keys)

    tsampler = t_create_sampler("ddpm", steps=4, noise_schedule="cosine")
    tmeth = t_method("ps", top, t_noise("gaussian", sigma=0.0), scale=0.5)

    def noise_fn(i):
        eps = np.concatenate([np.asarray(jax.random.normal(jax.random.fold_in(k, i),
                                                           (1, 1, 16, 16)))
                              for k in keys])
        return t(eps), None, None
    got, got_d = tsampler.p_sample_loop(tnet, t(x_start[:, 0]), t(y), tmeth,
                                        noise_fn=noise_fn, return_distances=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_d.numpy().T, np.asarray(want_d), rtol=1e-4, atol=1e-5)
    # per-sample misfits: the two samples are guided independently
    assert not np.allclose(got_d.numpy()[:, 0], got_d.numpy()[:, 1])


def test_noise_models():
    x = torch.zeros(2000)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(t_noise("clean")(x), x)
    assert torch.equal(t_noise("gaussian", sigma=0.3)(x), x)      # no generator
    n = t_noise("gaussian", sigma=0.3)(x, generator=g)
    assert abs(n.std().item() - 0.3) < 0.03
    p = t_noise("poisson", rate=1.0)(x, generator=g)
    assert abs(p.mean().item()) < 0.02 and p.min() >= -1 and p.max() <= 1
    with pytest.raises(NameError):
        t_noise("nope")


def test_case_operator_factories(tmp_path):
    """case4 reads the hierarchical y keys from .pt and the plain keys from
    .ckpt; case3 trims y to 2 channels; case2 carries hard-coded constants."""
    params, _ = jax_siren(c_in=3, latent=16, c_out=3, layers=1, hidden=32)
    ckpt = tmp_path / "cnf.ckpt"
    ckpt.write_bytes(pickle.dumps({"model_state_dict": params}))
    xp, yp = _normalizer_params()
    torch.save({"x_normalizer_params": tuple(map(torch.from_numpy, xp)),
                "y_normalizer0u_params": torch.from_numpy(yp[0]),
                "y_normalizer0l_params": torch.from_numpy(yp[1])}, tmp_path / "n.pt")
    (tmp_path / "n.ckpt").write_bytes(pickle.dumps(
        {"x_normalizer_params": xp, "y_normalizer_params": yp}))
    coords = np.random.default_rng(0).uniform(size=(4, 3)).astype(np.float32)
    data = torch.zeros(1, 1, 2, 16)
    common = dict(coords=coords, max_val=np.float32(1), min_val=np.float32(-1),
                  ckpt_path=str(ckpt), device="cpu")
    a = t_operator("case4", normalizer_params_path=str(tmp_path / "n.pt"), **common)
    b = t_operator("case4", normalizer_params_path=str(tmp_path / "n.ckpt"), **common)
    np.testing.assert_array_equal(a.forward(data).numpy(), b.forward(data).numpy())
    c = t_operator("case3", normalizer_params_path=str(tmp_path / "n.ckpt"), **common)
    assert c.y_normalizer.params[0].shape == (1, 2)
    params2, _ = jax_siren(c_in=2, latent=16, c_out=4, layers=1, hidden=32)
    ckpt2 = tmp_path / "cnf2.ckpt"
    ckpt2.write_bytes(pickle.dumps({"model_state_dict": params2}))
    d = t_operator("case2", **{**common, "coords": coords[:, :2], "ckpt_path": str(ckpt2)})
    np.testing.assert_allclose(d.y_normalizer.params[0].numpy(),
                               [[0.9617, 0.2666, 0.2869, 0.0290]], rtol=1e-6)
    assert d.forward(data).shape == (2, 4, 4)
