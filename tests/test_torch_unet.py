"""Port vs JAX package for the ADM U-Net with converted weights: forward in
both qkv layouts, with and without scale-shift norm, and the gradient with
respect to the input (what the DPS step differentiates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu.io.torch_export import unet_state_dict
from confild_tpu.models import unet as junet
from confild_tpu_torch.io.convert import unet_state_dict_from_jax
from confild_tpu_torch.models import unet as tunet
from torch_parity_utils import limit_torch_threads, perturbed, t

# f32 on both sides; convolutions and GroupNorm sum in other orders
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _models(**over):
    kw = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
              attention_resolutions="8", num_heads=2)
    kw.update(over)
    jm = junet.create_model(**kw)
    params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.key(0))),
                       np.random.default_rng(1))
    tm = tunet.create_model(**kw)
    tm.load_state_dict(unet_state_dict_from_jax(params, tm))
    return jm, params, tm


def _inputs(b=2):
    rng = np.random.default_rng(2)
    return rng.standard_normal((b, 1, 16, 16)).astype(np.float32), np.array([3, 700][:b])


@pytest.mark.parametrize("new_order", [False, True])
@pytest.mark.parametrize("scale_shift", [False, True])
def test_forward_matches_jax(new_order, scale_shift):
    jm, params, tm = _models(use_new_attention_order=new_order,
                             use_scale_shift_norm=scale_shift)
    x, ts = _inputs()
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(ts)))
    with torch.no_grad():
        got = tm(t(x), torch.from_numpy(ts)).numpy()
    assert got.shape == want.shape == (2, 1, 16, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_input_gradient_matches_jax():
    jm, params, tm = _models(use_scale_shift_norm=True)
    x, ts = _inputs(b=1)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda xx: jnp.sum(jm.apply(params, xx, jnp.asarray(ts)) * w))(
        jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    (tm(xt, torch.from_numpy(ts)) * t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_state_dict_keys_match_torch_export():
    """The port's module tree has exactly the reference keys."""
    jm, params, tm = _models(use_scale_shift_norm=True)
    ref = unet_state_dict(params, jm)
    assert set(tm.state_dict()) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), v.numpy(), err_msg=k)


def test_flash_attention_is_not_ported():
    with pytest.raises(NotImplementedError, match="flash attention"):
        tunet.create_model(image_size=16, num_channels=32, num_res_blocks=1,
                           channel_mult="1,2", attention_resolutions="8",
                           use_flash_attention=True)
