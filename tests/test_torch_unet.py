"""Port vs JAX package for the ADM U-Net with converted weights: forward in
both qkv layouts, with and without scale-shift norm, and the gradient with
respect to the input (what the DPS step differentiates), on the dense and
the flash-attention route; the per-block flash gating of ``build_plan``."""

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
    """Flash attention is ported now: ``use_flash_attention=True`` builds a
    model whose every attention block takes the kernels, where it used to
    raise.  Block rematerialization, which raised too, is ported as well: a
    ``use_checkpoint`` model with flash on runs forward and backward
    (its parity is ``tests/test_torch_remat.py``)."""
    m = tunet.create_model(image_size=16, num_channels=32, num_res_blocks=1,
                           channel_mult="1,2", attention_resolutions="8",
                           use_flash_attention=True)
    assert m.cfg.use_flash_attention and not m.cfg.flash_auto
    assert _attn_flags(m.plan, tunet.AttnSpec) == [True] * 4
    r = tunet.create_model(image_size=16, num_channels=32, num_res_blocks=1,
                           channel_mult="1,2", attention_resolutions="8",
                           use_flash_attention=True, use_checkpoint=True)
    assert r.cfg.use_checkpoint and r.cfg.remat_policy == "full"
    x = torch.randn(1, 1, 16, 16, requires_grad=True)
    r(x, torch.tensor([5])).sum().backward()
    assert x.grad.shape == x.shape and torch.isfinite(x.grad).all()


def _attn_flags(plan, spec_type):
    return [s.use_flash for block in (*plan.input_blocks, plan.middle_block,
                                      *plan.output_blocks)
            for s in block if isinstance(s, spec_type)]


@pytest.mark.parametrize("new_order", [False, True])
def test_flash_route_matches_jax(new_order):
    """``use_flash_attention=True`` on both sides (the JAX Pallas kernels in
    interpret mode, the port's autograd function on the CPU): forward and
    input gradient, both qkv layouts."""
    jm, params, tm = _models(use_new_attention_order=new_order, use_scale_shift_norm=True,
                             use_flash_attention=True)
    assert all(_attn_flags(tm.plan, tunet.AttnSpec))
    x, ts = _inputs()
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(ts)))
    want_g = jax.grad(lambda xx: jnp.sum(jm.apply(params, xx, jnp.asarray(ts)) * w))(
        jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(ts))
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [
    # 1536^2 at ds 8 / 16: 36864 tokens flip to flash, 9216 stay dense
    dict(image_size=1536, channel_mult="1,1,1,1,1", attention_resolutions="192,96"),
    # Case4's published plan: 144 tokens in the middle block, all dense
    dict(image_size=384, channel_mult="1,1,2,2,4,4", attention_resolutions="32,16,8",
         num_head_channels=64),
    # 3-D: depth x plane tokens, 32 * 32^2 = 32768 at ds 1, 8192 at ds 2
    dict(image_size=32, dims=3, channel_mult="1,2", attention_resolutions="32,16"),
    dict(image_size=32, dims=3, channel_mult="1,2", attention_resolutions="16"),
    # explicit flags override the count both ways
    dict(image_size=384, channel_mult="1,2", attention_resolutions="48",
         use_flash_attention=True),
    dict(image_size=1536, channel_mult="1,2", attention_resolutions="192",
         use_flash_attention=False),
])
def test_build_plan_flash_flags_match_jax(kw):
    """Auto mode gates flash per block by token count as the JAX package
    does (``tests/test_flash_attention.py:340-380``)."""
    kw = dict(dict(num_channels=32, num_res_blocks=1, num_heads=2), **kw)
    jm, tm = junet.create_model(**kw), tunet.create_model(**kw)
    assert tm.cfg.use_flash_attention == jm.cfg.use_flash_attention
    assert tm.cfg.flash_auto == jm.cfg.flash_auto
    flags = _attn_flags(tm.plan, tunet.AttnSpec)
    assert flags and flags == _attn_flags(jm.plan, junet.AttnSpec)


def test_reset_parameters_zeroes_the_reference_zero_modules():
    """The seeded reference initialisation: reproducible from a generator,
    with every ResBlock output conv, attention projection and the final conv
    zeroed, as the JAX ``init`` zeroes them (so the fresh U-Net outputs 0)."""
    kw = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
              attention_resolutions="8", num_heads=2)
    a = tunet.create_model(**kw).reset_parameters(torch.Generator().manual_seed(3))
    b = tunet.create_model(**kw).reset_parameters(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    jm = junet.create_model(**kw)
    jparams = jax.tree.map(np.array, jm.init(jax.random.key(0)))
    zero_jax = {k for k, v in unet_state_dict(jparams, jm).items() if not v.abs().any()}
    zero_port = {k for k, v in a.state_dict().items() if not v.abs().any()}
    assert zero_port == zero_jax
    x, ts = _inputs()
    with torch.no_grad():
        assert not a(t(x), torch.from_numpy(ts)).abs().any()
