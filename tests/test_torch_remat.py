"""Block rematerialization in the port's U-Net (``use_checkpoint``,
``remat_policy``) against the same model without it and against the JAX
package's ``use_checkpoint=True`` gradients, with converted weights; what
each policy saves; dropout under recompute; the flash route under
checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from confild_tpu.models import unet as junet
from confild_tpu_torch.io.convert import unet_state_dict_from_jax
from confild_tpu_torch.models import unet as tunet
from torch_parity_utils import limit_torch_threads, perturbed, t

# the f32 U-Net parity tests' tolerance (tests/test_torch_unet.py): f32 on
# both sides, convolutions and GroupNorm summed in other orders
RTOL, ATOL = 1e-4, 1e-5
POLICIES = ("full", "matmuls", "matmuls+stats")
UNET = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
            attention_resolutions="8", num_heads=2, use_scale_shift_norm=True)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


@pytest.fixture(scope="module")
def weights():
    params = junet.create_model(**UNET).init(jax.random.key(0))
    return perturbed(jax.tree.map(np.asarray, params), np.random.default_rng(1))


def _port(params, **over):
    m = tunet.create_model(**UNET, **over)
    m.load_state_dict(unet_state_dict_from_jax(params, m))
    return m


def _inputs():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, 16, 16)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    return x, np.array([3, 700]), w


def _port_grads(model, x, ts, w, seed=None):
    """Gradients of ``sum(model(x, t) * w)`` for the input and every
    parameter, by state-dict name."""
    model.zero_grad()
    xt = t(x).requires_grad_(True)
    if seed is not None:
        torch.manual_seed(seed)
    (model(xt, torch.from_numpy(ts)) * t(w)).sum().backward()
    return {"x": xt.grad, **{n: p.grad.clone() for n, p in model.named_parameters()}}


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_equal_no_remat(weights, policy, flash):
    """Remat changes what is stored, not what is computed: every gradient
    equals the model's without remat bit for bit (the recompute runs the
    same CPU arithmetic), on the dense and on the flash route (the flash
    autograd function's forward runs twice)."""
    x, ts, w = _inputs()
    want = _port_grads(_port(weights, use_flash_attention=flash), x, ts, w)
    got = _port_grads(_port(weights, use_flash_attention=flash, use_checkpoint=True,
                            remat_policy=policy), x, ts, w)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_match_jax(weights, policy):
    """Parameter and input gradients against ``jax.grad`` of the JAX U-Net
    with ``use_checkpoint=True`` and the same policy, at the f32 parity
    tolerance; for a parameter gradient (a sum over every pixel of the
    batch, up to 4 in size here) ``ATOL`` is taken relative to its largest
    element."""
    x, ts, w = _inputs()
    jm = junet.create_model(**UNET, use_checkpoint=True, remat_policy=policy)

    def loss(params, xx):
        return jnp.sum(jm.apply(params, xx, jnp.asarray(ts)) * w)
    jp, jx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, weights), jnp.asarray(x))
    model = _port(weights, use_checkpoint=True, remat_policy=policy)
    got = _port_grads(model, x, ts, w)
    want = unet_state_dict_from_jax(jax.tree.map(np.asarray, jp), model)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL * max(1.0, v.abs().max().item()), err_msg=k)


def test_remat_preserves_dropout_masks(weights):
    """With dropout 0.3 in training mode the recompute draws the masks the
    forward drew (the RNG state is restored): every gradient equals the
    un-rematerialized model's from the same seed, and the masks are live
    (another seed gives other gradients)."""
    x, ts, w = _inputs()
    want = _port_grads(_port(weights, dropout=0.3).train(), x, ts, w, seed=5)
    other = _port_grads(_port(weights, dropout=0.3).train(), x, ts, w, seed=6)
    for policy in POLICIES:
        got = _port_grads(_port(weights, dropout=0.3, use_checkpoint=True,
                                remat_policy=policy).train(), x, ts, w, seed=5)
        for k in want:
            assert torch.equal(got[k], want[k]), (policy, k)
    assert not torch.equal(other["x"], want["x"])


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_decides_what_the_backward_recomputes(weights, policy):
    """Forward ops counted during the backward (the backward's own products
    are other ops): "full" recomputes every block's convolutions, dense
    layers and GroupNorms; "matmuls" reruns no convolution and no dense
    layer but recomputes the GroupNorms; "matmuls+stats" reruns neither."""
    aten = torch.ops.aten
    x, ts, w = _inputs()
    model = _port(weights, use_checkpoint=True, remat_policy=policy)
    out = model(t(x).requires_grad_(True), torch.from_numpy(ts))
    with _Count() as count:
        (out * t(w)).sum().backward()
    conv = count.ops.get(aten.convolution.default, 0)
    dense = count.ops.get(aten.addmm.default, 0)
    gn = count.ops.get(aten.native_group_norm.default, 0)
    if policy == "full":
        assert conv > 0 and dense > 0 and gn > 0
    else:
        assert conv == 0 and dense == 0
        assert (gn == 0) == (policy == "matmuls+stats")


@pytest.mark.parametrize("policy", POLICIES)
def test_bf16_remat_gradients_equal_no_remat(weights, policy):
    """The bf16 torso under each policy: every gradient equals the bf16
    model's without remat bit for bit; "matmuls+stats" reruns none of the
    bf16 GroupNorms' float32 statistics (``var_mean``), "matmuls" reruns
    them."""
    x, ts, w = _inputs()
    want = _port_grads(_port(weights, use_bf16=True), x, ts, w)
    model = _port(weights, use_bf16=True, use_checkpoint=True, remat_policy=policy)
    got = _port_grads(model, x, ts, w)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    out = model(t(x).requires_grad_(True), torch.from_numpy(ts))
    with _Count() as count:
        (out * t(w)).sum().backward()
    stats = count.ops.get(torch.ops.aten.var_mean.correction, 0)
    assert (stats == 0) == (policy == "matmuls+stats")


def test_remat_only_under_grad(weights):
    """Sampling (no grad) runs the blocks plainly: the same output as the
    model without remat, bit for bit."""
    x, ts, _ = _inputs()
    with torch.no_grad():
        a = _port(weights, use_checkpoint=True)(t(x), torch.from_numpy(ts))
        b = _port(weights)(t(x), torch.from_numpy(ts))
    assert torch.equal(a, b)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        tunet.create_model(**UNET, use_checkpoint=True, remat_policy="dots")
