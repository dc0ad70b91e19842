"""The bf16 paths of the port against the JAX package on the CPU, with the
same numpy-seeded inputs and the weights carried over by ``io/convert.py``:
the U-Net's bf16 torso (``use_bf16``, ``use_f32_tail``) forward and
gradients on the dense and the flash route, ``cast_torso_params``, and the
SIREN-FiLM decode forward with ``compute_dtype`` bfloat16 (the plain
version of the bf16 forward kernel) and its frozen op's gradient."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu.models import unet as junet
from confild_tpu.ops import siren_decode as jsd
from confild_tpu_torch.io.convert import unet_state_dict_from_jax
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.ops import siren_decode as tsd
from torch_parity_utils import jax_siren, limit_torch_threads, perturbed, t

# Two bf16 evaluations of one U-Net round at the same places (the port
# mirrors JAX's: conv then bias, GroupNorm's affine and backward, SiLU) but
# sum in other orders, and each rounding flip spreads through the blocks.
# Relative L2 over the output, the input gradient and all parameter
# gradients at once, held to the JAX package's own bf16 error bound
# (tests/test_unet.py:450-464: 0.02 relative); measured 0.0095-0.0124
# (output), 0.0157-0.0187 (input gradient), 0.0145-0.0186 (parameters),
# where JAX's bf16 U-Net itself is 0.018-0.019 and 0.025-0.029 off its f32 one.
UNET_BF16_TOL = 0.02
UNET = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
            attention_resolutions="8", num_heads=2, use_scale_shift_norm=True)
# The bf16 decode against JAX's bf16 _decode_kernel in interpret mode:
# relative L2 1e-3.  The plain version rounds every product's operands as
# JAX does; f32 sums in other orders flip a bf16 rounding now and then
# (measured 4e-5 to 1.6e-4).  The float32 forward is 4e-3 to 1e-2 away.
DECODE_BF16_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


@pytest.fixture(scope="module")
def weights():
    params = junet.create_model(**UNET).init(jax.random.key(0))
    return perturbed(jax.tree.map(np.asarray, params), np.random.default_rng(1))


def _inputs():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, 16, 16)).astype(np.float32)
    return x, np.array([3, 700]), rng.standard_normal(x.shape).astype(np.float32)


def _port(params, **over):
    m = tunet.create_model(**UNET, **over)
    m.load_state_dict(unet_state_dict_from_jax(params, m))
    return m


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("f32_tail", [False, True])
def test_bf16_unet_matches_jax(weights, flash, f32_tail):
    """Output, input gradient and every parameter gradient of ``sum(out * w)``
    against the JAX bf16 U-Net (its flash kernels in interpret mode when
    ``flash``); the output is float32 and so are the parameters and their
    gradients (float32 master weights)."""
    x, ts, w = _inputs()
    kw = dict(use_bf16=True, use_f32_tail=f32_tail, use_flash_attention=flash)
    jm = junet.create_model(**UNET, **kw)

    def loss(params, xx):
        return jnp.sum(jm.apply(params, xx, jnp.asarray(ts)) * w)
    jparams = jax.tree.map(jnp.asarray, weights)
    want = np.asarray(jm.apply(jparams, jnp.asarray(x), jnp.asarray(ts)))
    jp, jx = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    model = _port(weights, **kw)
    assert model.cfg.torso_dtype == torch.bfloat16
    xt = t(x).requires_grad_(True)
    out = model(xt, torch.from_numpy(ts))
    (out * t(w)).sum().backward()
    assert out.dtype == torch.float32
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
    jgrads = unet_state_dict_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                                      model)
    names = [n for n, _ in model.named_parameters()]
    got_p = np.concatenate([p.grad.numpy().ravel() for p in model.parameters()])
    want_p = np.concatenate([jgrads[n].numpy().ravel() for n in names])
    errs = (_rel(out.detach().numpy(), want), _rel(xt.grad.numpy(), jx), _rel(got_p, want_p))
    assert max(errs) <= UNET_BF16_TOL, errs
    # not vacuous: the torso runs in bf16 (the f32 U-Net is 0.018-0.019 away)
    with torch.no_grad():
        f32 = _port(weights, use_flash_attention=flash)(t(x), torch.from_numpy(ts))
    assert _rel(f32.numpy(), want) > 5e-3


def test_fp16_means_bf16():
    assert tunet.create_model(**UNET, use_fp16=True).cfg.torso_dtype == torch.bfloat16
    m = tunet.create_model(**UNET, use_f32_tail=True)
    assert m.cfg.torso_dtype == m.cfg.tail_dtype == torch.float32


def test_cast_torso_params_casts_the_jax_layers(weights):
    """``cast_torso_params`` casts exactly the parameters that JAX's
    ``cast_torso_params`` casts (``_TORSO_KERNEL_KEYS`` inside the blocks),
    mapped through the converter, and nothing on a float32 U-Net."""
    jm = junet.create_model(**UNET, use_bf16=True)
    cast = jm.cast_torso_params(jax.tree.map(jnp.asarray, weights))
    marks = jax.tree.map(lambda a: np.full(a.shape, a.dtype == jnp.bfloat16, np.float32), cast)
    model = _port(weights, use_bf16=True)
    want = {k for k, v in unet_state_dict_from_jax(marks, model).items() if bool(v.all())}
    assert want and model.cast_torso_params() is model
    got = {k for k, v in model.state_dict().items() if v.dtype == torch.bfloat16}
    assert got == want
    f32 = _port(weights).cast_torso_params()
    assert all(v.dtype == torch.float32 for v in f32.state_dict().values())


@pytest.mark.parametrize("flash", [False, True])
def test_cast_torso_params_is_bit_identical(weights, flash):
    """Pre-cast weights give the outputs of the cast at use, bit for bit."""
    x, ts, _ = _inputs()
    model = _port(weights, use_bf16=True, use_flash_attention=flash).eval()
    with torch.no_grad():
        before = model(t(x), torch.from_numpy(ts))
        after = model.cast_torso_params()(t(x), torch.from_numpy(ts))
    assert torch.equal(before, after)


# ---------------------------------------------------------------------------
# the SIREN-FiLM decode with compute_dtype bfloat16
# ---------------------------------------------------------------------------

def _decode_case(layers, hidden, points=300, seed=0):
    params, model = jax_siren(c_in=3, latent=16, c_out=3, layers=layers, hidden=hidden)
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (points, 3)).astype(np.float32)
    latents = (0.1 * rng.standard_normal((5, 16))).astype(np.float32)
    g = rng.standard_normal((5, points, 3)).astype(np.float32)
    return params, model, coords, latents, g


@pytest.mark.parametrize("layers,hidden", [(2, 32), (4, 64), (2, 96)])
def test_bf16_forward_plain_matches_pallas_interpret(layers, hidden):
    """``decode_forward_plain(..., bfloat16)`` on the folded operands against
    JAX's ``fused_siren_decode(..., compute_dtype=jnp.bfloat16)`` in
    interpret mode; the float32 forward is well outside the tolerance."""
    params, model, coords, latents, _ = _decode_case(layers, hidden)
    want = np.asarray(jsd.fused_siren_decode(params, coords, latents, 30.0, 2, 128, True,
                                             jnp.bfloat16))
    with torch.no_grad():
        w_first, w_mid, w_head, b_head, w2, b1, scale = tsd.stack_weights(model, model.w0)
        z = tsd.film_table(t(latents), w2, b1, scale)
        got = tsd.decode_forward_plain(t(coords), z, w_first, w_mid, w_head, b_head,
                                       torch.bfloat16)
        f32 = tsd.decode_forward_plain(t(coords), z, w_first, w_mid, w_head, b_head)
    assert got.shape == want.shape == (5, 300, 3)
    assert _rel(got.numpy(), want) <= DECODE_BF16_TOL
    assert _rel(f32.numpy(), want) > 2 * DECODE_BF16_TOL


def test_bf16_forward_plain_matches_pallas_interpret_above_1024():
    """Above the old bf16 limit of 1024: H = 1152 (six blocks of 192
    columns on the card), two modulated layers, 3 -> 5 on 2 rows x 64
    points: ``decode_forward_plain(..., bfloat16)``, the bf16 kernel's
    plain version, against JAX's bf16 ``_decode_kernel`` in interpret mode
    (tiles of 2 x 64), and the port's bf16 forward (``fused_siren_decode``
    on the CPU) with it."""
    params, model = jax_siren(c_in=3, latent=16, c_out=5, layers=1, hidden=1152)
    rng = np.random.default_rng(11)
    coords = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    latents = (0.1 * rng.standard_normal((2, 16))).astype(np.float32)
    want = np.asarray(jsd._fused_forward(params, jnp.asarray(coords), jnp.asarray(latents),
                                         30.0, 2, 64, True, jnp.bfloat16))
    with torch.no_grad():
        w_first, w_mid, w_head, b_head, w2, b1, scale = tsd.stack_weights(model, model.w0)
        z = tsd.film_table(t(latents), w2, b1, scale)
        got = tsd.decode_forward_plain(t(coords), z, w_first, w_mid, w_head, b_head,
                                       torch.bfloat16)
        fused = tsd.fused_siren_decode(model, t(coords), t(latents),
                                       compute_dtype=torch.bfloat16)
    assert tsd.kernel_hidden_width(1152, 3, 5, "forward_bf16") == 1152
    assert got.shape == want.shape == (2, 64, 5)
    assert _rel(got.numpy(), want) <= DECODE_BF16_TOL
    assert torch.equal(fused, got)


def test_bf16_padding_to_a_cluster_width_is_exact():
    """H = 1100 runs on the card at the bf16 plan's width, 1152 (six blocks
    of 192): through the padding function the plain bf16 forward equals the
    unpadded one up to the order of its float32 sums (the float32 forward
    padded moves 5e-8; in bf16 that flips a rounding now and then, so the
    bf16 forwards are held to ``DECODE_BF16_TOL``, measured 1e-5 to 9e-5,
    and the float32 one to 1e-6)."""
    params, model = jax_siren(c_in=3, latent=16, c_out=3, layers=2, hidden=1100)
    rng = np.random.default_rng(12)
    coords = t(rng.uniform(-1, 1, (48, 3)).astype(np.float32))
    latents = t((0.1 * rng.standard_normal((2, 16))).astype(np.float32))
    width = tsd.kernel_hidden_width(1100, 3, 3, "forward_bf16")
    assert width == tsd.cluster_plan(1100).width == 1152
    with torch.no_grad():
        w_first, w_mid, w_head, b_head, w2, b1, scale = tsd.stack_weights(model, model.w0)
        z = tsd.film_table(latents, w2, b1, scale)
        ops = (coords, z, w_first, w_mid, w_head, b_head)
        bf16 = functools.partial(tsd.decode_forward_plain, compute_dtype=torch.bfloat16)
        padded = tsd.padded_forward(bf16, *ops, width)
        torch.testing.assert_close(tsd.padded_forward(tsd.decode_forward_plain, *ops, width),
                                   tsd.decode_forward_plain(*ops), rtol=1e-6, atol=1e-6)
        plain = bf16(*ops)
    assert padded.shape == plain.shape == (2, 48, 3)
    assert _rel(padded.numpy(), plain.numpy()) <= DECODE_BF16_TOL


def test_bf16_frozen_decode_matches_jax():
    """The frozen op with ``compute_dtype`` bfloat16: its forward against
    JAX's bf16 frozen op (interpret mode), and dL/dlatents against JAX's
    (both the float32 dz kernel's arithmetic, as in JAX the backward ignores
    the compute dtype) at the dz tolerance of tests/test_torch_cnf.py; the
    gradient equals the float32 forward's bit for bit."""
    params, model, coords, latents, g = _decode_case(4, 64)

    def jloss(z):
        out = jsd.fused_siren_decode_frozen(params, coords, z, 30.0, 2, 128, True,
                                            jnp.bfloat16)
        return jnp.sum(out * g), out
    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(latents))
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        lat = t(latents).requires_grad_(True)
        out = tsd.fused_siren_decode_frozen(model, t(coords), lat, compute_dtype=dtype)
        (out * t(g)).sum().backward()
        grads[dtype] = lat.grad
        if dtype == torch.bfloat16:
            assert _rel(out.detach().numpy(), np.asarray(want)) <= DECODE_BF16_TOL
    np.testing.assert_allclose(grads[torch.bfloat16].numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(grads[torch.bfloat16], grads[torch.float32])
    assert all(p.grad is None for p in model.parameters())


def test_bf16_train_op_gradients_are_the_f32_backward():
    """The train op with ``compute_dtype`` bfloat16 runs the float32
    training backward: every gradient equals the float32 op's."""
    _, model, coords, latents, g = _decode_case(2, 32)
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        model.zero_grad()
        lat = t(latents).requires_grad_(True)
        (tsd.fused_siren_decode_train(model, t(coords), lat, compute_dtype=dtype)
         * t(g)).sum().backward()
        grads[dtype] = [lat.grad, *(p.grad.clone() for p in model.parameters())]
    assert all(torch.equal(a, b) for a, b in zip(*grads.values()))


def test_compute_dtype_is_checked_and_cpu_launches_nothing():
    _, model, coords, latents, _ = _decode_case(2, 32)
    tsd.reset_launch_counts()
    with pytest.raises(TypeError, match="compute_dtype"):
        tsd.fused_siren_decode(model, t(coords), t(latents), compute_dtype=torch.float16)
    tsd.fused_siren_decode(model, t(coords), t(latents), compute_dtype=torch.bfloat16)
    assert not any(tsd.LAUNCHES.values())
