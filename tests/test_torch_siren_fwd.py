"""The SIREN-FiLM decode forward's numeric scheme on the CPU.

The float32 CUDA forward (the cluster kernel of
``confild_tpu_torch/csrc/siren_fwd_cluster.cu``) runs every
hidden-by-hidden product on the tensor cores with a 3xTF32 split, as the
training backward's chain does (``csrc/siren_cluster.cuh``): each product
is a sum of zeroed partials, one per K-slice of 16 (two k8 steps) of the
hidden axis, carried by float32 adds in k order.  The first layer and the head stay in
float32 on the CUDA cores.  That arithmetic is emulated here on
``decode_forward_plain``'s layer walk (the chain's products from
``tests/test_torch_siren_bwd.py``, the TF32 products from
``tests/test_torch_flash.py``).

The emulation must meet ``|x - f64| <= 2 |plain f32 - f64| + 1e-6
max|f64|``, where the float64 truth is the same walk with exact sines
(``chip_smoke.py`` phase 3 holds the kernel to the same bound with the JAX
tests' absolute 1e-6 floor); with one TF32 product per matmul it must
miss.  It runs at the shipped recipes'
widths: Case4 (3 -> 384 x 16 modulated layers -> 3), Case2 (2 -> 256 x 11
-> 4), Case3 (2 -> 256 x 18 -> 2), and with one modulated layer (no middle
product); all at w0 30.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu.ops import siren_decode as jsd
from confild_tpu_torch.models.cnf import SirenFilm
from confild_tpu_torch.ops import siren_decode as tsd
from test_torch_flash import _mm_3xtf32, _mm_tf32
from test_torch_siren_bwd import _chain_mm, _np, _sin
from torch_parity_utils import f64_decode, jax_siren, limit_torch_threads, t

# SirenFilm widths of the shipped CNF recipes (recipes/cnf/*.yml): n_mod is
# num_hidden_layers + 1
WIDTHS = {
    "case4": dict(in_coord_features=3, in_latent_features=384, out_features=3,
                  num_hidden_layers=15, hidden_features=384),
    "case2": dict(in_coord_features=2, in_latent_features=256, out_features=4,
                  num_hidden_layers=10, hidden_features=256),
    "case3": dict(in_coord_features=2, in_latent_features=256, out_features=2,
                  num_hidden_layers=17, hidden_features=256),
    "one_layer": dict(in_coord_features=3, in_latent_features=64, out_features=3,
                      num_hidden_layers=0, hidden_features=128),
}
ROWS, POINTS = 2, 128


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _fwd_case(width, seed=0):
    """A seeded decoder at ``width`` (the init ``chip_smoke.py`` uses) and
    numpy-made coordinates and latents; the folded operands
    ``(coords, z, (w_first, w_mid, w_head, b_head))``."""
    cfg = WIDTHS[width]
    model = SirenFilm(**cfg, w0=30.0, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (POINTS, cfg["in_coord_features"])).astype(np.float32)
    latents = 0.1 * rng.standard_normal((ROWS, cfg["in_latent_features"]))
    with torch.no_grad():
        w_first, w_mid, w_head, b_head, w2, b1, scale = tsd.stack_weights(model, model.w0)
        z = tsd.film_table(t(latents), w2, b1, scale)
    return t(coords), z, (w_first, w_mid, w_head, b_head)


def _fwd_emulated(mm, coords, z, w_first, w_mid, w_head, b_head):
    """``decode_forward_plain``'s walk with the kernel's products: each
    middle product as the chain sums it (a zeroed partial per 16 of k),
    the first layer and the head in float32."""
    n_mod, rows, h = z.shape
    m = coords.shape[0]
    z, w_first, w_mid, w_head, b_head = map(_np, (z, w_first, w_mid, w_head, b_head))
    row = np.repeat(np.arange(rows), m)
    x = _sin(np.tile(_np(coords), (rows, 1)) @ w_first + z[0][row])
    for l in range(1, n_mod):
        x = _sin(_chain_mm(mm, x, w_mid[l - 1]) + z[l][row])
    return torch.from_numpy((x @ w_head + b_head).reshape(rows, m, -1))


def _fwd_f64(coords, z, w_first, w_mid, w_head, b_head):
    """The same walk in float64 with exact sines: the truth."""
    coords, z, w_first, w_mid, w_head, b_head = (
        x.double() for x in (coords, z, w_first, w_mid, w_head, b_head))
    x = torch.sin(2 * math.pi * ((coords @ w_first)[None] + z[0][:, None, :]))
    for l in range(1, z.shape[0]):
        x = torch.sin(2 * math.pi * (x @ w_mid[l - 1] + z[l][:, None, :]))
    return x @ w_head + b_head


def _margin(mm, width, seed=0):
    """error / limit of the emulated forward under the kernel's criterion."""
    coords, z, ops = _fwd_case(width, seed)
    with torch.no_grad():
        got = _fwd_emulated(mm, coords, z, *ops).double()
        plain = tsd.decode_forward_plain(coords, z, *ops).double()
        truth = _fwd_f64(coords, z, *ops)
    assert got.shape == truth.shape == (ROWS, POINTS, WIDTHS[width]["out_features"])
    limit = 2 * (plain - truth).abs().max() + 1e-6 * truth.abs().max()
    return ((got - truth).abs().max() / limit).item()


@pytest.mark.parametrize("width", list(WIDTHS))
def test_3xtf32_forward_meets_the_f32_criterion(width):
    """3xTF32 middle products with the kernel's partials keep the output
    within the criterion at every shipped width, and with no middle
    product at all."""
    margin = _margin(_mm_3xtf32, width)
    assert margin <= 1.0, margin


@pytest.mark.parametrize("width", ["case4", "case2", "case3"])
def test_single_tf32_forward_misses_the_f32_criterion(width):
    """One TF32 product per matmul is far outside it: the split is needed."""
    margin = _margin(_mm_tf32, width)
    assert margin > 10.0, margin


def test_emulation_follows_the_plain_version():
    """The emulation's walk is the plain version's: with exact float32
    products the two differ only by the order of the sums, which the
    16-layer w0 = 30 stack amplifies to about 1e-4 of the output."""
    coords, z, ops = _fwd_case("case4", seed=1)
    with torch.no_grad():
        got = _fwd_emulated(lambda a, b: a @ b, coords, z, *ops)
        plain = tsd.decode_forward_plain(coords, z, *ops)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-3,
                               atol=1e-4 * plain.abs().max().item())


def test_emulation_matches_pallas_interpret():
    """At a narrow width the 3xTF32 emulation on the weights carried across
    by ``io/convert.py`` against the JAX ``_fused_forward`` in interpret
    mode, on the same numpy inputs: both meet the float64 criterion and
    agree to the f32 round-off of three w0 = 30 layers."""
    params, model = jax_siren(c_in=3, latent=16, c_out=3, layers=2, hidden=64)
    rng = np.random.default_rng(3)
    coords = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    latents = (0.1 * rng.standard_normal((5, 16))).astype(np.float32)
    truth = f64_decode(params, coords, latents)
    jax_plain = np.asarray(jsd.siren_decode(params, coords, latents, use_pallas=False))
    pallas = np.asarray(jsd._fused_forward(params, jnp.asarray(coords), jnp.asarray(latents),
                                           30.0, 2, 128, True, jnp.float32))
    with torch.no_grad():
        w_first, w_mid, w_head, b_head, w2, b1, scale = tsd.stack_weights(model, model.w0)
        z = tsd.film_table(t(latents), w2, b1, scale)
        ours = _fwd_emulated(_mm_3xtf32, t(coords), z, w_first, w_mid, w_head, b_head).numpy()
    err = lambda a: np.abs(np.asarray(a, np.float64) - truth).max()
    bound = 2 * err(jax_plain) + 1e-6
    assert ours.shape == pallas.shape == (5, 300, 3)
    assert err(ours) <= bound and err(pallas) <= bound, (err(ours), err(pallas), bound)
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("hidden", [32, 96])
def test_hidden_padding_is_exact(hidden):
    """The CUDA wrappers zero-pad the hidden width to the kernels' width
    (the cluster plan's 128 here, for the float32 and bf16 forwards alike):
    through the padding functions the plain forward, dz and training
    backward equal the unpadded ones (1e-6), cotangents sliced back to
    ``H``."""
    _, model = jax_siren(c_in=3, latent=16, c_out=2, layers=2, hidden=hidden)
    rng = np.random.default_rng(7)
    coords = t(rng.uniform(-1, 1, (200, 3)))
    latents = t(0.1 * rng.standard_normal((3, 16)))
    g = t(rng.standard_normal((3, 200, 2)))
    with torch.no_grad():
        w_first, w_mid, w_head, b_head, w2, b1, scale = tsd.stack_weights(model, model.w0)
        z = tsd.film_table(latents, w2, b1, scale)
        width = tsd.kernel_hidden_width(hidden, 3, 2, "forward")
        assert width == tsd.cluster_plan(hidden).width == 128
        assert tsd.kernel_hidden_width(hidden, 3, 2, "forward_bf16") == 128
        close = dict(rtol=1e-6, atol=1e-6)
        for dtype in (torch.float32, torch.bfloat16):
            torch.testing.assert_close(
                tsd.padded_forward(functools.partial(tsd.decode_forward_plain,
                                                     compute_dtype=dtype),
                                   coords, z, w_first, w_mid, w_head, b_head, width),
                tsd.decode_forward_plain(coords, z, w_first, w_mid, w_head, b_head, dtype),
                **close)
        ops = (coords, z, g, w_first, w_mid, w_head)
        dz = tsd.padded_dz(tsd.decode_dz_plain, *ops, width)
        assert dz.shape == z.shape
        torch.testing.assert_close(dz, tsd.decode_dz_plain(*ops), **close)
        for a, b in zip(tsd.padded_bwd(tsd.decode_bwd_plain, *ops, width),
                        tsd.decode_bwd_plain(*ops)):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, **close)


def test_kernel_width_limits():
    """Each kernel family's widths: every family (the float32 and bf16
    forwards, dz and the training backward) runs at the cluster plan's
    width up to 3072 (up to 512 one of 128, 192, 256, 384 and 512), at any
    number of coordinates and outputs (the tables take them in chunks of
    ``FEATURE_CHUNK``); past the width limit the error names the
    family."""
    narrow = (1, 64, 65, 129, 193, 257, 384, 385, 400, 448, 449, 500, 512)
    assert set(tsd.CLUSTER_FAMILIES) == set(tsd.FAMILIES)
    for family in tsd.CLUSTER_FAMILIES:
        assert [tsd.kernel_hidden_width(h, 3, 3, family) for h in narrow] \
            == [128, 128, 128, 192, 256, 384, 384, 512, 512, 512, 512, 512, 512]
    for family in ("forward", "forward_bf16", "dz", "bwd"):
        assert [tsd.kernel_hidden_width(h, 3, 3, family)
                for h in (513, 576, 600, 640, 1000, 1024, 1025, 2048, 2049, 3072)] \
            == [576, 576, 640, 640, 1024, 1024, 1152, 2048, 2304, 3072]
        assert tsd.kernel_hidden_width(3072, 16, 16, family) == 3072
        for args in ((3073, 3, 3), (4096, 2, 2)):
            with pytest.raises(ValueError, match=f"{tsd.FAMILIES[family]} kernel takes a hidden "
                                                 f"width of at most 3072"):
                tsd.kernel_hidden_width(*args, family)
        assert tsd.kernel_hidden_width(2048, 17, 3, family) == 2048
        assert tsd.kernel_hidden_width(1024, 3, 17, family) == 1024
    assert tsd.MAX_HIDDEN == {"forward": 3072, "forward_bf16": 3072, "dz": 3072, "bwd": 3072}
    assert tsd.FEATURE_CHUNK == 16
