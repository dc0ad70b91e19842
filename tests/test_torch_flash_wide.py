"""Port vs JAX package for flash attention at head widths above 128 on the
CPU: the port's autograd function (its plain versions, which the CUDA
column-group kernels repeat) against the JAX Pallas kernels in interpret
mode at D = 160, 256 and 512 on a ragged N, in float32 and bf16; the
padding to a multiple of 128; the column-group kernels' plans, chunk images
and group images; their 3xTF32 scheme against float64; and a U-Net and a
super-resolution model built with the JAX package's default head rule
(``num_heads=1``: one head of all a block's channels) with flash on,
against the JAX package's."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu.models import unet as junet
from confild_tpu.models import unet_extras as jextras
from confild_tpu.ops import flash_attention as jfa
from confild_tpu_torch.io.convert import unet_state_dict_from_jax
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.models import unet_extras as textras
from confild_tpu_torch.ops import flash_attention as tfa
from test_torch_flash import (FWD_TOL, GRAD_TOL, _forward_margins, _inputs, _jax_grads,
                              _port_grads, _scheme_margins)
from torch_parity_utils import limit_torch_threads, perturbed, t

# bf16 in and out, float32 softmax: the tolerances test_torch_flash.py's
# test_bf16_inputs holds the port's bf16 route to against the JAX kernel
BF16_OUT_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_GRAD_TOL = dict(rtol=5e-2, atol=5e-2)
# the U-Net and the super-resolution model in float32: convolutions and
# GroupNorm sum in other orders (tests/test_torch_unet.py's tolerance); a
# parameter's gradient sums over every position and batch row in other
# orders, so it is held relative to its largest entry
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


@pytest.mark.parametrize("d", [160, 256, 512])
def test_wide_forward_and_lse_match_jax(d):
    """Output and saved logsumexp against the JAX kernels, ragged N = 300."""
    q, k, v = _inputs(2, 300, d, seed=d, count=3)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out, want_lse = jfa._flash_forward(jq, jk, jv, 128, 128, True)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_out), **FWD_TOL)
    _, lse = tfa.flash_forward_plain(*map(torch.from_numpy, (q, k, v)))
    assert lse.shape == (2, 300)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)


@pytest.mark.parametrize("d", [160, 256, 512])
def test_wide_gradients_match_jax(d):
    """dQ, dK, dV through the port's autograd function against the JAX
    Pallas backward, ragged N = 300."""
    q, k, v, w = _inputs(2, 300, d, seed=d + 1)
    _, got = _port_grads(q, k, v, w)
    want = _jax_grads(q, k, v, w)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("d", [160, 256, 512])
def test_wide_bf16_matches_jax(d):
    """bf16 in, bf16 out and bf16 gradients against the JAX kernels on the
    same bf16 inputs, ragged N = 300; lse in float32."""
    q, k, v, w = _inputs(2, 300, d, seed=d + 2)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want_out, want_lse = jfa._flash_forward(*jb, 128, 128, True)
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v, 128, 128, True)
                                            .astype(jnp.float32) * w), argnums=(0, 1, 2))(*jb)
    tb = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in jb]
    _, lse = tfa.flash_forward_plain(*tb)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)
    leaves = [x.clone().requires_grad_(True) for x in tb]
    out = tfa.flash_attention(*leaves)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(), np.asarray(want_out, np.float32),
                               **BF16_OUT_TOL)
    (out.float() * torch.from_numpy(w)).sum().backward()
    for x, b, name in zip(leaves, want, "qkv"):
        assert x.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(b, np.float32),
                                   err_msg=f"d{name}", **BF16_GRAD_TOL)


@pytest.mark.parametrize("d", [160, 200, 300])
def test_wide_padding_is_exact(d):
    """A head above 128 is zero-padded to the next multiple of 128 and the
    outputs sliced back: the plain versions through the padding functions
    equal the plain versions at the true width (1e-6), with the logits at
    the true width's scale."""
    width = tfa.kernel_head_width(d)
    assert width % tfa.WIDE_GROUP == 0 and d <= width < d + tfa.WIDE_GROUP
    q, k, v, g = map(torch.from_numpy, _inputs(2, 96, d, seed=9))
    out, lse = tfa.flash_forward_plain(q, k, v)
    p_out, p_lse = tfa.padded_forward(tfa.flash_forward_plain, q, k, v)
    assert p_out.shape == out.shape == (2, 96, d)
    torch.testing.assert_close(p_out, out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(p_lse, lse, rtol=1e-6, atol=1e-6)
    want = tfa.flash_backward_plain(q, k, v, out, lse, g)
    got = tfa.padded_backward(tfa.flash_backward_plain, q, k, v, out, lse, g)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, 96, d)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_wide_launch_counts_untouched_on_cpu():
    """CPU tensors take the plain versions above 128 too: no launch counted."""
    tfa.reset_launch_counts()
    q, k, v, w = _inputs(1, 64, 256, seed=5)
    _port_grads(q, k, v, w)
    assert tfa.LAUNCHES_WIDE == {}
    assert not any(tfa.LAUNCHES.values())


@pytest.mark.parametrize("d", [48, 160, 200])
def test_wide_operand_checks(d):
    """The kernels take 32, 64 or a multiple of 128; the wrappers pad any
    other width first, and the checks refuse it."""
    x = torch.zeros(2, 16, d)
    with pytest.raises(ValueError, match="head width"):
        tfa._check(x, q=x, k=x, v=x)
    with pytest.raises(ValueError, match="head width"):
        tfa._launch_forward(x, x, x, None)


# the column-group plans above 128, as csrc/flash_attention.cu's note states
# them: (tile, image stages, bytes) of the forward, dq and dk/dv (bf16's
# backward above 512 only: at TMA_WIDTHS it is the TMA backward's,
# TMA_BWD_PLANS)
WIDE_PLANS = {torch.float32: ((64, 3, 196784), (64, 3, 196784), (32, 4, 197824)),
              torch.bfloat16: ((64, 4, 131264), (64, 4, 131264), (64, 4, 133312))}
# the bf16 TMA backward's plan at 256, 384 and 512, both passes, as the note
# states it: (rows a block, consumer warpgroups, streamed rows a tile,
# stages, bytes, output columns a warpgroup)
TMA_BWD_PLANS = {256: (128, 2, 32, 3, 230456, 256), 384: (64, 2, 32, 2, 197672, 192),
                 512: (64, 2, 16, 3, 230456, 256)}
# the float32 forward with Q resident's (keys, image stages, bytes) at 256,
# 384 and 512, as the note states them
RESIDENT_PLANS = {256: (32, 6, 165088), 384: (32, 6, 197856), 512: (32, 6, 230624)}
# the bf16 TMA forward's (keys, stages, bytes, output columns a block) at
# 256, 384 and 512, as the note states them
TMA_PLANS = {256: (64, 2, 197672, 256), 384: (64, 2, 230440, 128), 512: (32, 2, 230440, 256)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_plans(dtype):
    """One plan a pass and type above 128, whatever the width (d is an
    argument of the kernels): it fits a block's shared memory with at least
    two image stages, no raw stage, one consumer warpgroup of 64 rows,
    whole k16 steps a tile and whole 16-byte chunks a producer thread in
    every image; the plans the kernels' note states.  The bf16 forward at
    ``TMA_WIDTHS`` has the TMA forward's plan instead (its own test), and
    the float32 forward up to ``RESIDENT_MAX`` the plan with Q resident
    (32-key tiles, six stages, Q's rows after them), and the bf16 backward
    at ``TMA_WIDTHS`` the TMA backward's (``test_tma_backward_plans``)."""
    size = 4 if dtype == torch.float32 else 2
    fwd, dq, dkv = WIDE_PLANS[dtype]
    for d in (256, 384, 512, 1024):
        plan = tfa.forward_plan(d, dtype)
        if dtype == torch.bfloat16 and d in tfa.TMA_WIDTHS:
            assert (plan["keys"], plan["raw_stages"], plan["smem"]) == TMA_PLANS[d][:3]
        elif dtype == torch.float32 and d <= tfa.RESIDENT_MAX:
            assert (plan["keys"], plan["image_stages"], plan["smem"]) == RESIDENT_PLANS[d]
            assert plan["raw_stages"] == 0 and plan["smem"] <= tfa.FWD_SMEM_LIMIT
        else:
            assert tfa.forward_columns(d, dtype) == tfa.WIDE_GROUP
            assert (plan["keys"], plan["image_stages"], plan["smem"]) == fwd
            assert plan["raw_stages"] == 0
        for kernel, want in zip(tfa.BWD_KERNELS, (dq, dkv)):
            plan = tfa.backward_plan(d, dtype, kernel)
            if dtype == torch.bfloat16 and d in tfa.TMA_WIDTHS:
                rows, c, tile, ns, smem, _ = TMA_BWD_PLANS[d]
                assert tuple(plan.values()) == (rows, c, tile, ns, 0, smem)
                continue
            assert (plan["rows"], plan["consumers"], plan["raw_stages"]) == (64, 1, 0)
            assert (plan["tile"], plan["image_stages"], plan["smem"]) == want
    for tile, stages, smem in (fwd, dq, dkv):
        assert smem <= tfa.FWD_SMEM_LIMIT and 2 <= stages <= tfa.WIDE_MAX_STAGES
        assert tile % 16 == 0
        cpr = tfa.wide_chunk(dtype) * size // 16              # 16-byte chunks a row
        for rows in (tfa.WIDE_ROWS, tile):                     # the chunk images
            assert rows * cpr % 128 == 0
            # the producer's map of its threads' loads onto the image's chunks
            cover = {(u % rows, (u // rows + u % rows) % cpr) for u in range(rows * cpr)}
            assert len(cover) == rows * cpr
        assert tfa.WIDE_GROUP * tile // (4 if size == 4 else 16) % 128 == 0   # the group image


@pytest.mark.parametrize("d", [256, 384, 512])
def test_tma_forward_plans(d):
    """The bf16 TMA forward's plan at each of its widths: Q's 128 rows
    resident, two stages or more of K's tile and V's group of
    ``forward_columns`` columns beside them (64 keys where two fit, else
    32), within a block's shared memory with the 1024 bytes the swizzle's
    alignment may take, and whole k16 steps and 64-column slabs; the
    widths above take the column-group kernel, and float32 always."""
    plan, gw = tfa.forward_plan(d, torch.bfloat16), tfa.forward_columns(d, torch.bfloat16)
    kt, ns, smem = plan["keys"], plan["raw_stages"], plan["smem"]
    assert (kt, ns, smem, gw) == TMA_PLANS[d] and plan["image_stages"] == 0
    stage = kt * (d + gw) * 2
    assert smem == 1024 + 128 * d * 2 + 8 + ns * (stage + 16) <= tfa.FWD_SMEM_LIMIT
    assert ns >= 2 and kt % 16 == 0 and d % 64 == 0 and gw % 64 == 0 and d % gw == 0
    # a stage's slabs and Q's start on the swizzle's 1024-byte atoms
    assert all(x % 1024 == 0 for x in (128 * d * 2, stage, kt * 128, kt * d * 2))
    if kt == 32:   # 64 keys would leave one stage
        assert 1024 + 128 * d * 2 + 8 + 2 * (64 * (d + gw) * 2 + 16) > tfa.FWD_SMEM_LIMIT
    assert tfa.forward_columns(d, torch.float32) == gw
    for wider in (640, 768, 1024):
        assert tfa.forward_plan(wider, torch.bfloat16)["image_stages"] > 0
        assert tfa.forward_columns(wider, torch.bfloat16) == tfa.WIDE_GROUP


@pytest.mark.parametrize("d", [256, 384, 512])
def test_tma_backward_plans(d):
    """The bf16 TMA backward's plan at each of its widths, one for dq and
    dk/dv: two consumer warpgroups, of 64 rows each where both resident
    operands' 128 rows fit beside two stages of 32 streamed rows, else both
    on the same 64 rows, each with its own group; the streamed tile
    the most of 64, 32 and 16 rows that leaves two stages; within a block's
    shared memory with the swizzle's 1024-byte alignment slack; every slab
    on a 1024-byte atom; output columns in whole 64-column slabs (groups of
    192 at 384, whose products beat groups of 128 and the column-group
    pair's); bf16 at 640, 768 and 1024 and float32 everywhere keep the
    column-group plan."""
    rows, c, tile, ns, smem, gw = TMA_BWD_PLANS[d]
    for kernel in tfa.BWD_KERNELS:
        plan = tfa.backward_plan(d, torch.bfloat16, kernel)
        assert tuple(plan.values()) == (rows, c, tile, ns, 0, smem)
    assert tfa.backward_columns(d, torch.bfloat16) == gw and d % gw == 0 and gw % 64 == 0
    row = 2 * d * 2                                   # a row of both operands
    assert smem == 1024 + rows * row + 8 + ns * (tile * row + 16) <= tfa.FWD_SMEM_LIMIT
    assert ns >= 2 and c == 2 and tile % 16 == 0
    two = 1024 + 8 + 128 * row + 2 * (32 * row + 16) <= tfa.FWD_SMEM_LIMIT
    assert rows == (128 if two else 64)
    # a block's warpgroups: two row blocks of one group, or two groups
    assert (rows // 64) * (1 if two else 2) == c and (two or (d // gw) % 2 == 0)
    if tile < 64:   # the next larger tile would leave one stage
        assert 1024 + rows * row + 8 + 2 * (2 * tile * row + 16) > tfa.FWD_SMEM_LIMIT
    assert all(x % 1024 == 0 for x in (rows * 128, tile * 128, rows * row, tile * row))
    # the split dk/dv's products over the least: below the column-group pair's
    groups = d // gw
    assert tfa.backward_products(d, torch.bfloat16) == pytest.approx((5 * groups + 3) / 7)
    assert tfa.backward_products(d, torch.bfloat16) < tfa.backward_products(d, torch.float32)
    for wider in (640, 768, 1024):
        assert tfa.backward_plan(wider, torch.bfloat16, "dq")["image_stages"] > 0
        assert tfa.backward_columns(wider, torch.bfloat16) == tfa.WIDE_GROUP
    assert tfa.backward_plan(d, torch.float32, "dkv")["image_stages"] > 0
    assert tfa.backward_columns(d, torch.float32) == tfa.WIDE_GROUP


def _swizzle(addr):
    """The 128-byte swizzle of a shared-memory byte address: its 16-byte
    chunk within a 128-byte row XORed with the row's index within its
    1024-byte atom (address bits 4-6 with bits 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_store(smem, base, x):
    """TMA's copies of a (rows, d) bf16 matrix into d / 64 slabs at ``base``
    (1024-byte aligned), each ``rows`` rows x 128 bytes: element (r, c) of
    slab c // 64 at byte r * 128 + 2 (c % 64) of the slab, swizzled
    (``smem`` holds a value a bf16 slot, indexed by byte address / 2)."""
    rows, d = x.shape
    r, c = np.meshgrid(np.arange(rows), np.arange(d), indexing="ij")
    addr = base + (c // 64) * rows * 128 + r * 128 + 2 * (c % 64)
    smem[_swizzle(addr) // 2] = x


def _kmajor(smem, start, m, sbo=1024):
    """A K-major wgmma operand of m rows x one k16 step through a
    128-byte-swizzle descriptor at ``start`` (lbo unused): element (i, k) at
    start + (i / 8) sbo + (i % 8) 128 + 2 k, swizzled."""
    i, k = np.meshgrid(np.arange(m), np.arange(16), indexing="ij")
    return smem[_swizzle(start + (i // 8) * sbo + (i % 8) * 128 + 2 * k) // 2]


def _mnmajor(smem, start, n, lbo, sbo=1024):
    """An MN-major wgmma B operand of one k16 step x n columns through the
    transpose bit: element (k, j) at start + (j / 64) lbo + (k / 8) sbo +
    (k % 8) 128 + 2 (j % 64), swizzled."""
    k, j = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    return smem[_swizzle(start + (j // 64) * lbo + (k // 8) * sbo + (k % 8) * 128
                         + 2 * (j % 64)) // 2]


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("d", [256, 384, 512])
def test_tma_backward_swizzle_gives_back_products(d, kernel):
    """The one check of the TMA backward's descriptors without the card: a
    numpy model of the 128-byte swizzle TMA writes (the resident operands'
    slabs of the plan's rows, a stage's two operands' slabs of its tile),
    read back as ``wgmma`` reads it, K-major with sbo 1024 and a k16 step
    the next 32 bytes of a row (``tma::s_product``), and MN-major through
    the transpose bit with lbo the slab stride (tile x 128) and sbo 1024, a
    k16 step 2048 bytes on (``tma::pv_product``), from its group's first
    slab; on small seeded integer tiles it gives back, exactly, dq's S = Q
    K^T, dP = dO V^T and dQ_g += dS K_g, or dk/dv's S^T = K Q^T, dP^T = V
    dO^T, dV_g += P^T dO_g and dK_g += dS^T Q_g, for each consumer
    warpgroup's 64 rows (its own where a block holds 128, the block's with
    its own group where it holds 64) and each group of the head."""
    plan = tfa.backward_plan(d, torch.bfloat16, kernel)
    rows, tile, gw = plan["rows"], plan["tile"], tfa.backward_columns(d, torch.bfloat16)
    rng = np.random.default_rng(d + len(kernel))
    res_a, res_b = (rng.integers(-4, 5, (rows, d)).astype(np.float64) for _ in range(2))
    st_a, st_b = (rng.integers(-4, 5, (tile, d)).astype(np.float64) for _ in range(2))
    res_bytes, stage = rows * d * 2 * 2, 1024 + rows * d * 4   # the stage after the residents
    smem = np.full((stage + tile * d * 4) // 2, np.nan)
    _tma_store(smem, 1024, res_a)                         # Q (dq) or K (dk/dv)
    _tma_store(smem, 1024 + res_bytes // 2, res_b)         # dO or V
    _tma_store(smem, stage, st_a)                          # K or Q
    _tma_store(smem, stage + tile * d * 2, st_b)           # V or dO
    for wg, grp in itertools.product(range(rows // 64), range(d // gw)):
        group = grp * (gw // 64) * tile * 128                  # the group's first slab
        cols = slice(grp * gw, (grp + 1) * gw)
        a_rows = slice(64 * wg, 64 * wg + 64)

        def over_head(res_start, st_start):   # tma::s_product<D, ST, ROWS>
            acc = np.zeros((64, tile))
            for c in range(d // 64):
                for j in range(4):
                    a = _kmajor(smem, res_start + wg * 64 * 128 + c * rows * 128 + 32 * j, 64)
                    b = _kmajor(smem, st_start + c * tile * 128 + 32 * j, tile)
                    acc += a @ b.T
            return acc

        def into_group(x, st_start):   # tma::pv_product<GW, ST>
            acc = np.zeros((64, gw))
            for c in range(tile // 16):
                b = _mnmajor(smem, st_start + group + c * 16 * 128, gw, tile * 128)
                acc += x[:, 16 * c:16 * c + 16] @ b
            return acc
        np.testing.assert_array_equal(over_head(1024, stage), res_a[a_rows] @ st_a.T)
        np.testing.assert_array_equal(over_head(1024 + res_bytes // 2, stage + tile * d * 2),
                                      res_b[a_rows] @ st_b.T)
        x = rng.integers(-4, 5, (64, tile)).astype(np.float64)   # dS; P^T or dS^T
        if kernel == "dq":   # dQ_g += dS K_g
            np.testing.assert_array_equal(into_group(x, stage), x @ st_a[:, cols])
        else:                # dV_g += P^T dO_g, dK_g += dS^T Q_g
            np.testing.assert_array_equal(into_group(x, stage + tile * d * 2), x @ st_b[:, cols])
            np.testing.assert_array_equal(into_group(x, stage), x @ st_a[:, cols])


def _read_kmajor(image, rows, kdim, halves, size):
    """An image of ``rows`` rows and ``kdim`` columns read back as wgmma
    reads a K-major operand through ``b_desc``: a k-step block (k8 TF32 or
    k16 bf16, two 16-byte chunks along K) of rows x 32 bytes a half, core
    matrices of 8 rows x 16 bytes, the two of a step 128 bytes apart,
    8-row groups 256 bytes apart; the big half only."""
    epc = 16 // size
    out = np.zeros((rows, kdim))
    for step in range(kdim // (2 * epc)):
        block = step * rows * 32 * halves
        for kappa in range(2 * epc):
            for r in range(rows):
                off = block + (r >> 3) * 256 + (kappa // epc) * 128 + (r & 7) * 16
                out[r, 2 * epc * step + kappa] = image[off // size + kappa % epc]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_wide_chunk_images_give_back_products(dtype, kernel):
    """The chunk items: chunk c of a head holds its columns wc .. wc + w - 1
    (w = ``wide_chunk``: 64 in float32, 128 in bf16) of the block's 64
    resident rows and of the tile's rows, each at
    ``image_offset`` of its 16-byte chunk within the chunk's columns; read
    back as ``ss_product``'s descriptors read them, the products of the
    head's chunks add up to the resident rows times the tile's, transposed,
    exactly; each image holds every (row, column) of its chunk once.  The
    group item (the tile's rows transposed, one group of 128 columns) is
    ``test_torch_flash.py``'s transposed image at D = 128."""
    f32 = dtype == torch.float32
    size, halves = (4, 2) if f32 else (2, 1)
    epc = 16 // size
    d = 384
    tile = (tfa.forward_plan(d, dtype)["keys"] if kernel == "fwd"
            else tfa.backward_plan(d, dtype, kernel)["tile"])
    rng = np.random.default_rng(tile + size)
    a = rng.integers(-8, 8, (tfa.WIDE_ROWS, d)).astype(np.float64)
    b = rng.integers(-8, 8, (tile, d)).astype(np.float64)
    w = tfa.wide_chunk(dtype)
    got = np.zeros((tfa.WIDE_ROWS, tile))
    for c in range(d // w):
        images = []
        for x in (a, b):
            rows = x.shape[0]
            image = {}
            for r in range(rows):
                for col in range(w):
                    slot = tfa.image_offset(r, col // epc, rows, halves) // size + col % epc
                    assert slot not in image
                    image[slot] = x[r, c * w + col]
            assert len(image) == rows * w
            images.append(_read_kmajor(image, rows, w, halves, size))
        got += images[0] @ images[1].T
    np.testing.assert_array_equal(got, a @ b.T)


@pytest.mark.parametrize("bh,n,d", [(2, 200, 256)])
def test_wide_3xtf32_forward_meets_the_f32_criterion(bh, n, d):
    """The column-group forward's arithmetic (S over the head, its partial
    carried every k16 step, which chunks of whole k16 steps leave as it is; tiles
    of 64 keys, a ragged last one at N = 200; the output rescaled by alpha,
    then the tile's P V partial added) keeps out and lse within the
    criterion the CUDA kernel is held to on the card."""
    margins = _forward_margins(True, bh, n, d, seed=17, rescale_first=True)
    assert max(margins) <= 1.0, margins


@pytest.mark.parametrize("bh,n,d", [(2, 200, 256)])
def test_wide_3xtf32_backward_meets_the_f32_criterion(bh, n, d):
    """The column-group backward's arithmetic (``backward_plan``'s tiles
    above 128: 64 keys in dq, 32 queries in float32 dk/dv; S and dP over the
    head with a partial a k16 step; the group's products one partial a
    tile) keeps dq, dk, dv within the criterion the CUDA kernels are held
    to on the card."""
    margins = _scheme_margins(True, bh, n, d, seed=16)
    assert max(margins) <= 1.0, margins


def _grads_match(jgrads, model, tgrads):
    """Every parameter gradient of the port against JAX's, converted to the
    port's layout as the weights are, relative to its largest entry."""
    want = unet_state_dict_from_jax(jgrads, model)
    assert set(want) == set(tgrads)
    for name, g in tgrads.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0, atol=PARAM_GRAD_TOL,
                                   err_msg=name)


def _wide_heads(plan_blocks):
    return [s.ch // s.num_heads for block in plan_blocks for s in block
            if isinstance(s, tunet.AttnSpec)]


def test_unet_one_head_flash_matches_jax():
    """``create_model``'s JAX defaults (``num_heads=1``,
    ``num_head_channels=-1``) with flash on: every attention block is one
    head of all its channels, 256 here (model_channels 64, channel_mult
    1,4), against the JAX U-Net with flash on (its Pallas kernels in
    interpret mode): the output, the input's gradient and every parameter's
    gradient of ``sum(out * w)``."""
    kw = dict(image_size=8, num_channels=64, num_res_blocks=1, channel_mult="1,4",
              attention_resolutions="2", num_heads=1, num_head_channels=-1,
              use_flash_attention=True)
    jm = junet.create_model(**kw)
    params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.key(0))),
                       np.random.default_rng(1))
    tm = tunet.create_model(**kw)
    tm.load_state_dict(unet_state_dict_from_jax(params, tm))
    plan = tm.plan
    heads = _wide_heads((*plan.input_blocks, plan.middle_block, *plan.output_blocks))
    assert heads and all(h == 256 for h in heads)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, 8, 8)).astype(np.float32)
    ts = np.array([3, 700])
    w = rng.standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jm.apply(p, xx, jnp.asarray(ts)) * w)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(ts)))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(ts))
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **MODEL_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **MODEL_TOL)
    _grads_match(jax.tree.map(np.asarray, jgp), tm,
                 {n: p.grad for n, p in tm.named_parameters()})


def test_sr_model_flash_matches_jax():
    """``create_sr_model`` at a small size with its JAX defaults (one head a
    block) and flash on through ``dataclasses.replace`` on both sides:
    heads of 128 and 256 channels (``attention_resolutions`` 8,4: at ds 2
    and 4, and the middle block); the output, the input's gradient and
    every parameter's."""
    jsr = jextras.create_sr_model(16, 8, 64, 1, attention_resolutions="8,4")
    tsr = textras.create_sr_model(16, 8, 64, 1, attention_resolutions="8,4")
    # the model doubles its config's in_channels (the low-resolution input)
    jm, tm = (m.SuperResModel(dataclasses.replace(sr.cfg, use_flash_attention=True,
                                                  in_channels=sr.cfg.in_channels // 2))
              for m, sr in ((jextras, jsr), (textras, tsr)))
    params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.key(0))),
                       np.random.default_rng(3))
    tm.load_state_dict(unet_state_dict_from_jax(params, tm))
    plan = tm.plan
    heads = _wide_heads((*plan.input_blocks, plan.middle_block, *plan.output_blocks))
    assert 256 in heads and all(tm.cfg.use_flash_attention for _ in heads)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 16, 16)).astype(np.float32)
    low = rng.standard_normal((2, 1, 8, 8)).astype(np.float32)
    ts = np.array([0, 5])
    w = rng.standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jm.apply(p, xx, jnp.asarray(ts), low_res=jnp.asarray(low)) * w)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(ts),
                               low_res=jnp.asarray(low)))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(ts), low_res=t(low))
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **MODEL_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **MODEL_TOL)
    _grads_match(jax.tree.map(np.asarray, jgp), tm,
                 {n: p.grad for n, p in tm.named_parameters()})


@pytest.mark.parametrize("mangled,label", [
    ("_ZN12_GLOBAL__N_121flash_fwd_wide_kernelILi128EfEEvPKT0_S3_S3_PS1_Pfiif",
     "flash_fwd_wide_kernel<128, f32>"),
    ("_ZN12_GLOBAL__N_124flash_bwd_dq_wide_kernelILi128E13__nv_bfloat16EEvPKT0_S4_S4_S4_PKfS6_"
     "PS2_iif", "flash_bwd_dq_wide_kernel<128, bf16>"),
    ("_ZN12_GLOBAL__N_125flash_bwd_dkv_wide_kernelILi128EfEEvPKT0_S3_S3_S3_PKfS5_PS1_S6_iif",
     "flash_bwd_dkv_wide_kernel<128, f32>"),
])
def test_build_report_names_the_column_group_kernels(mangled, label):
    """``chip_smoke.py`` phase 2 finds each column-group instantiation in
    ptxas's and cuobjdump's reports by these labels, and counts it among
    the kernels that must run on wgmma only."""
    import chip_smoke as cs
    assert cs.kernel_label(f"ptxas info    : Function properties for {mangled}") == label
    assert label in {cs.flash_wide_label(k, dt) for k in cs.FLASH_WIDE_KERNELS
                     for dt in (torch.float32, torch.bfloat16)}
    assert label.startswith(cs.WGMMA_KERNELS)


@pytest.mark.parametrize("mangled,label", [
    ("_ZN12_GLOBAL__N_123flash_bwd_dq_tma_kernelILi256E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_"
     "S2_PKfS4_PT0_if", "flash_bwd_dq_tma_kernel<256, bf16>"),
    ("_ZN12_GLOBAL__N_124flash_bwd_dkv_tma_kernelILi512E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_"
     "S2_PKfS4_PT0_S6_if", "flash_bwd_dkv_tma_kernel<512, bf16>"),
])
def test_build_report_names_the_tma_backward_kernels(mangled, label):
    """``chip_smoke.py`` phase 2 finds each bf16 TMA backward instantiation
    by these labels, among those it requires at ``TMA_WIDTHS`` and counts
    among the kernels that must run on wgmma only."""
    import chip_smoke as cs
    assert cs.kernel_label(f"ptxas info    : Function properties for {mangled}") == label
    assert label in {cs.flash_tma_label(d, k) for d in tfa.TMA_WIDTHS for k in tfa.BWD_KERNELS}
    assert label.startswith(cs.WGMMA_KERNELS)
    d = int(label.split("<")[1].split(",")[0])
    assert cs.wide_factors(d, torch.bfloat16)[1] == tfa.backward_products(d, torch.bfloat16)
