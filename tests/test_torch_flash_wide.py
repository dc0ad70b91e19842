"""Port vs JAX package for flash attention at head widths above 128 on the
CPU: the port's autograd function (its plain versions, which the CUDA
kernels above 128 repeat) against the JAX Pallas kernels in interpret
mode at D = 160, 256, 384 and 512 on a ragged N, in float32 and bf16; the
padding to a multiple of 128; the column-group kernels' plans, chunk images
and group images; the TMA backward's swizzle and the float32 backward's
items and register fragments (resident raw rows); their 3xTF32 scheme
against float64; and a U-Net and a super-resolution model built with the
JAX package's default head rule (``num_heads=1``: one head of all a
block's channels) with flash on, against the JAX package's."""

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
                              _port_grads, _register_order, _rna_tf32, _scheme_margins)
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


@pytest.mark.parametrize("d", [160, 256, 384, 512])
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
# them: (tile, image stages, bytes) of the forward, dq and dk/dv (the
# backward above 512 only: at TMA_WIDTHS it is the bf16 TMA backward's,
# TMA_BWD_PLANS, or the float32 backward's with the resident rows,
# RESIDENT_BWD_PLANS)
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
# the float32 backward with the resident rows at 256, 384 and 512, both
# passes, as the note states it: (rows a block, consumer warpgroups,
# streamed rows a tile, item stages, bytes, output columns a block)
RESIDENT_BWD_PLANS = {256: (64, 2, 32, 5, 231664, 256), 384: (64, 2, 32, 7, 230672, 192),
                      512: (64, 2, 32, 5, 230640, 256)}
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
    (32-key tiles, six stages, Q's rows after them), and the backward at
    ``TMA_WIDTHS`` the bf16 TMA backward's (``test_tma_backward_plans``) or
    the float32 one's with the resident rows
    (``test_resident_backward_plans``)."""
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
            if d in tfa.TMA_WIDTHS:   # float32: the pair with the resident rows
                rows, c, tile, ni, smem, _ = RESIDENT_BWD_PLANS[d]
                assert tuple(plan.values()) == (rows, c, tile, 0, ni, smem)
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
    pair's); bf16 at 640, 768 and 1024 keeps the column-group plan, and
    float32 has its own plan (``test_resident_backward_plans``) with the
    same output columns."""
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
    # the split dk/dv's products over the least: below the column-group
    # pair's at the same width (groups of 128, S and dP in every group)
    groups = d // gw
    assert tfa.backward_products(d, torch.bfloat16) == pytest.approx((5 * groups + 3) / 7)
    assert tfa.backward_products(d, torch.bfloat16) < (8 * (d // tfa.WIDE_GROUP) + 6) / 14
    for wider in (640, 768, 1024):
        assert tfa.backward_plan(wider, torch.bfloat16, "dq")["image_stages"] > 0
        assert tfa.backward_columns(wider, torch.bfloat16) == tfa.WIDE_GROUP
    assert tfa.backward_plan(d, torch.float32, "dkv")["image_stages"] > 0
    assert tfa.backward_columns(d, torch.float32) == gw


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


# the float32 backward with the resident rows (csrc/flash_attention.cu::wqb):
# streamed rows a tile, columns an item; items a 32-row tile of dq (and of
# dk/dv's dK block), and of the dV block, as the note counts them
KT, SUB = 32, 64
RESIDENT_BWD_ITEMS = {256: (12, 8), 384: (21, 9), 512: (28, 12)}


@pytest.mark.parametrize("d", [256, 384, 512])
def test_resident_backward_plans(d):
    """The float32 backward with the resident rows at each of its widths,
    one plan for dq and dk/dv: 64 rows a block, two consumer warpgroups on
    them (S's and the output's), 32 streamed rows a tile, 16 KB items (32
    rows x 64 columns in both TF32 halves, or a raw item of 64 rows x 64
    floats) in as many stages as fit up to eight, beside the resident
    operands' 64 rows at a stride of d + 4 floats (both at 256; at 384 and
    512 the first alone: two no longer fit beside four stages) and two
    tiles of P handed between the warpgroups; output columns the bf16 TMA
    pair's; a tile's items as the note counts them; the widths above 512
    keep the column-group plan."""
    rows, c, tile, ni, smem, gw = RESIDENT_BWD_PLANS[d]
    for kernel in tfa.BWD_KERNELS:
        plan = tfa.backward_plan(d, torch.float32, kernel)
        assert tuple(plan.values()) == (rows, c, tile, 0, ni, smem)
    assert tfa.backward_columns(d, torch.float32) == gw == tfa.backward_columns(d, torch.bfloat16)
    assert tile == KT and d % gw == 0 and gw % SUB == 0
    item = KT * SUB * 8
    assert item == 64 * SUB * 4 == 16384
    resident = 2 if d == 256 else 1

    def fixed(operands):   # slack, resident rows, P's two tiles and four barriers
        return 128 + operands * 64 * (d + 4) * 4 + 2 * 64 * KT * 4 + 32
    assert smem == fixed(resident) + ni * (item + 16) <= tfa.FWD_SMEM_LIMIT
    assert 4 <= ni <= tfa.RESIDENT_BWD_STAGES
    if ni < tfa.RESIDENT_BWD_STAGES:   # one more stage would not fit
        assert fixed(resident) + (ni + 1) * (item + 16) > tfa.FWD_SMEM_LIMIT
    assert (fixed(2) + 4 * (item + 16) <= tfa.FWD_SMEM_LIMIT) == (d == 256)
    # a tile: S's chunks, dP's (each after the second operand's raw chunk
    # where it streams), the group's sub-groups; the dV block no dP
    nch, sub = d // SUB, gw // SUB
    assert RESIDENT_BWD_ITEMS[d] == (nch + nch * (3 - resident) + sub, nch + sub)
    for wider in (640, 768, 1024):
        plan = tfa.backward_plan(wider, torch.float32, "dq")
        assert (plan["tile"], plan["image_stages"]) == WIDE_PLANS[torch.float32][1][:2]
        assert tfa.backward_columns(wider, torch.float32) == tfa.WIDE_GROUP


@pytest.mark.parametrize("d,want", [(256, 8 / 7), (384, 13 / 7), (512, 13 / 7), (1024, 5.0)])
def test_float32_backward_products(d, want):
    """The float32 pair's products over the least (14 N^2 d flops): 8/7 at
    256 (one group, dk/dv split by output; the column-group pair 1.57x),
    13/7 at 384 and 512 (two groups of 192 or 256; 2.14x, 2.71x), as the
    bf16 TMA pair's; above 512 the column-group pair's (8 g + 6) / 14, 5x at
    1024; ``chip_smoke.py``'s factor the same."""
    import chip_smoke as cs
    assert tfa.backward_products(d, torch.float32) == pytest.approx(want)
    assert tfa.backward_products(d, torch.float32) == tfa.backward_products(d, torch.bfloat16)
    assert cs.wide_factors(d)[1] == tfa.backward_products(d, torch.float32)
    if d in tfa.TMA_WIDTHS:
        assert want < (8 * (d // tfa.WIDE_GROUP) + 6) / 14


def _halves(x):
    """float32 -> its TF32 halves (big, small), as ``tf32mma::split``."""
    big = _rna_tf32(x)
    return big, _rna_tf32(x - big)


def _k_item(x):
    """``wq::k_store``'s item of a (KT, SUB) tile, by the producer's map of
    its threads' chunks: K-major at ``image_offset``, the big half, the
    small one KT x 32 bytes on."""
    img = np.full(KT * SUB * 2, np.nan, np.float32)
    big, small = _halves(x)
    cpr = SUB // 4
    for u in range(KT * cpr):   # thread u % 128's chunk u // 128
        r, ck = u % KT, (u // KT + u % KT) % cpr
        slot = tfa.image_offset(r, ck, KT, 2) // 4
        assert np.isnan(img[slot:slot + 4]).all()
        img[slot:slot + 4], img[slot + KT * 8:slot + KT * 8 + 4] = (
            big[r, 4 * ck:4 * ck + 4], small[r, 4 * ck:4 * ck + 4])
    return img


def _v_item(x):
    """``wq::v_store``'s item of a (KT, SUB) tile transposed: column c's
    chunk ck holds rows ``v_image_keys`` (the register fragment's order), at
    ``image_offset`` of an image of SUB rows, both halves."""
    img = np.full(KT * SUB * 2, np.nan, np.float32)
    big, small = _halves(x)
    for u in range(SUB * KT // 4):
        c, ck = u % SUB, u // SUB
        keys = tfa.v_image_keys(torch.float32, ck)
        slot = tfa.image_offset(c, ck, SUB, 2) // 4
        assert np.isnan(img[slot:slot + 4]).all()
        img[slot:slot + 4], img[slot + SUB * 8:slot + SUB * 8 + 4] = big[keys, c], small[keys, c]
    return img


def _a_item(x):
    """``wqb::a_store``'s raw item of the block's (64, SUB) rows: element
    (r, c) at float r SUB + (c ^ 4 (r % 8)), by the producer's map."""
    img = np.full(64 * SUB, np.nan, np.float32)
    for u in range(64 * SUB // 4):
        r, c4 = u // (SUB // 4), u % (SUB // 4)
        slot = r * SUB + ((4 * c4) ^ ((r & 7) << 2))
        assert np.isnan(img[slot:slot + 4]).all()
        img[slot:slot + 4] = x[r, 4 * c4:4 * c4 + 4]
    return img


def _read_b(img, rows, kdim):
    """A B operand of ``rows`` rows and ``kdim`` along K as ``wgmma`` reads
    it from an item through ``b_desc`` (a k8 step's block rows x 64 bytes,
    the small half rows x 32 bytes after the big): (big, small)."""
    r, k = np.meshgrid(np.arange(rows), np.arange(kdim), indexing="ij")
    slot = (k // 8) * rows * 16 + (r >> 3) * 64 + ((k % 8) // 4) * 32 + (r & 7) * 4 + k % 4
    return img[slot], img[slot + rows * 8]


def _a_frags(buf, ld, k0, swizzled):
    """``wqb::a_frags`` of one k16 step from column k0 on: thread (warp w,
    lane 4 g + t) loads rows 16 w + g and + 8, columns k0 + 8 kk + t and + 4
    of ``buf`` (row stride ``ld``; the raw item's swizzle); returns the 64 x
    16 step as the TF32 fragments place it (rows g, g + 8, columns t, t +
    4 of each k8 step) and, per warp and load, the 32 lanes' float
    addresses."""
    step, loads = np.full((64, 16), np.nan, np.float32), {}
    for w, g, t, kk in itertools.product(range(4), range(8), range(4), range(2)):
        r = 16 * w + g
        c = (k0 + 8 * kk + t) ^ (((r & 7) << 2) if swizzled else 0)
        for e, (addr, at) in enumerate((
                (r * ld + c, (r, 8 * kk + t)), ((r + 8) * ld + c, (r + 8, 8 * kk + t)),
                (r * ld + (c ^ 4), (r, 8 * kk + t + 4)),
                ((r + 8) * ld + (c ^ 4), (r + 8, 8 * kk + t + 4)))):
            step[at] = buf[addr]
            loads.setdefault((w, kk, e), []).append(addr)
    return step, loads


def _tf32_product(a, b_big, b_small, split):
    """a (its halves split in registers) times B transposed, in float64:
    small.big + big.small + big.big (``split``), else big.big."""
    a_big, a_small = (x.astype(np.float64) for x in _halves(a))
    b_big, b_small = b_big.astype(np.float64), b_small.astype(np.float64)
    out = a_big @ b_big.T
    return out + a_small @ b_big.T + a_big @ b_small.T if split else out


def _over_head(a, b, raw, split):
    """``wqb::over_head``: the block's 64 rows ``a`` times the tile's rows
    ``b`` transposed, over the head: a chunk item of b a 64 columns; A's
    fragments from the resident rows at a stride of d + 4 floats, or
    (``raw``) from the chunk's raw item; every load of a warp on 32 banks."""
    d = a.shape[1]
    resident = np.pad(a, ((0, 0), (0, 4)), constant_values=np.nan).ravel()
    out = np.zeros((64, KT))
    for c in range(d // SUB):
        b_big, b_small = _read_b(_k_item(b[:, c * SUB:(c + 1) * SUB]), KT, SUB)
        buf, ld, col = ((_a_item(a[:, c * SUB:(c + 1) * SUB]), SUB, 0) if raw
                        else (resident, d + 4, c * SUB))
        for st in range(SUB // 16):
            step, loads = _a_frags(buf, ld, col + 16 * st, raw)
            assert all(len({x % 32 for x in addrs}) == 32 for addrs in loads.values())
            for kk in range(2):
                ks = slice(16 * st + 8 * kk, 16 * st + 8 * kk + 8)
                out += _tf32_product(step[:, 8 * kk:8 * kk + 8], b_big[:, ks], b_small[:, ks],
                                     split)
    return out


def _into_group(x, m, split):
    """``wqb::out_subgroups``: x (64 rows x the tile's KT, in accumulator
    order) as register A, in the fragment's order, times each transposed
    sub-group item of the tile's rows m (KT x the group's columns)."""
    xr = x[:, _register_order(KT)]
    out = np.zeros((64, m.shape[1]))
    for h in range(m.shape[1] // SUB):
        b_big, b_small = _read_b(_v_item(m[:, h * SUB:(h + 1) * SUB]), SUB, KT)
        out[:, h * SUB:(h + 1) * SUB] = _tf32_product(xr, b_big, b_small, split)
    return out


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("d", [256, 384, 512])
def test_resident_backward_items_give_back_products(d, kernel):
    """A numpy model of the float32 backward's items and fragments at each
    of its widths: the K-major chunk items and the transposed sub-groups
    (both TF32 halves, by the producer's map of its threads' chunks, each
    slot written once), the raw items of the second operand at 384 and 512
    (swizzled) and the register A fragments from the resident raw rows
    (stride d + 4), every warp's load on 32 banks; read back as the
    kernels' descriptors and fragments read them, they give back dq's S = Q
    K^T, dP = dO V^T and dQ_g = dS K_g, or dk/dv's S^T = K Q^T, dP^T = V
    dO^T, dV_g = P^T dO_g and dK_g = dS^T Q_g, for each group of the head:
    exactly on integer tiles, and on float32 tiles within the 3xTF32
    criterion (|error| <= 2^-20 |a| |b| a product, which one TF32 product
    a k8 step misses)."""
    gw, raw = tfa.backward_columns(d, torch.float32), d != 256
    rng = np.random.default_rng(d + len(kernel))
    for exact in (True, False):
        def make(*shape):
            x = rng.integers(-4, 5, shape) if exact else rng.standard_normal(shape)
            return x.astype(np.float32)
        res_a, res_b = make(64, d), make(64, d)   # dq: Q, dO; dk/dv: K, V (the block's rows)
        st_a, st_b = make(KT, d), make(KT, d)     # dq: K, V; dk/dv: Q, dO (the tile's rows)
        x = make(64, KT)                           # dS; P^T or dS^T
        checks = [(_over_head(res_a, st_a, False, True), res_a, st_a),
                  (_over_head(res_b, st_b, raw, True), res_b, st_b)]
        for grp in range(d // gw):
            cols = slice(grp * gw, (grp + 1) * gw)
            outs = (st_a,) if kernel == "dq" else (st_b, st_a)   # dQ_g; dV_g, dK_g
            checks += [(_into_group(x, m[:, cols], True), x, m[:, cols].T) for m in outs]
        for got, a, b in checks:
            want = a.astype(np.float64) @ b.astype(np.float64).T
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                bound = 2.0 ** -20 * (np.abs(a).astype(np.float64) @ np.abs(b).T)
                assert np.all(np.abs(got - want) <= bound)
    # one TF32 product a k8 step misses the criterion by far
    a, b = make(64, d), make(KT, d)
    one = _over_head(a, b, False, False) - a.astype(np.float64) @ b.astype(np.float64).T
    assert np.max(np.abs(one) / (2.0 ** -20 * (np.abs(a).astype(np.float64) @ np.abs(b).T))) > 10


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


@pytest.mark.parametrize("bh,n,d", [(2, 200, 256), (2, 200, 512)])
def test_wide_3xtf32_backward_meets_the_f32_criterion(bh, n, d):
    """The float32 backward's arithmetic above 128 (``backward_plan``'s
    tiles: 32 keys in dq, 32 queries in dk/dv, the pair with the resident
    rows at 256 and 512; S and dP over the head with a partial a k16 step;
    the group's products one partial a tile, a sub-group of 64 columns at a
    time) keeps dq, dk, dv within the criterion the CUDA kernels are held
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


@pytest.mark.parametrize("mangled,label", [
    ("_ZN12_GLOBAL__N_122flash_bwd_dq_wq_kernelILi256EEEvPKfS2_S2_S2_S2_S2_Pfif",
     "flash_bwd_dq_wq_kernel<256, f32>"),
    ("_ZN12_GLOBAL__N_123flash_bwd_dkv_wq_kernelILi384EEEvPKfS2_S2_S2_S2_S2_PfS3_if",
     "flash_bwd_dkv_wq_kernel<384, f32>"),
    ("_ZN12_GLOBAL__N_122flash_bwd_dq_wq_kernelILi512EEEvPKfS2_S2_S2_S2_S2_Pfif",
     "flash_bwd_dq_wq_kernel<512, f32>"),
])
def test_build_report_names_the_resident_backward_kernels(mangled, label):
    """``chip_smoke.py`` phase 2 finds each float32 backward instantiation
    above 128 by these labels, among those it requires at ``TMA_WIDTHS`` and
    counts among the kernels that must run on wgmma only, and finds ptxas's
    notes that it serialised their wgmma (C7515, C7514) by the same
    labels."""
    import chip_smoke as cs
    assert cs.kernel_label(f"ptxas info    : Function properties for {mangled}") == label
    assert label in {cs.flash_wide_bwd_label(d, k, torch.float32) for d in tfa.TMA_WIDTHS
                     for k in tfa.BWD_KERNELS}
    assert label.startswith(cs.WGMMA_KERNELS)
    note = ("ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async instructions "
            "are serialized due to non wgmma instructions reading accumulator registers of  a "
            f"wgmma between start and end of the pipeline stage in the function '{mangled}'")
    assert cs.ptxas_serial_notes(note, {label}) == [note]
    assert cs.ptxas_serial_notes(note.replace("C7514", "C7519"), {label}) == []
