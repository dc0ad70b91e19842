"""The float32 SIREN-FiLM cluster kernels' plan, layouts and wide widths, on
the CPU.

On the card the forward, dz and the training backward's chain are
thread-block cluster kernels at every width (``csrc/siren_fwd_cluster.cu``,
``csrc/siren_chain_cluster.cu``): each block of a cluster owns a share of
every layer's output columns, and the middle weights stream from a
preparation that lays them out as the blocks' shared-memory stage images
(for the chain the forward's products, then the dx chain's transposed
ones).  Here: the port's forward (the plain version a CPU tensor takes) at
H = 1536 and 2048 against the JAX package's Pallas forward in interpret mode
(rtol 1e-5, the wide forward tests' tolerance), ``CNF_inference`` at 2048
against the JAX package's, the zero padding to a cluster plan's width, a
pure-Python mirror of the plan at every width the kernels take, the plain
weight layouts (their inverse and their TF32 halves, and the preparation
kernel's index arithmetic written out), and the per-family width limits.
dz and the training backward at 1536 and 2048 against the JAX kernels are
``test_torch_siren_wide.py``'s.  The kernels themselves run on the card
(``chip_smoke.py`` phases 3, 4, 7, 16 and 19).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from confild_tpu.inference import CNF_inference as JInference
from confild_tpu.io.checkpoint import save_pytree
from confild_tpu.ops import siren_decode as jsd
from confild_tpu_torch.inference import CNF_inference
from confild_tpu_torch.ops import siren_decode as tsd
from torch_parity_utils import jax_siren, limit_torch_threads, t

# the widths the cluster kernels take: every multiple of 64 up to the widest
CLUSTER_WIDTHS = range(64, tsd.MAX_HIDDEN["forward"] + 1, 64)
CONSUMERS = 2   # consumer warpgroups a block (csrc/siren_fwd_cluster.cu)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _case(hidden, layers, rows=2, points=64, c_in=3, c_out=5, seed=0):
    params, model = jax_siren(c_in=c_in, latent=16, c_out=c_out, layers=layers,
                              hidden=hidden, seed=seed)
    rng = np.random.default_rng(seed + 10)
    coords = rng.uniform(-1, 1, (points, c_in)).astype(np.float32)
    latents = (0.1 * rng.standard_normal((rows, 16))).astype(np.float32)
    return params, model, coords, latents


@pytest.mark.parametrize("hidden, layers", [(1536, 2), (2048, 1), (2048, 2)])
def test_forward_matches_pallas_interpret_above_1024(hidden, layers):
    """3 -> H x (layers + 1) modulated layers -> 5 at T = 2, M = 64: the
    port's forward against ``_fused_forward`` in interpret mode with tiles
    of 2 rows x 64 points."""
    params, model, coords, latents = _case(hidden, layers)
    pallas = np.asarray(jsd._fused_forward(params, jnp.asarray(coords), jnp.asarray(latents),
                                           30.0, 2, 64, True, jnp.float32))
    with torch.no_grad():
        ours = tsd.fused_siren_decode(model, t(coords), t(latents)).numpy()
    assert ours.shape == pallas.shape == (2, 64, 5)
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=2e-6)


def test_cnf_inference_matches_jax_at_2048(tmp_path):
    """A 2048-wide FiLM decoder (3 modulated layers, 2 coordinates, 2
    outputs) from a JAX ``.ckpt``: ``CNF_inference.predict`` against the JAX
    package's ``CNF_inference`` (its reference decode), as
    ``test_torch_cli.py::test_cnf_inference_matches_jax`` at 32."""
    cparams, _ = jax_siren(c_in=2, latent=8, c_out=2, layers=2, hidden=2048)
    latents = (0.1 * np.random.default_rng(3).standard_normal((4, 8))).astype(np.float32)
    save_pytree(str(tmp_path / "checkpoint_1.ckpt"),
                {"model_state_dict": cparams, "hidden_states": {"latents": latents}})
    save_pytree(str(tmp_path / "normalizer_params.ckpt"),
                {"x_normalizer_params": (np.ones(2, np.float32), np.zeros(2, np.float32)),
                 "y_normalizer_params": (np.full((1, 2), 2.0, np.float32),
                                         np.full((1, 2), -1.0, np.float32))})
    (tmp_path / "cnf.yml").write_text(yaml.safe_dump({
        "dims": 2, "hidden_size": 8,
        "NF": {"name": "SIRENAutodecoder_film", "out_features": 2,
               "num_hidden_layers": 2, "hidden_features": 2048}}))
    args = (str(tmp_path / "checkpoint_1.ckpt"), str(tmp_path / "cnf.yml"))
    ours = CNF_inference(*args, device="cpu")
    ref = JInference(*args, use_pallas=False)
    grid = ours.create_coordinates_grid((6, 5)).reshape(-1, 2)
    got = ours.predict(grid, [0, 2, 3], batch_size=2)
    want = np.asarray(ref.predict(grid, [0, 2, 3], batch_size=2))
    assert got.shape == want.shape == (3, 30, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_padding_to_a_cluster_width_is_exact():
    """H = 1600 runs on the card at the plan's width, 1792 (7 blocks of
    256): through the padding function the plain forward equals the
    unpadded one (1e-6)."""
    _, model, coords, latents = _case(1600, 2, rows=2, points=48)
    width = tsd.kernel_hidden_width(1600, 3, 5, "forward")
    assert width == tsd.cluster_plan(1600).width == 1792
    with torch.no_grad():
        w_first, w_mid, w_head, b_head, w2, b1, scale = tsd.stack_weights(model, model.w0)
        z = tsd.film_table(t(latents), w2, b1, scale)
        ops = (t(coords), z, w_first, w_mid, w_head, b_head)
        torch.testing.assert_close(tsd.padded_forward(tsd.decode_forward_plain, *ops, width),
                                   tsd.decode_forward_plain(*ops), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h", CLUSTER_WIDTHS)
def test_cluster_plan(h):
    """The plan at every width the kernel takes: at most 8 blocks, the
    shared memory a Hopper block may take, the smallest padded width of the
    instantiations (a plan's width plans to itself), every (pair, column)
    of the cluster's tile owned by exactly one consumer warpgroup, and at
    most 256 columns a warpgroup in whole n64 subtiles.  Up to 512 a
    cluster owns 128 pairs and pads to 128, 192, 256, 384 or 512."""
    plan = tsd.cluster_plan(h)
    assert 1 <= plan.blocks <= tsd.CLUSTER_MAX_BLOCKS and plan.pairs in (64, 128)
    assert plan.shared_bytes() <= tsd.SMEM_PER_BLOCK and 2 <= plan.ring() <= 4
    # the bf16 forward's ring on the same plan: bf16 shares and stages, up
    # to 16 stages, never fewer than the float32 kernels'
    assert plan.shared_bytes(bf16=True) <= tsd.SMEM_PER_BLOCK
    assert plan.ring() <= plan.ring(bf16=True) <= 16
    assert plan.width >= h and plan.width - h < plan.share
    if h <= 512:
        assert plan.pairs == 128 and plan.width in (128, 192, 256, 384, 512)
    assert plan.width == min(-(-h // s) * s for s, _ in tsd.CLUSTER_CONFIGS
                             if -(-h // s) <= tsd.CLUSTER_MAX_BLOCKS)
    assert tsd.cluster_plan(plan.width) == plan
    owner = np.zeros((plan.pairs, plan.width), np.int64)
    for block, rows, cols in _tiles(plan):
        assert cols.start // plan.share == cols[-1] // plan.share == block
        assert len(rows) == 64 and len(cols) <= 256 and len(cols) % 64 == 0
        owner[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (owner == 1).all()
    for c in (1, 3, 5, tsd.FEATURE_CHUNK, tsd.FEATURE_CHUNK + 1, 64):
        assert tsd.kernel_hidden_width(h, c, c, "forward") == plan.width


def _tiles(plan):
    """``(block, rows, columns)`` of every consumer warpgroup's
    accumulators, as the kernel's ``m_off`` and ``n_off`` place them: with
    two m64 tiles each warpgroup owns one and all of its block's columns,
    with one the two split them."""
    n_wg = plan.share * plan.m_tiles // CONSUMERS
    for b in range(plan.blocks):
        for wg in range(CONSUMERS):
            m_off = (wg % plan.m_tiles) * 64
            n_off = b * plan.share + (wg // plan.m_tiles) * n_wg
            yield b, range(m_off, m_off + 64), range(n_off, n_off + n_wg)


def _halves(image, share, n_mid, h):
    """The inverse of ``cluster_weight_layout``: ``(big, small)``, each
    ``(n_mid, H, H)``."""
    x = image.view(h // share, n_mid, h // 16, 2, 2, share // 8, 2, 8, 4)
    return x.permute(4, 1, 2, 8, 3, 6, 0, 5, 7).reshape(2, n_mid, h, h)


def _prep_source(e, h, share, n_mid, n_prod=None):
    """What the preparation kernel (``csrc/siren_cluster.cuh::
    siren_cluster_prep_kernel``) reads for its float4 ``e`` of ``n_prod``
    products (``n_mid`` for the forward, ``2 n_mid`` for the chain): the
    half, the middle weight, and the four (row, column) elements of it, a
    transposed product's read as (column, row)."""
    n_prod = n_mid if n_prod is None else n_prod
    slices, img = h // 16, share * 2
    stage = 4 * img
    per_rank = n_prod * slices * stage
    rank, rem = divmod(e, per_rank)
    u, w = divmod(rem, stage)
    product, c = divmod(u, slices)
    kk, half, x = w // (2 * img), (w // img) % 2, w % img
    g8, kc, r = x // 16, (x // 8) % 2, x % 8
    k0 = c * 16 + 2 * kk + kc
    n = rank * share + g8 * 8 + r
    ks = [k0 + 4 * i for i in range(4)]
    if product >= n_mid:
        return half, 2 * n_mid - 1 - product, (n, ks)
    return half, product, (ks, n)


@pytest.mark.parametrize("h", [128, 256, 384, 576, 1024, 2304])
def test_cluster_weight_layout(h):
    """The plain stage images of two middle weights: the inverse gives back
    W's TF32 halves exactly, big and small keep no bits below TF32's
    (their low 13 mantissa bits are zero), big + small is W to float32's
    last bits, and the preparation kernel's index arithmetic reads, for
    every 251st float4, the element the layout puts there."""
    plan = tsd.cluster_plan(h)
    assert plan.width == h
    w = torch.from_numpy(np.random.default_rng(h).standard_normal((2, h, h)).astype(np.float32))
    image = tsd.cluster_weight_layout(w, plan.share)
    assert image.numel() == 2 * 2 * h * h
    big, small = _halves(image, plan.share, 2, h)
    want_big, want_small = tsd.tf32_split(w)
    assert torch.equal(big, want_big) and torch.equal(small, want_small)
    for half in (big, small):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    torch.testing.assert_close(big + small, w, rtol=2 ** -21, atol=0)
    quads = image.view(-1, 4)
    for e in range(0, quads.shape[0], 251):
        half, layer, index = _prep_source(e, h, plan.share, 2)
        src = (want_big if half == 0 else want_small)[layer]
        assert torch.equal(quads[e], src[index])


@pytest.mark.parametrize("h", [128, 256, 384, 576, 1024, 2304])
def test_cluster_chain_weight_layout(h):
    """The chain's stage images of three middle weights: per block the
    forward's three products, then the dx chain's W_2^T, W_1^T, W_0^T.
    Through the inverse each product gives back its weight's TF32 halves
    exactly (the dx chain's: ``w_mid.transpose`` in reverse order), the
    forward's part of each block equals the forward's layout, and the
    preparation kernel's index arithmetic with ``2 n_mid`` products reads,
    for every 253rd float4, the element the layout puts there."""
    plan = tsd.cluster_plan(h)
    w = torch.from_numpy(np.random.default_rng(h + 1).standard_normal((3, h, h))
                         .astype(np.float32))
    image = tsd.cluster_chain_weight_layout(w, plan.share)
    assert image.numel() == 2 * 3 * 2 * h * h
    big, small = _halves(image, plan.share, 6, h)
    want_big, want_small = tsd.tf32_split(w)
    tr_big, tr_small = tsd.tf32_split(w.transpose(1, 2).flip(0).contiguous())
    assert torch.equal(big[:3], want_big) and torch.equal(small[:3], want_small)
    assert torch.equal(big[3:], tr_big) and torch.equal(small[3:], tr_small)
    assert torch.equal(big[3], want_big[2].t()) and torch.equal(small[5], want_small[0].t())
    per_block = image.view(plan.blocks, 6, -1)
    forward = tsd.cluster_weight_layout(w, plan.share).view(plan.blocks, 3, -1)
    assert torch.equal(per_block[:, :3], forward)
    quads = image.view(-1, 4)
    for e in range(0, quads.shape[0], 253):
        half, layer, index = _prep_source(e, h, plan.share, 3, n_prod=6)
        src = (want_big if half == 0 else want_small)[layer]
        assert torch.equal(quads[e], src[index])


def _bf16_weights(image, share, n_mid, h):
    """The inverse of ``cluster_bf16_weight_layout``: ``(n_mid, H, H)``
    bf16."""
    x = image.view(h // share, n_mid, h // 32, 2, share // 8, 2, 8, 4, 2)
    return x.permute(1, 2, 7, 3, 5, 8, 0, 4, 6).reshape(n_mid, h, h)


def _prep_bf16_source(e, h, share, n_mid):
    """What the bf16 preparation kernel (``csrc/siren_cluster.cuh::
    siren_cluster_prep_bf16_kernel``) reads for its 16-byte row ``e``: the
    middle weight, the eight rows of it in the row's order and the
    column."""
    slices, stage = h // 16, share * 2
    rank, rem = divmod(e, n_mid * slices * stage)
    u, x = divmod(rem, stage)
    layer, c = divmod(u, slices)
    g8, half, r = x // 16, (x // 8) % 2, x % 8
    k0 = (c // 2) * 32 + 4 * (c % 2) + 2 * half
    return layer, [k0 + 8 * q + i for q in range(4) for i in range(2)], rank * share + g8 * 8 + r


@pytest.mark.parametrize("h, n_mid", [(128, 2), (384, 2), (1152, 2), (2048, 2), (3072, 1)])
def test_cluster_bf16_weight_layout(h, n_mid):
    """The bf16 forward's stage images of ``n_mid`` middle weights (one or
    two at 3072, with 64 pairs a cluster; two at the plans of 128, 192 and
    256 columns): the inverse gives back the weights rounded to bf16 (to
    nearest even, as ``Tensor.to``) exactly, a block's images are its own
    columns, and the preparation kernel's index arithmetic reads, for
    every 257th 16-byte row, the elements the layout puts there."""
    plan = tsd.cluster_plan(h)
    assert plan.width == h
    w = torch.from_numpy(np.random.default_rng(h + 2).standard_normal((n_mid, h, h))
                         .astype(np.float32))
    image = tsd.cluster_bf16_weight_layout(w, plan.share)
    assert image.dtype == torch.bfloat16 and image.numel() == n_mid * h * h
    want = w.to(torch.bfloat16)
    assert torch.equal(_bf16_weights(image, plan.share, n_mid, h), want)
    blocks = image.view(plan.blocks, -1)
    for b in (0, plan.blocks - 1):
        cols = want[:, :, b * plan.share:(b + 1) * plan.share]
        assert torch.equal(torch.sort(blocks[b].float()).values,
                           torch.sort(cols.reshape(-1).float()).values)
    rows = image.view(-1, 8)
    for e in range(0, rows.shape[0], 257):
        layer, ks, n = _prep_bf16_source(e, h, plan.share, n_mid)
        assert torch.equal(rows[e], want[layer, ks, n])


@pytest.mark.parametrize("family", ["dz", "bwd"])
def test_chain_widths_follow_the_cluster_plan(family):
    """dz and the training backward run at the cluster plan's width, as
    the forward does, at every width up to 3072 and with up to 16
    coordinates and outputs; past 3072 they raise, naming the family."""
    for h in range(1, tsd.MAX_HIDDEN[family] + 1, 37):
        assert tsd.kernel_hidden_width(h, 3, 5, family) == tsd.cluster_plan(h).width
    for h in CLUSTER_WIDTHS:
        assert tsd.kernel_hidden_width(h, 16, 16, family) == tsd.cluster_plan(h).width
    for h in (3073, 3136, 4096):
        with pytest.raises(ValueError, match=f"the CUDA SIREN {tsd.FAMILIES[family]} kernel "
                                             f"takes a hidden width of at most 3072"):
            tsd.kernel_hidden_width(h, 3, 5, family)


@pytest.mark.parametrize("family", sorted(tsd.FAMILIES))
def test_width_limits_per_family(family):
    """Every family, the float32 and bf16 forwards, dz and the training
    backward, takes every width up to 3072 (its cluster plan's); past a
    family's limit the error names the family and its limit."""
    limit = tsd.MAX_HIDDEN[family]
    assert limit == 3072
    assert tsd.kernel_hidden_width(limit, 3, 5, family) == limit
    with pytest.raises(ValueError, match=f"the CUDA SIREN {tsd.FAMILIES[family]} kernel takes "
                                         f"a hidden width of at most {limit}"):
        tsd.kernel_hidden_width(limit + 1, 3, 5, family)
