"""The SIREN-FiLM dz kernel's numeric scheme and index maps on the CPU.

``siren_decode_dz_cluster`` (``confild_tpu_torch/csrc/siren_chain_cluster.cu``)
runs the training backward's cluster chain in its dz mode: every
hidden-by-hidden product of the forward recompute and of the dx chain is a
3xTF32 tensor-core product summed as zeroed partials per 16 of k; after
each layer a cluster of ``CP`` = 128 pairs (64 above H = 2048,
``tests/test_torch_siren_wide.py``) sums ``dpre_l`` over its pairs in pair
order, one float32 sum per latent row it touches (a slot), and a fold adds
each row's cluster sums in cluster order, chunk after chunk of
``BWD_PAIRS`` pairs.  That arithmetic is emulated here on
``decode_dz_plain``'s walk (the chain's products from
``tests/test_torch_siren_bwd.py``, the TF32 products from
``tests/test_torch_flash.py``), at a chunk small enough that clusters and
chunks cut rows.

The emulation must meet ``|x - f64| <= 2 |plain f32 - f64| + 1e-6
max|f64|`` on ``dL/dlatents`` (and on dz) at the Case4 and Case2 widths,
where the float64 truth is the same walk with exact sines; with one TF32
product per matmul it must miss.  The index maps (the cluster's row slots
and the fold's sources) are held to the plain definition ``row = pair //
M``, the kernel's count of slots to the most rows a cluster touches, and the
port's CPU op to the JAX kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

from confild_tpu.ops import siren_decode as jsd
from confild_tpu_torch.models.cnf import SirenFilm
from confild_tpu_torch.ops import siren_decode as tsd
from test_torch_flash import _mm_3xtf32, _mm_tf32
from test_torch_siren_bwd import _bwd_f64, _chain_mm, _dsin, _np, _seq_sum, _sin
from test_torch_siren_fwd import WIDTHS
from torch_parity_utils import jax_siren, limit_torch_threads, t

# pairs a cluster of the chain owns up to H = 2048 (ops/siren_decode.py::
# cluster_plan), the unit of dz's row sums
CP = 128
# 3 rows of 100 points in chunks of 256 pairs: clusters of 128 cut rows 1
# and 2 (at pairs 100 and 200), the chunk boundary at 256 cuts row 2, and
# the second chunk's one cluster is ragged (44 pairs)
ROWS, POINTS, CHUNK = 3, 100, 256


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _case(width, seed=0):
    """A seeded decoder at ``width`` (the init ``chip_smoke.py`` uses) and
    numpy-made coordinates, latents and output cotangent."""
    cfg = WIDTHS[width]
    model = SirenFilm(**cfg, w0=30.0, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(seed)
    coords = t(rng.uniform(-1, 1, (POINTS, cfg["in_coord_features"])))
    latents = t(0.1 * rng.standard_normal((ROWS, cfg["in_latent_features"])))
    g = t(rng.standard_normal((ROWS, POINTS, cfg["out_features"])))
    with torch.no_grad():
        w_first, w_mid, w_head, _, w2, b1, scale = tsd.stack_weights(model, model.w0)
        z = tsd.film_table(latents, w2, b1, scale)
    return coords, latents, g, z, (w_first, w_mid, w_head), w2, scale


# ---------------------------------------------------------------------------
# the kernels' index maps (csrc/siren_chain_cluster.cu's row sums,
# csrc/siren_dz_fold.cuh::dz_slots and siren_dz_fold_kernel)
# ---------------------------------------------------------------------------

def _dz_slots(m):
    """The slots of a cluster's partial, as ``dz_slots`` computes them:
    ``ceil((CP - 1) / M) + 1``, at most ``CP``."""
    return min(CP, (CP - 2 + m) // m + 1)


def _block_slots(p0, q, m):
    """Per cluster of the chunk, the slot of each of its pairs: its row
    less the row of the cluster's first pair."""
    return [(p0 + np.arange(b, min(q, b + CP))) // m - (p0 + b) // m
            for b in range(0, q, CP)]


def _fold_sources(p0, q, m):
    """Per row of the chunk, the ``(cluster, slot)`` partials the fold
    adds, in cluster order: the clusters that hold the row's pairs of the
    chunk."""
    sources = {}
    for row in range(p0 // m, (p0 + q - 1) // m + 1):
        a, b = max(row * m, p0) - p0, min((row + 1) * m, p0 + q) - p0
        sources[row] = [(bk, row - (p0 + bk * CP) // m) for bk in range(a // CP, (b - 1) // CP + 1)]
    return sources


def _dz_emulated(mm, coords, z, g, w_first, w_mid, w_head, chunk=CHUNK):
    """``decode_dz_plain``'s walk with the kernels' products, cluster sums
    and fold."""
    n_mod, rows, h = z.shape
    m = coords.shape[0]
    z, w_first, w_mid, w_head = map(_np, (z, w_first, w_mid, w_head))
    row = np.repeat(np.arange(rows), m)
    pres = [np.tile(_np(coords), (rows, 1)) @ w_first + z[0][row]]
    for l in range(1, n_mod):
        pres.append(_chain_mm(mm, _sin(pres[-1]), w_mid[l - 1]) + z[l][row])
    dpre = [None] * n_mod
    dx = _np(g).reshape(rows * m, -1) @ w_head.T
    for l in range(n_mod - 1, -1, -1):
        dpre[l] = dx * _dsin(pres[l])
        if l > 0:
            dx = _chain_mm(mm, dpre[l], np.ascontiguousarray(w_mid[l - 1].T))
    dpre = np.stack(dpre, axis=1)                  # (pairs, n_mod, H)
    dz = np.zeros((rows, n_mod, h), np.float32)
    for p0, q in tsd.pair_chunks(rows * m, chunk):
        parts = []
        for b, slots in zip(range(0, q, CP), _block_slots(p0, q, m)):
            x = dpre[p0 + b:p0 + b + len(slots)]
            parts.append([_seq_sum(x[slots == s]) for s in range(slots[-1] + 1)])
        for r, sources in _fold_sources(p0, q, m).items():
            acc = dz[r]
            for bk, s in sources:
                acc = acc + parts[bk][s]
            dz[r] = acc
    return torch.from_numpy(dz.transpose(1, 0, 2).copy())


def _margins(mm, width, seed=0):
    """error / limit of dz and dL/dlatents under the kernel's criterion."""
    coords, latents, g, z, ops, w2, scale = _case(width, seed)
    with torch.no_grad():
        got = _dz_emulated(mm, coords, z, g, *ops).double()
        plain = tsd.decode_dz_plain(coords, z, g, *ops).double()
        truth = _bwd_f64(coords, z, g, *ops)[0]
    w2 = w2.detach().double()
    margins = {}
    for name, f in (("dz", lambda d: d),
                    ("dlatents", lambda d: torch.einsum("nth,nlh->tl", d * scale, w2))):
        x, pl, tr = f(got), f(plain), f(truth)
        limit = 2 * (pl - tr).abs().max() + 1e-6 * tr.abs().max()
        margins[name] = ((x - tr).abs().max() / limit).item()
    return margins


@pytest.mark.parametrize("width", ["case4", "case2"])
def test_3xtf32_dz_meets_the_f32_criterion(width):
    """3xTF32 chain products, cluster row sums and the fold keep dz and
    dL/dlatents within the criterion."""
    margins = _margins(_mm_3xtf32, width)
    assert max(margins.values()) <= 1.0, margins


@pytest.mark.parametrize("width", ["case4", "case2"])
def test_single_tf32_dz_misses_the_f32_criterion(width):
    """One TF32 product per matmul is far outside it: the split is needed."""
    margins = _margins(_mm_tf32, width)
    assert min(margins.values()) > 10.0, margins


@pytest.mark.parametrize("width", ["case4", "case2"])
def test_emulation_follows_the_plain_version(width):
    """With exact float32 products the emulation is the plain version's
    walk, summed in another order."""
    coords, _, g, z, ops, _, _ = _case(width, seed=1)
    with torch.no_grad():
        got = _dz_emulated(lambda a, b: a @ b, coords, z, g, *ops)
        plain = tsd.decode_dz_plain(coords, z, g, *ops)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-3,
                               atol=1e-4 * plain.abs().max().item())


@pytest.mark.parametrize("c_in,latent,c_out,layers,hidden,rows,points", [
    (3, 16, 3, 2, 64, 5, 300),
    (2, 8, 4, 3, 128, 9, 130),
])
def test_cpu_op_matches_pallas_interpret(c_in, latent, c_out, layers, hidden, rows, points):
    """The port's ``fused_siren_decode_dz`` on the CPU against the JAX
    ``_decode_dz_kernel`` in interpret mode, on the weights ``io/convert.py``
    carries across and the same numpy inputs: two f32 evaluations of the
    same recompute-and-walk-back, summed in another order."""
    params, model = jax_siren(c_in=c_in, latent=latent, c_out=c_out, layers=layers,
                              hidden=hidden, seed=4)
    rng = np.random.default_rng(5)
    coords = rng.uniform(-1, 1, (points, c_in)).astype(np.float32)
    latents = (0.1 * rng.standard_normal((rows, latent))).astype(np.float32)
    g = rng.standard_normal((rows, points, c_out)).astype(np.float32)
    pallas = np.asarray(jsd.fused_siren_decode_dz(params, coords, latents, g, 30.0, 8, 128, True))
    ours = tsd.fused_siren_decode_dz(model, t(coords), t(latents), t(g)).numpy()
    assert ours.shape == pallas.shape == (rows, latent)
    np.testing.assert_allclose(ours, pallas, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("m,rows,chunk", [
    (10, 50, 448), (64, 20, 448), (1000, 3, 448), (1024, 3, 640),
    (10, 384, tsd.BWD_PAIRS), (1024, 384, tsd.BWD_PAIRS),
])
def test_slots_and_fold_cover_every_pair_once(m, rows, chunk):
    """The chunk walk, the clusters' row slots and the fold's sources cover
    every (row, point) pair exactly once and put it in its row; a cluster
    never needs more slots than ``dz_slots``."""
    pairs = rows * m
    walk = tsd.pair_chunks(pairs, chunk)
    assert [p0 for p0, _ in walk] == list(range(0, pairs, chunk))
    assert sum(q for _, q in walk) == pairs
    seen = np.zeros(pairs, np.int64)
    for p0, q in walk:
        slots = _block_slots(p0, q, m)
        assert max(s.max() for s in slots) < _dz_slots(m)
        for row, sources in _fold_sources(p0, q, m).items():
            assert [bk for bk, _ in sources] == sorted({bk for bk, _ in sources})
            for bk, s in sources:
                pair = p0 + bk * CP + np.flatnonzero(slots[bk] == s)
                assert len(pair) and (pair // m == row).all()
                seen[pair] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("m,want", [(1, 128), (7, 20), (10, 14), (63, 4), (64, 3), (1024, 2)])
def test_row_slots(m, want):
    """A cluster of 128 consecutive pairs touches at most ceil(127 / M) + 1
    rows: 14 at Case4's 10 sensors (12.8 rows a cluster)."""
    assert _dz_slots(m) == want
    firsts = np.arange(0, 4 * m * CP, 1)
    touched = (firsts + CP - 1) // m - firsts // m + 1
    assert touched.max() == want
