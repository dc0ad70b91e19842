"""The SIREN-FiLM training backward's numeric scheme on the CPU, at Case4
width (3 -> 384 x 16 modulated layers -> 3, w0 30).

The CUDA kernels (the cluster chain of
``confild_tpu_torch/csrc/siren_chain_cluster.cu``, then the reduction and
sums of ``csrc/siren_decode_bwd.cu``) run every hidden-by-hidden matrix
product on the tensor cores with a 3xTF32 split.  Their arithmetic is
emulated here on ``decode_bwd_plain``'s layer walk:

* the chain (forward recompute and dx chain): each product is a sum of
  zeroed partials, one per K-slice of 16 (two k8 steps) of the hidden
  axis, carried by float32 adds in k order;
* the reduction ``dW_mid[l-1] = sin2pi(r_{l-1})^T . dpre_l`` (``wgmma``,
  ``sin2pi(r)^T`` in registers, dpre through its K-major image): a zeroed
  partial per K-slice of 16 pairs (two k8 steps) carried by a float32 add
  into the running sum, which joins a slice's total every ``RED_SEG`` steps
  of ``RED_STEP`` pairs, ``BWD_SLICES`` slices of the chunk added in order
  at the end;
* dz, dW_first and dW_head (CUDA cores, float32): segment sums of
  ``SUM_SEG`` pairs within a row and a slice, the slices added in order.

The emulation must meet the criterion the kernels are held to on the card
(``chip_smoke.py`` phase 7): ``|x - f64| <= 2 |plain f32 - f64| + 1e-6
max|f64|`` for every cotangent, where the float64 truth is the same walk
with exact sines; with one TF32 product per matmul it must miss.
"""

import math

import numpy as np
import pytest
import torch

from confild_tpu_torch.models.cnf import SirenFilm
from confild_tpu_torch.ops import siren_decode as tsd
from test_torch_flash import _mm_3xtf32, _mm_tf32
from torch_parity_utils import limit_torch_threads

CASE4 = dict(in_coord_features=3, in_latent_features=384, out_features=3,
             num_hidden_layers=15, hidden_features=384, w0=30.0)
ROWS, POINTS = 2, 128
# siren_decode_bwd.cu: pairs per step of the reduction (RK), steps summed
# apart (RSEG), pairs per segment of the CUDA-core sums (SSEG); pairs a
# partial of the reduction sums on the tensor cores (a K-slice, two k8 steps)
RED_STEP, RED_SEG, SUM_SEG, RED_PARTIAL = 32, 16, 512, 16


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _case(seed=0):
    """Case4-width decoder (the seeded init ``chip_smoke.py`` uses) and
    numpy-made coordinates, latents and output cotangent."""
    model = SirenFilm(**CASE4, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(seed)
    coords = torch.from_numpy(rng.uniform(-1, 1, (POINTS, 3)).astype(np.float32))
    latents = torch.from_numpy((0.1 * rng.standard_normal((ROWS, 384))).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((ROWS, POINTS, 3)).astype(np.float32))
    with torch.no_grad():
        w_first, w_mid, w_head, _, w2, b1, scale = tsd.stack_weights(model, model.w0)
        z = tsd.film_table(latents, w2, b1, scale)
    return coords, latents, g, z, (w_first, w_mid, w_head), w2, scale


def _np(x):
    return np.ascontiguousarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _sin(r):
    return _np(tsd._sin2pi(torch.from_numpy(r)))


def _dsin(r):
    return _np(tsd._cos2pi_scaled(torch.from_numpy(r)))


def _partial(mm, a, b, k):
    """The products of k8 steps k and k + 1 (a's columns, b's rows) as the
    kernels take them: one zeroed partial, float32 adds."""
    part = mm(_np(a[:, k:k + 8]), _np(b[k:k + 8]))
    if k + 8 < a.shape[1]:
        part = part + mm(_np(a[:, k + 8:k + 16]), _np(b[k + 8:k + 16]))
    return part


def _chain_mm(mm, a, b):
    """a @ b as the chain kernel sums it: a zeroed partial per 16 of k."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 16):
        acc = acc + _partial(mm, a, b, k)
    return acc


def _slices(q, slices):
    """The pair ranges of a chunk's slices (the kernels' ``slice_len``)."""
    length = -(-(-(-q // slices)) // RED_STEP) * RED_STEP
    return [(s * length, min(q, (s + 1) * length)) for s in range(slices)]


def _fold(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _reduce_mm(mm, a, b, slices):
    """a^T @ b over the pair axis as the reduction kernel sums it."""
    parts = []
    for lo, hi in _slices(a.shape[0], slices):
        total = np.zeros((a.shape[1], b.shape[1]), np.float32)
        for s0 in range(lo, hi, RED_STEP * RED_SEG):
            seg = np.zeros_like(total)
            e = min(hi, s0 + RED_STEP * RED_SEG)
            at, bt = _np(a[s0:e].T), _np(b[s0:e])
            for k in range(0, e - s0, RED_PARTIAL):
                seg = seg + _partial(mm, at, bt, k)
            total = total + seg
        parts.append(total)
    return _fold(parts)


def _segments(lo, hi, m):
    """The pair ranges the sums kernel adds apart within a slice: each
    row's run of pairs, cut every ``SUM_SEG`` pairs."""
    for a in range(lo, hi):
        if a == lo or a % m == 0:
            b = min(hi, (a // m + 1) * m)
            yield from ((s, min(b, s + SUM_SEG)) for s in range(a, b, SUM_SEG))


def _seq_sum(x):
    """float32 sum over axis 0, one value after the other."""
    total = np.zeros(x.shape[1:], np.float32)
    for v in x:
        total = total + v
    return total


def _sums(dpre, r_last, coords_p, g_p, m, rows, slices):
    """dz (every layer), dW_first and dW_head as the CUDA-core sums kernel
    takes them: per slice, segment sums added to a row's (dz) or the
    slice's (dW) total, the slices added in order."""
    n_mod, h = len(dpre), dpre[0].shape[1]
    s_last = _sin(r_last)
    dz_parts, dwf_parts, dwh_parts = [], [], []
    for lo, hi in _slices(dpre[0].shape[0], slices):
        dz = np.zeros((n_mod, rows, h), np.float32)
        dwf = np.zeros((coords_p.shape[1], h), np.float32)
        dwh = np.zeros((h, g_p.shape[1]), np.float32)
        for a, b in _segments(lo, hi, m):
            for l in range(n_mod):
                dz[l, a // m] = dz[l, a // m] + _seq_sum(dpre[l][a:b])
            dwf = dwf + _seq_sum(coords_p[a:b, :, None] * dpre[0][a:b, None, :])
            dwh = dwh + _seq_sum(s_last[a:b, :, None] * g_p[a:b, None, :])
        dz_parts.append(dz)
        dwf_parts.append(dwf)
        dwh_parts.append(dwh)
    return _fold(dz_parts), _fold(dwf_parts), _fold(dwh_parts)


def _bwd_emulated(mm, coords, z, g, w_first, w_mid, w_head, slices=tsd.BWD_SLICES):
    """``decode_bwd_plain``'s walk with the kernels' products and sums."""
    n_mod, rows, h = z.shape
    m = coords.shape[0]
    z, w_first, w_mid, w_head = map(_np, (z, w_first, w_mid, w_head))
    row = np.repeat(np.arange(rows), m)
    coords_p = np.tile(_np(coords), (rows, 1))
    g_p = _np(g).reshape(rows * m, -1)
    pres = [coords_p @ w_first + z[0][row]]
    for l in range(1, n_mod):
        pres.append(_chain_mm(mm, _sin(pres[-1]), w_mid[l - 1]) + z[l][row])
    dpre = [None] * n_mod
    dx = g_p @ w_head.T
    for l in range(n_mod - 1, -1, -1):
        dpre[l] = dx * _dsin(pres[l])
        if l > 0:
            dx = _chain_mm(mm, dpre[l], np.ascontiguousarray(w_mid[l - 1].T))
    dw_mid = np.stack([_reduce_mm(mm, _sin(pres[l - 1]), dpre[l], slices)
                       for l in range(1, n_mod)])
    dz, dw_first, dw_head = _sums(dpre, pres[-1], coords_p, g_p, m, rows, slices)
    return tuple(map(torch.from_numpy, (dz, dw_first, dw_mid, dw_head)))


def _bwd_f64(coords, z, g, w_first, w_mid, w_head):
    """The same walk in float64 with exact sines: the truth."""
    coords, z, g, w_first, w_mid, w_head = (x.double() for x in
                                            (coords, z, g, w_first, w_mid, w_head))
    n_mod, _, h = z.shape
    sin = lambda r: torch.sin(2 * math.pi * r)
    pres = [(coords @ w_first)[None] + z[0][:, None, :]]
    for l in range(1, n_mod):
        pres.append(sin(pres[-1]) @ w_mid[l - 1] + z[l][:, None, :])
    dz, dw_mid = torch.empty_like(z), torch.empty_like(w_mid)
    dw_head = sin(pres[-1]).reshape(-1, h).t() @ g.reshape(-1, g.shape[-1])
    dx = g @ w_head.t()
    for l in range(n_mod - 1, -1, -1):
        dpre = dx * 2 * math.pi * torch.cos(2 * math.pi * pres[l])
        dz[l] = dpre.sum(dim=1)
        if l > 0:
            dw_mid[l - 1] = sin(pres[l - 1]).reshape(-1, h).t() @ dpre.reshape(-1, h)
            dx = dpre @ w_mid[l - 1].t()
    dw_first = coords.t() @ dpre.sum(dim=0)
    return dz, dw_first, dw_mid, dw_head


def _margins(mm, seed=0):
    """error / limit of every cotangent, folded and unfolded, under the
    kernels' criterion."""
    coords, latents, g, z, ops, w2, scale = _case(seed)
    with torch.no_grad():
        got = _bwd_emulated(mm, coords, z, g, *ops)
        plain = tsd.decode_bwd_plain(coords, z, g, *ops)
        truth = _bwd_f64(coords, z, g, *ops)
    names = ("dz", "dw_first", "dw_mid", "dw_head")
    sets = [dict(zip(names, x)) for x in (got, plain, truth)]
    for s, (lat, w, sc) in zip(sets, [(latents, w2, scale)] * 2 + [
            (latents.double(), w2.double(), scale)]):
        u = tsd.unfold_bwd(tuple(s[n] for n in names), lat, w, sc)
        s.update({k: u[k] for k in ("dlatents", "dW2", "db1")})
    margins = {}
    for name in sets[2]:
        x, pl, t = (s[name].double() for s in sets)
        margins[name] = ((x - t).abs().max() / (2 * (pl - t).abs().max()
                                                 + 1e-6 * t.abs().max())).item()
    return margins


def test_3xtf32_scheme_meets_the_f32_criterion():
    """3xTF32 chain and reduction products, with the kernels' partials,
    segments and slices, keep every cotangent within the criterion."""
    margins = _margins(_mm_3xtf32)
    assert max(margins.values()) <= 1.0, margins


def test_single_tf32_scheme_misses_the_f32_criterion():
    """One TF32 product per matmul is outside it: the split is needed."""
    margins = _margins(_mm_tf32)
    assert min(margins.values()) > 10.0, margins


def test_emulation_follows_the_plain_version():
    """The emulation's walk is the plain version's: with every product and
    sum exact in float32 order aside, the two agree to float32 noise."""
    coords, _, g, z, ops, _, _ = _case(1)
    f32 = lambda a, b: a @ b
    with torch.no_grad():
        got = _bwd_emulated(f32, coords, z, g, *ops)
        plain = tsd.decode_bwd_plain(coords, z, g, *ops)
    for a, b, name in zip(got, plain, ("dz", "dw_first", "dw_mid", "dw_head")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4 * b.abs().max().item(), err_msg=name)


@pytest.mark.parametrize("q,slices", [(256, 16), (65536, 16), (1000, 3), (31, 16), (4097, 16),
                                      (62000, 16)])
def test_slices_cover_the_chunk_once(q, slices):
    """The slices partition the chunk in order, each a whole number of
    reduction steps but the last."""
    ranges = _slices(q, slices)
    assert len(ranges) == slices
    covered = [i for lo, hi in ranges for i in range(lo, hi)]
    assert covered == list(range(q))
    assert all((hi - lo) % RED_STEP == 0 for lo, hi in ranges[:-1] if hi < q)


def test_reduction_constants_mirror_the_module():
    """The emulation's step and the module's mirror of the kernel's
    (``REDUCE_STEP``) agree, and a partial spans whole k8 steps within a
    step."""
    assert tsd.REDUCE_STEP == RED_STEP and RED_STEP % RED_PARTIAL == 0
    assert RED_PARTIAL % 8 == 0


def _image_index(cols):
    """Where the wgmma descriptor (no swizzle, K-major, 128-byte leading and
    256-byte stride offsets: ``csrc/hopper.cuh::b_desc``) reads
    element (pair k, column n) of a step's big image, in floats: K-slices
    of 16 pairs 4 x 32 x cols bytes apart, k8 steps 2 x 32 x cols, the small
    half 32 x cols after the big."""
    k, n = torch.meshgrid(torch.arange(RED_STEP), torch.arange(cols), indexing="ij")
    return ((k // 16) * 32 * cols + (k // 8 % 2) * 16 * cols + (n // 8) * 64 + (k % 8 // 4) * 32
            + (n % 8) * 4 + k % 4)


@pytest.mark.parametrize("h,q0,hi", [(128, 0, 32), (384, 64, 90), (1024, 32, 64),
                                     (3072, 0, 17), (320, 32, 64)])
def test_reduce_operand_layout(h, q0, hi):
    """The reduction's B image of one step for every column tile of a
    width (ragged at 320, zero past ``hi``): read back through the
    descriptor's addressing it gives dpre's TF32 halves exactly, every
    float of the image is read once, and the columns are 192 where they
    divide H, else 128."""
    cols = tsd.reduce_cols(h)
    assert cols == (192 if h % 192 == 0 else 128)
    rng = np.random.default_rng(h)
    d = torch.from_numpy(rng.standard_normal((q0 + 2 * RED_STEP, h)).astype(np.float32))
    halves = tsd.tf32_split(d)
    idx = _image_index(cols)
    assert torch.cat([idx.flatten(), idx.flatten() + 8 * cols]).unique().numel() == \
        2 * RED_STEP * cols
    rows = min(RED_STEP, hi - q0)
    for b0 in range(0, h, cols):
        image = tsd.reduce_operand_layout(d, q0, hi, b0, cols)
        assert image.numel() == 2 * RED_STEP * cols
        width = min(cols, h - b0)
        for half, want in enumerate(halves):
            expect = torch.zeros((RED_STEP, cols))
            expect[:rows, :width] = want[q0:q0 + rows, b0:b0 + width]
            assert torch.equal(image[idx + half * 8 * cols], expect)
