"""Port vs JAX package for flash attention on the CPU: the port's autograd
function (its plain versions, which the CUDA kernels repeat) against the
JAX Pallas kernels in interpret mode, at the JAX tests' shapes and
tolerances (``tests/test_flash_attention.py``), plus the wrappers' operand
checks, the kernels' 3xTF32 numeric scheme, forward and backward (their
``wgmma`` partials, tiles and register operands' order, with the tensor
cores' truncating sums), against float64, and the kernels' plans and
transposed operand images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu.ops import flash_attention as jfa
from confild_tpu_torch.ops import flash_attention as tfa
from torch_parity_utils import limit_torch_threads

# f32 both sides; the JAX kernel sums blockwise (128-wide tiles), the plain
# version in one einsum
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _inputs(bh, n, d, seed=0, count=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, n, d)).astype(np.float32) for _ in range(count)]


def _port_grads(q, k, v, w, dtype=torch.float32):
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, [x.grad for x in leaves]


def _jax_grads(q, k, v, w):
    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, 128, 128, True) * w)
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("bh,n,d", [(4, 256, 64), (4, 512, 32), (2, 200, 32), (64, 144, 64)])
def test_forward_matches_jax(bh, n, d):
    q, k, v = _inputs(bh, n, d, count=3)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          128, 128, True))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    ref = tfa.reference_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(ref.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("n", [256, 200])
def test_forward_lse_matches_jax(n):
    """The saved logsumexp, ragged N included (the JAX forward pads to its
    block and slices)."""
    q, k, v = _inputs(2, n, 32, seed=1, count=3)
    _, want = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, 128, True)
    _, got = tfa.flash_forward_plain(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (2, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("bh,n,d", [(1, 128, 32), (2, 256, 32), (2, 200, 32), (8, 144, 64)])
def test_gradients_match_jax(bh, n, d):
    """dQ, dK, dV through the port's autograd function (plain backward) vs
    the JAX Pallas backward; N = 200 leaves a ragged block in the JAX
    kernels."""
    q, k, v, w = _inputs(bh, n, d, seed=2)
    _, got = _port_grads(q, k, v, w)
    want = _jax_grads(q, k, v, w)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}", **GRAD_TOL)


def test_backward_plain_matches_jax_backward():
    """``flash_backward_plain`` against ``_flash_backward`` on the same
    residuals (out, lse) and cotangent."""
    q, k, v, g = _inputs(2, 200, 32, seed=3)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = jfa._flash_forward(jq, jk, jv, 128, 128, True)
    want = jfa._flash_backward(jq, jk, jv, out, lse, jg, 128, 128, True)
    got = tfa.flash_backward_plain(*map(torch.from_numpy, (q, k, v, np.array(out),
                                                           np.array(lse), g)))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}", **GRAD_TOL)


def test_bf16_inputs():
    """bf16 in, bf16 out, f32 softmax: the JAX test's tolerance against the
    JAX kernel, and bf16 gradients."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 256, 64)).astype(np.float32) for _ in range(3))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jfa.flash_attention(*jb, 128, 128, True), np.float32)
    tb = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16().requires_grad_(True)
          for a in jb]
    out = tfa.flash_attention(*tb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(), want, rtol=2e-2, atol=2e-2)
    out.float().sum().backward()
    assert tb[0].grad.dtype == torch.bfloat16 and torch.isfinite(tb[0].grad.float()).all()
    jg = jax.grad(lambda q: jnp.sum(jfa.flash_attention(q, jb[1], jb[2], 128, 128, True)
                                    .astype(jnp.float32)))(jb[0])
    np.testing.assert_allclose(tb[0].grad.float().numpy(), np.asarray(jg, np.float32),
                               rtol=5e-2, atol=5e-2)


# bf16 rounding of P and dS: mean |port - JAX| / mean |JAX| on every output.
# With one JAX tile (block 256 >= N) the JAX kernel rounds P relative to the
# row's max, as the plain version does, so the two agree to f32 summation
# order (about 1e-7; a bf16 rounding flips now and then).  Keeping P and dS
# in f32, as the port did before, misses this by about 100x (1.4e-3 to
# 1.7e-3 on every output at these shapes).
BF16_ROUNDING_TOL = 1e-5


@pytest.mark.parametrize("bh,n,d", [(2, 256, 64), (4, 144, 64)])
def test_bf16_rounds_p_and_ds_as_jax(bh, n, d):
    """Forward and backward on bf16 inputs against the JAX kernels in
    interpret mode with one key tile, on the same residuals and cotangent."""
    rng = np.random.default_rng(4)
    jb = [jnp.asarray(rng.standard_normal((bh, n, d)), jnp.bfloat16) for _ in range(4)]
    j_out, j_lse = jfa._flash_forward(*jb[:3], 256, 256, True)
    want = [j_out, *jfa._flash_backward(*jb[:3], j_out, j_lse, jb[3], 256, 256, True)]
    tb = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in jb]
    out, _ = tfa.flash_forward_plain(*tb[:3])
    grads = tfa.flash_backward_plain(*tb[:3], torch.from_numpy(np.asarray(j_out, np.float32))
                                     .bfloat16(), torch.from_numpy(np.asarray(j_lse)), tb[3])
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads), want):
        assert a.dtype == torch.bfloat16
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        rel = np.abs(a - b).mean() / np.abs(b).mean()
        assert rel <= BF16_ROUNDING_TOL, (name, rel)


@pytest.mark.parametrize("d", [16, 48])
def test_head_padding_is_exact(d):
    """A head narrower than the kernels' widths is zero-padded and the
    outputs sliced back: the plain versions through the padding functions
    equal the plain versions at the true width (1e-6)."""
    q, k, v, g = map(torch.from_numpy, _inputs(2, 96, d, seed=6))
    out, lse = tfa.flash_forward_plain(q, k, v)
    p_out, p_lse = tfa.padded_forward(tfa.flash_forward_plain, q, k, v)
    assert p_out.shape == out.shape == (2, 96, d)
    torch.testing.assert_close(p_out, out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(p_lse, lse, rtol=1e-6, atol=1e-6)
    want = tfa.flash_backward_plain(q, k, v, out, lse, g)
    got = tfa.padded_backward(tfa.flash_backward_plain, q, k, v, out, lse, g)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_head_width_limit():
    """Up to 128 the next of 32, 64, 128; above, the next multiple of 128
    (the column-group kernels), with no upper limit; the kernels' checks
    take only those widths, so 160 is padded before it reaches them."""
    assert [tfa.kernel_head_width(d) for d in (8, 32, 33, 64, 100, 128)] == [32, 32, 64, 64,
                                                                               128, 128]
    assert [tfa.kernel_head_width(d) for d in (129, 160, 256, 257, 512, 1000, 4096)] == [
        256, 256, 256, 384, 512, 1024, 4096]
    with pytest.raises(ValueError, match="head width"):
        tfa._check(torch.zeros(2, 16, 160), q=torch.zeros(2, 16, 160))
    assert tfa._check(torch.zeros(2, 16, 384), q=torch.zeros(2, 16, 384))[2] == 384


def test_launch_counts_untouched_on_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    tfa.reset_launch_counts()
    q, k, v, w = _inputs(1, 64, 32, seed=5)
    _port_grads(q, k, v, w)
    assert tfa.LAUNCHES == {"flash_forward": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


@pytest.mark.parametrize("case,exc,match", [
    ("head_width", ValueError, "head width"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("lse_dtype", TypeError, "lse must be"),
    ("shape", ValueError, "shape"),
    ("strided", ValueError, "contiguous"),
    ("device", ValueError, "is on"),
])
def test_kernel_operand_checks(case, exc, match):
    """What the CUDA wrappers refuse before any launch."""
    q = torch.zeros(2, 16, 64)
    ops = {"q": q, "k": q.clone(), "v": q.clone(), "lse": torch.zeros(2, 16)}
    if case == "head_width":
        ops = {k: torch.zeros(2, 16, 48) for k in "qkv"}
    elif case == "dtype":
        ops = {k: torch.zeros(2, 16, 64, dtype=torch.float64) for k in "qkv"}
    elif case == "lse_dtype":
        ops["lse"] = torch.zeros(2, 16, dtype=torch.bfloat16)
    elif case == "shape":
        ops["v"] = torch.zeros(2, 17, 64)
    elif case == "strided":
        ops["k"] = torch.zeros(2, 64, 16).transpose(1, 2)
    else:
        ops["v"] = torch.zeros(2, 16, 64, device="meta")
    with pytest.raises(exc, match=match):
        tfa._check(ops["q"], **ops)


# ---------------------------------------------------------------------------
# the kernels' numeric scheme: 3xTF32 products on the tensor cores
# ---------------------------------------------------------------------------

def _rna_tf32(x):
    """float32 -> TF32 (10 stored mantissa bits), to nearest with ties away
    from zero: ``cvt.rna.tf32.f32`` on finite values, by bit arithmetic as
    the kernels do it."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    big = _rna_tf32(x)
    return big, _rna_tf32(x - big)


def _mm_3xtf32(a, b):
    """a @ b as small*big + big*small + big*big, float32 sums (each TF32
    product is exact in float32)."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    mm = lambda x, y: (torch.from_numpy(x) @ torch.from_numpy(y)).numpy()
    return (mm(as_, bb) + mm(ab, bs)) + mm(ab, bb)


def _mm_tf32(a, b):
    """a @ b with each operand rounded to TF32 once (a plain TF32 product)."""
    return (torch.from_numpy(_rna_tf32(a)) @ torch.from_numpy(_rna_tf32(b))).numpy()


def _f64_backward(q, k, v, g):
    q, k, v, g = (x.astype(np.float64) for x in (q, k, v, g))
    s = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bqk,bkd->bqd", p, v)
    ds = p * (np.einsum("bqd,bkd->bqk", g, v) - (g * out).sum(-1, keepdims=True))
    scale = 1.0 / np.sqrt(q.shape[-1])
    return (np.einsum("bqk,bkd->bqd", ds, k) * scale, np.einsum("bqk,bqd->bkd", ds, q) * scale,
            np.einsum("bqk,bqd->bkd", p, g))


def _tc_add(c, a, b):
    """``c + a @ b`` as the tensor cores add one k-step of a product: the
    products exact, every addend (``c`` among them) cut toward zero to 24
    significant bits below the largest one's exponent, the sum cut toward
    zero to float32 (the truncation the kernels' partials guard against)."""
    terms = np.concatenate([c.astype(np.float64)[:, None, :],
                            a.astype(np.float64)[:, :, None] * b.astype(np.float64)[None]], axis=1)
    top = np.abs(terms).max(axis=1, keepdims=True)
    quantum = np.exp2(np.floor(np.log2(np.where(top > 0, top, 1.0))) - 23)
    total = (np.trunc(terms / quantum) * quantum).sum(axis=1)
    out = total.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(total)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def _tc_product(a, b, k_step, carry, split):
    """``a @ b`` as the forward kernel's ``wgmma`` runs it: k-steps of
    ``k_step``, each three TF32 products (small.big, big.small, big.big;
    ``split``) or one of operands rounded to TF32 once, into a zeroed
    partial that a float32 add carries into the sum every ``carry`` k-steps."""
    if split:
        (ab, as_), (bb, bs) = _split(a), _split(b)
        terms = lambda sl: ((as_[:, sl], bb[sl]), (ab[:, sl], bs[sl]), (ab[:, sl], bb[sl]))
    else:
        ar, br = _rna_tf32(a), _rna_tf32(b)
        terms = lambda sl: ((ar[:, sl], br[sl]),)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    steps = range(0, a.shape[1], k_step)
    for i, k0 in enumerate(steps):
        if i % carry == 0:
            part = np.zeros_like(total)
        for x, y in terms(slice(k0, k0 + k_step)):
            part = _tc_add(part, x, y)
        if (i + 1) % carry == 0 or i + 1 == len(steps):
            total = total + part
    return total


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as ``fmaf``."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


# P.V's k index within a k8 step: index t is key 2t, index t + 4 key 2t + 1
# (the order of P's register fragment; V's image holds its keys so)
PV_KEY_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def _forward_with(split, q, k, v, rescale_first=False):
    """The forward kernel's loop head by head (csrc/flash_attention.cu):
    tiles of ``forward_plan``'s keys; S = Q K^T on the tensor cores with a
    partial carried every k16 step (two k8 steps); a running max in log2
    units (the tile's largest raw logit times scale log2 e); P = 2^(S scale
    log2 e - m), one fma into the exponential; P.V over the tile's keys, taken in
    ``PV_KEY_ORDER`` within each k8 step, into one partial carried as
    acc = fma(acc, alpha, partial).  The sum l is kept as the kernel keeps
    it: lane t of a row's quad holds keys 8j + 2t + e of each tile, adds them
    in order into a tile sum and that into its running sum by an fma, and
    the four lanes' sums are added pairwise at the end; out = acc * (1 / l),
    lse = m ln 2 + ln l, all in float32.  ``rescale_first``: acc = acc *
    alpha, then + partial (the column-group kernel above 128)."""
    d = q.shape[-1]
    kt = tfa.forward_plan(d, torch.float32)["keys"]
    log2e = np.float32(1.4426950408889634)
    scale2 = np.float32(1.0 / np.sqrt(d)) * log2e
    outs, lses = [], []
    for b in range(q.shape[0]):
        n = q.shape[1]
        m = np.full(n, -np.inf, np.float32)
        lanes = np.zeros((n, 4), np.float32)
        acc = np.zeros((n, d), np.float32)
        for k0 in range(0, n, kt):
            valid = min(kt, n - k0)
            kb = np.zeros((kt, d), np.float32)
            vb = np.zeros((kt, d), np.float32)
            kb[:valid], vb[:valid] = k[b, k0:k0 + valid], v[b, k0:k0 + valid]
            s = _tc_product(q[b], np.ascontiguousarray(kb.T), 8, 2, split)
            s[:, valid:] = -np.inf
            m_new = np.maximum(m, s.max(-1) * scale2)
            alpha = np.exp2(m - m_new)
            p = np.exp2(_fma32(s, scale2, -m_new[:, None]))
            by_lane = p.reshape(n, kt // 8, 4, 2)     # [row, j, t, e]
            tile_sum = np.zeros((n, 4), np.float32)
            for j in range(kt // 8):
                for e in range(2):
                    tile_sum = tile_sum + by_lane[:, j, :, e]
            lanes = _fma32(alpha[:, None], lanes, tile_sum)
            order = (np.arange(0, kt, 8)[:, None] + PV_KEY_ORDER).ravel()
            pv = _tc_product(p[:, order], vb[order], 8, kt // 8, split)
            acc = acc * alpha[:, None] + pv if rescale_first else _fma32(acc, alpha[:, None], pv)
            m = m_new
        l = (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])
        outs.append(acc * (np.float32(1) / l)[:, None])
        lses.append(m * np.float32(0.6931471805599453) + np.log(l))
    return np.stack(outs), np.stack(lses)


def _forward_margins(split, bh, n, d, seed, rescale_first=False):
    """error / limit of out and lse under the kernels' criterion."""
    q, k, v = _inputs(bh, n, d, seed=seed, count=3)
    plain = [x.numpy() for x in tfa.flash_forward_plain(*map(torch.from_numpy, (q, k, v)))]
    got = _forward_with(split, q, k, v, rescale_first)
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(d)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    truth = (np.einsum("bqk,bkd->bqd", np.exp(s - lse[..., None]), v.astype(np.float64)), lse)
    return [np.abs(x - t).max() / (2 * np.abs(pl - t).max() + 1e-6 * np.abs(t).max())
            for x, pl, t in zip(got, plain, truth)]


@pytest.mark.parametrize("bh,n,d", [(2, 200, 32), (8, 144, 64), (2, 144, 128)])
def test_3xtf32_forward_meets_the_f32_criterion(bh, n, d):
    """3xTF32 products with the forward kernel's partials, tiles and online
    softmax keep out and lse within the criterion the CUDA kernel is held to
    on the card (the ragged last key tile included at N = 200; tiles of 64
    keys, 16 at D = 128)."""
    margins = _forward_margins(True, bh, n, d, seed=7)
    assert max(margins) <= 1.0, margins


def test_single_tf32_forward_misses_the_f32_criterion():
    """One TF32 product per k8 step puts out and lse far outside it."""
    margins = _forward_margins(False, 8, 144, 64, seed=7)
    assert min(margins) > 10.0, margins


def _tiles(x, row0, rows):
    """Rows ``row0 .. row0 + rows - 1`` of ``x``, zeros past its end, and
    how many are real."""
    valid = min(rows, x.shape[0] - row0)
    out = np.zeros((rows, x.shape[1]), np.float32)
    out[:valid] = x[row0:row0 + valid]
    return out, valid


def _register_order(st):
    """The order in which a register A operand of ``st`` columns meets the
    rows of its transposed B image: ``PV_KEY_ORDER`` within each k8 step."""
    return (np.arange(0, st, 8)[:, None] + PV_KEY_ORDER).ravel()


def _backward_with(split, q, k, v, g, lse, delta):
    """The backward kernels' loops head by head (csrc/flash_attention.cu):
    tiles of ``backward_plan``'s streamed rows; S = Q K^T and dP = dO V^T
    (dk/dv: S^T = K Q^T, dP^T = V dO^T) on the tensor cores with a partial
    carried every k16 step; P = 2^(S scale log2 e - lse log2 e), one fma
    into the exponential (+inf for lse past N in dk/dv: P = 0); dS = P (dP
    - delta); dQ += dS K, dV += P^T dO, dK += dS^T Q over the tile's rows,
    taken in ``PV_KEY_ORDER`` within each k8 step, into one partial a tile
    that a float32 add carries; dQ and dK times scale at the end.  ``split``:
    3xTF32 products, else one TF32 product a k8 step."""
    n, d = q.shape[1], q.shape[2]
    log2e = np.float32(1.4426950408889634)
    scale = np.float32(1.0 / np.sqrt(d))
    scale2 = scale * log2e
    st_q = tfa.backward_plan(d, torch.float32, "dq")["tile"]
    st_kv = tfa.backward_plan(d, torch.float32, "dkv")["tile"]
    grads = []
    for b in range(q.shape[0]):
        lse2 = lse[b] * log2e
        dq = np.zeros((n, d), np.float32)
        for k0 in range(0, n, st_q):
            kb, valid = _tiles(k[b], k0, st_q)
            vb, _ = _tiles(v[b], k0, st_q)
            s = _tc_product(q[b], np.ascontiguousarray(kb.T), 8, 2, split)
            dp = _tc_product(g[b], np.ascontiguousarray(vb.T), 8, 2, split)
            s[:, valid:] = -np.inf
            p = np.exp2(_fma32(s, scale2, -lse2[:, None]))
            ds = p * (dp - delta[b][:, None])
            order = _register_order(st_q)
            dq = dq + _tc_product(ds[:, order], kb[order], 8, st_q // 8, split)
        dk = np.zeros((n, d), np.float32)
        dv = np.zeros((n, d), np.float32)
        for q0 in range(0, n, st_kv):
            qb, valid = _tiles(q[b], q0, st_kv)
            gb, _ = _tiles(g[b], q0, st_kv)
            l2 = np.full(st_kv, np.inf, np.float32)
            dl = np.zeros(st_kv, np.float32)
            l2[:valid], dl[:valid] = lse2[q0:q0 + valid], delta[b][q0:q0 + valid]
            st = _tc_product(k[b], np.ascontiguousarray(qb.T), 8, 2, split)
            dpt = _tc_product(v[b], np.ascontiguousarray(gb.T), 8, 2, split)
            pt = np.exp2(_fma32(st, scale2, -l2[None, :]))
            dst = pt * (dpt - dl[None, :])
            order = _register_order(st_kv)
            dv = dv + _tc_product(pt[:, order], gb[order], 8, st_kv // 8, split)
            dk = dk + _tc_product(dst[:, order], qb[order], 8, st_kv // 8, split)
        grads.append((dq * scale, dk * scale, dv))
    return [np.stack(x) for x in zip(*grads)]


def _scheme_margins(split, bh, n, d, seed):
    """error / limit of dq, dk, dv under the kernels' criterion
    ``|x - f64| <= 2 |plain f32 - f64| + 1e-6 max|f64|``."""
    q, k, v, g = _inputs(bh, n, d, seed=seed)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = tfa.flash_forward_plain(tq, tk, tv)
    plain = [x.numpy() for x in tfa.flash_backward_plain(tq, tk, tv, out, lse, tg)]
    delta = tfa._delta(out, tg).numpy()
    got = _backward_with(split, q, k, v, g, lse.numpy(), delta)
    truth = _f64_backward(q, k, v, g)
    return [np.abs(x - t).max() / (2 * np.abs(pl - t).max() + 1e-6 * np.abs(t).max())
            for x, pl, t in zip(got, plain, truth)]


@pytest.mark.parametrize("bh,n,d", [(2, 200, 32), (8, 144, 64), (2, 144, 128)])
def test_3xtf32_backward_meets_the_f32_criterion(bh, n, d):
    """3xTF32 products with the backward kernels' partials, tiles and
    register operands keep dq, dk, dv within the criterion the CUDA kernels
    are held to on the card (a ragged last tile at N = 200; 64-, 32- and
    16-row tiles at D = 32, 64 and 128)."""
    margins = _scheme_margins(True, bh, n, d, seed=6)
    assert max(margins) <= 1.0, margins


def test_single_tf32_backward_misses_the_f32_criterion():
    """One TF32 product a k8 step is far outside it: the split is needed."""
    margins = _scheme_margins(False, 8, 144, 64, seed=6)
    assert min(margins) > 10.0, margins


def test_tensor_core_truncation_model():
    """``_tc_add`` cuts toward zero where float32 rounds to nearest, and is
    exact where the sum fits in 24 bits."""
    c = np.array([[1.0]], np.float32)
    a = np.array([[2.0 ** -24, 2.0 ** -24]], np.float32)
    b = np.ones((2, 1), np.float32)
    assert _tc_add(c, a, b)[0, 0] == np.float32(1.0)            # 1 + 2^-23 cut away
    assert (c + a @ b)[0, 0] == np.float32(1 + 2.0 ** -23)     # float32 keeps it
    x = np.random.default_rng(0).integers(-64, 64, (4, 8)).astype(np.float32)
    y = np.random.default_rng(1).integers(-64, 64, (8, 3)).astype(np.float32)
    np.testing.assert_array_equal(_tc_add(np.zeros((4, 3), np.float32), x, y), x @ y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_v_image_gives_back_pv(dtype, d):
    """V's image (``v_image_keys`` at ``image_offset``), read back as the
    P.V ``wgmma`` reads its B operand, times P's register fragment as the
    kernel forms it from the S accumulator (float32: key 2t of a k8 step as
    index t, 2t + 1 as t + 4; bf16: in order) is P.V exactly, and the image
    holds every (key, column) of the tile once."""
    plan = tfa.forward_plan(d, dtype)
    kt, size = plan["keys"], 4 if dtype == torch.float32 else 2
    epc = 16 // size                       # elements a chunk; a k-step is two
    halves = 2 if dtype == torch.float32 else 1
    rng = np.random.default_rng(d)
    p = rng.integers(-8, 8, (64, kt)).astype(np.float64)
    v = rng.integers(-8, 8, (kt, d)).astype(np.float64)
    slots = {}
    for col in range(d):
        for ck in range(kt // epc):
            for e, key in enumerate(tfa.v_image_keys(dtype, ck)):
                slot = tfa.image_offset(col, ck, d, halves) // size + e
                assert slot not in slots
                slots[slot] = (key, col)
    assert sorted(slots.values()) == [(key, col) for key in range(kt) for col in range(d)]
    image = {slot: v[key, col] for slot, (key, col) in slots.items()}
    got = np.zeros((64, d))
    for c in range(kt // (2 * epc)):       # k-steps
        for kappa in range(2 * epc):
            if dtype == torch.float32:     # P's fragment index kappa of k8 step c
                key = 8 * c + (2 * kappa if kappa < 4 else 2 * (kappa - 4) + 1)
            else:
                key = 16 * c + kappa
            b_row = [image[tfa.image_offset(n, 2 * c + kappa // epc, d, halves) // size
                           + kappa % epc] for n in range(d)]
            got += np.outer(p[:, key], b_row)
    np.testing.assert_array_equal(got, p @ v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_forward_plan_fits(dtype, d):
    """Every instantiation's plan fits a block's shared memory with two
    image stages, at least one raw stage and whole k16 steps a tile; the
    plans the kernel's note states."""
    plan = tfa.forward_plan(d, dtype)
    assert 1 <= plan["raw_stages"] <= 4 and plan["keys"] % 16 == 0
    assert plan["image_stages"] == 2 and plan["smem"] <= tfa.FWD_SMEM_LIMIT
    want = {(32, torch.float32): (64, 4, 164032), (64, torch.float32): (64, 1, 229568),
            (128, torch.float32): (16, 2, 229568), (32, torch.bfloat16): (64, 4, 57536),
            (64, torch.bfloat16): (64, 4, 114880), (128, torch.bfloat16): (64, 4, 229568)}
    assert (plan["keys"], plan["raw_stages"], plan["smem"]) == want[(d, dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_backward_images_give_back_products(dtype, d):
    """The backward's transposed images (dq: K^T; dk/dv: Q^T and dO^T), one
    tile of ``backward_plan``'s rows at ``image_offset`` in ``v_image_keys``'
    order, read back as the ``wgmma`` of dQ += dS K, dK += dS^T Q and dV +=
    P^T dO reads its B operand (a descriptor a k-step block, 64 output
    columns at a time in float32 at D = 128), times the register operand as
    the kernels form it from their accumulators (float32: column 2t of a k8
    step as index t, 2t + 1 as t + 4; bf16: in order), give back the
    products exactly, and each image holds every (row, column) of the tile
    once."""
    f32 = dtype == torch.float32
    size, halves = (4, 2) if f32 else (2, 1)
    epc = 16 // size                       # elements a chunk; a k-step is two
    nh = min(d, 64) if f32 else d          # output columns a product
    rng = np.random.default_rng(d + 7)
    for kernel in tfa.BWD_KERNELS:
        st = tfa.backward_plan(d, dtype, kernel)["tile"]
        for operand in ("K", ) if kernel == "dq" else ("Q", "dO"):
            x = rng.integers(-8, 8, (64, st)).astype(np.float64)   # dS, dS^T or P^T
            m = rng.integers(-8, 8, (st, d)).astype(np.float64)    # K, Q or dO tile
            slots = {}
            for col in range(d):
                for ck in range(st // epc):
                    for e, row in enumerate(tfa.v_image_keys(dtype, ck)):
                        slot = tfa.image_offset(col, ck, d, halves) // size + e
                        assert slot not in slots, (kernel, operand)
                        slots[slot] = (row, col)
            assert sorted(slots.values()) == [(r, c) for r in range(st) for c in range(d)]
            image = {slot: m[row, col] for slot, (row, col) in slots.items()}
            got = np.zeros((64, d))
            for h in range(d // nh):
                start = h * (nh // 8) * 256    # the descriptor's start, bytes
                for c in range(st // (2 * epc)):           # k-steps
                    block = start + c * d * 32 * halves
                    for kappa in range(2 * epc):
                        if f32:            # the fragment's index kappa of k8 step c
                            row = 8 * c + (2 * kappa if kappa < 4 else 2 * (kappa - 4) + 1)
                        else:
                            row = 16 * c + kappa
                        ck = kappa // epc
                        b_row = [image[(block + (n >> 3) * 256 + ck * 128 + (n & 7) * 16)
                                       // size + kappa % epc] for n in range(nh)]
                        got[:, h * nh:(h + 1) * nh] += np.outer(x[:, row], b_row)
            np.testing.assert_array_equal(got, x @ m, err_msg=f"{kernel} {operand}")


# the backward's plans: (rows, consumer warpgroups, tile, raw stages, image
# stages, bytes) of dq and dk/dv, as csrc/flash_attention.cu's note states
BACKWARD_PLANS = {
    (32, torch.float32): ((64, 1, 64, 4, 2, 196800), (64, 1, 64, 4, 2, 230592)),
    (64, torch.float32): ((64, 1, 32, 4, 2, 229568), (64, 1, 32, 2, 2, 230080)),
    (128, torch.float32): ((64, 1, 16, 0, 2, 229568), (64, 1, 16, 2, 1, 229680)),
    (32, torch.bfloat16): ((128, 2, 64, 4, 2, 73920), (128, 2, 64, 4, 2, 83136)),
    (64, torch.bfloat16): ((128, 2, 64, 4, 2, 147648), (128, 2, 64, 4, 2, 165056)),
    (128, torch.bfloat16): ((128, 2, 64, 2, 2, 229568), (128, 2, 32, 4, 2, 197312)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_backward_plan_fits(dtype, d):
    """Each of the 12 backward instantiations' plans fits a block's shared
    memory (232,448 bytes) with whole k16 steps a tile and whole 16-byte
    chunks a producer thread in every image, 64 rows a consumer warpgroup,
    one or two image stages; the plans the kernels' note states."""
    size = 4 if dtype == torch.float32 else 2
    for kernel, want in zip(tfa.BWD_KERNELS, BACKWARD_PLANS[(d, dtype)]):
        plan = tfa.backward_plan(d, dtype, kernel)
        assert plan["smem"] <= tfa.FWD_SMEM_LIMIT and plan["tile"] % 16 == 0
        assert plan["rows"] == 64 * plan["consumers"] and plan["consumers"] in (1, 2)
        assert 1 <= plan["image_stages"] <= 2 and 0 <= plan["raw_stages"] <= 4
        assert plan["tile"] * (d * size // 16) % 128 == 0          # the K-major images
        assert (d * plan["tile"] // (4 if size == 4 else 16)) % 128 == 0   # the transposed
        assert tuple(plan.values()) == want, (kernel, plan)


@pytest.mark.parametrize("case,exc,match", [
    ("head_width", ValueError, "head width"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("out_dtype", TypeError, "out must be"),
    ("g_shape", ValueError, "shape"),
    ("lse_dtype", TypeError, "lse must be"),
    ("lse_shape", ValueError, "lse has shape"),
    ("strided", ValueError, "contiguous"),
    ("device", ValueError, "is on"),
])
def test_backward_wrapper_checks(case, exc, match):
    """The backward's wrapper checks every operand once, before any launch,
    and refuses what ``_check`` refuses, with its message."""
    q = torch.zeros(2, 16, 64)
    ops = {"q": q, "k": q.clone(), "v": q.clone(), "out": q.clone(), "lse": torch.zeros(2, 16),
           "g": q.clone()}
    if case == "head_width":
        ops.update({name: torch.zeros(2, 16, 48) for name in ("q", "k", "v", "out", "g")})
    elif case == "dtype":
        ops.update({name: torch.zeros(2, 16, 64, dtype=torch.float64)
                    for name in ("q", "k", "v", "out", "g")})
    elif case == "out_dtype":
        ops["out"] = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    elif case == "g_shape":
        ops["g"] = torch.zeros(2, 17, 64)
    elif case == "lse_dtype":
        ops["lse"] = torch.zeros(2, 16, dtype=torch.bfloat16)
    elif case == "lse_shape":
        ops["lse"] = torch.zeros(2, 17)
    elif case == "strided":
        ops["g"] = torch.zeros(2, 64, 16).transpose(1, 2)
    else:
        ops["k"] = torch.zeros(2, 16, 64, device="meta")
    with pytest.raises(exc, match=match):
        tfa._launch_backward(ops["q"], ops["k"], ops["v"], ops["out"], ops["lse"], ops["g"],
                             None)


@pytest.mark.parametrize("case,exc,match", [
    ("head_width", ValueError, "head width"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("shape", ValueError, "shape"),
    ("strided", ValueError, "contiguous"),
    ("device", ValueError, "is on"),
    ("v_dtype", TypeError, "v must be"),
])
def test_forward_wrapper_checks(case, exc, match):
    """The forward's wrapper refuses what ``_check`` refuses, with its
    message, before any launch."""
    q = torch.zeros(2, 16, 64)
    ops = {"q": q, "k": q.clone(), "v": q.clone()}
    if case == "head_width":
        ops = {k: torch.zeros(2, 16, 48) for k in "qkv"}
    elif case == "dtype":
        ops = {k: torch.zeros(2, 16, 64, dtype=torch.float64) for k in "qkv"}
    elif case == "shape":
        ops["v"] = torch.zeros(2, 17, 64)
    elif case == "strided":
        ops["k"] = torch.zeros(2, 64, 16).transpose(1, 2)
    elif case == "device":
        ops["v"] = torch.zeros(2, 16, 64, device="meta")
    else:
        ops["v"] = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(exc, match=match):
        tfa._launch_forward(ops["q"], ops["k"], ops["v"], None)


def test_no_grad_forward_skips_the_autograd_function():
    """Without a gradient to take, ``flash_attention`` returns the forward's
    output as the autograd route does, with no graph."""
    q, k, v = map(torch.from_numpy, _inputs(2, 96, 32, seed=8, count=3))
    with torch.no_grad():
        fast = tfa.flash_attention(q, k, v)
    slow = tfa.flash_attention(*(t.clone().requires_grad_(True) for t in (q, k, v)))
    assert fast.grad_fn is None and slow.grad_fn is not None
    torch.testing.assert_close(fast, slow.detach(), rtol=0, atol=0)


def test_rna_tf32_rounding():
    """Ties away from zero at the 13th bit, carries into the exponent, exact
    on TF32 values, and big + small reproduces x to about 22 bits."""
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 2 - 2.0 ** -23, 0.75,
                  -3.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1.0, 2.0, 0.75, -3.0], np.float32)
    np.testing.assert_array_equal(_rna_tf32(x), want)
    r = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    big, small = _split(r)
    assert np.all(np.abs(r - _rna_tf32(r)) <= np.abs(r) * 2.0 ** -11)
    assert np.all(np.abs(r.astype(np.float64) - big - small) <= np.abs(r) * 2.0 ** -22)
