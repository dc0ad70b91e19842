"""Port vs JAX package for flash attention on the CPU: the port's autograd
function (its plain versions, which the CUDA kernels repeat) against the
JAX Pallas kernels in interpret mode, at the JAX tests' shapes and
tolerances (``tests/test_flash_attention.py``), plus the wrapper's operand
checks."""

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
