"""Flash attention: the port's CUDA kernels and their plain versions.

Counterpart of ``confild_tpu/ops/flash_attention.py``.  q, k, v are
``(BH, N, D)``; logits are scaled by ``1/sqrt(D)`` and the softmax runs in
float32.  The forward keeps the per-row logsumexp ``lse`` ``(BH, N)``; the
backward is the FlashAttention-2 two-pass recompute (``:12-20``): with
``delta = rowsum(dO * O)`` and ``P = exp(S - lse)`` rebuilt blockwise,

    dV = P^T dO,  dS = P * (dO V^T - delta),  dQ = scale dS K,  dK = scale dS^T Q.

Kernels (``csrc/flash_attention.cu``):

* ``flash_forward`` replaces ``_flash_kernel``: ``out`` and ``lse``;
* ``flash_bwd_dq`` replaces ``_bwd_dq_kernel``: ``dQ``;
* ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel``: ``dK`` and ``dV``.

All three kernels run their products on the tensor cores as 3xTF32 (each
float32 operand split into two TF32 halves, three products), which keeps
the float32 result within the same float64 criterion as the plain version
(``chip_smoke.py`` phase 10).  For bfloat16 inputs the kernels, like the
plain versions, round P to bfloat16 before P.V and before dV, and dS before
dQ and dK, as the JAX kernels do (``:80-81, 180, 210, 214``).

``delta`` is computed in torch, as the JAX package computes it outside its
kernels (``:233-234``).  The TPU kernels' block sizes and interpret mode are
Mosaic tiling and have no counterpart; ragged ``N`` is masked inside the
CUDA kernels, with no padded copy.  The kernels take a head width ``D`` of
32, 64 or 128: a narrower head is zero-padded to the next of these
(:func:`padded_forward`, :func:`padded_backward`), which changes no logit,
with the logits scaled by ``1/sqrt`` of the true width; wider heads raise.

Each kernel has a plain PyTorch version beside it.  A wrapper takes the
plain version only for CPU tensors; for CUDA tensors it launches its kernel
or raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from confild_tpu_torch.ops import cuda_build

LAUNCHES = {"flash_forward": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def reference_attention(q, k, v):
    """Dense attention, the counterpart of ``_reference_attention``: float32
    logits and softmax, the weights cast to ``v``'s type."""
    d = q.shape[-1]
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", weights.to(v.dtype), v)


def _operand(x, dtype):
    """P or dS as a product takes it: float32, rounded to bfloat16 first
    when the inputs are bfloat16 (the JAX kernels' ``astype``)."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def flash_forward_plain(q, k, v, scale=None):
    """The forward kernel's arithmetic in float32: ``(out, lse)``, ``out`` in
    the input type and ``lse`` float32 ``(BH, N)``.  Logits are scaled by
    ``scale`` (``1/sqrt(D)`` by default).  For bfloat16 inputs P is rounded
    to bfloat16 before P.V, relative to the row's max as in one JAX tile."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    if q.dtype == torch.bfloat16:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        out = (torch.einsum("bqk,bkd->bqd", _operand(p, q.dtype), v.float())
               / p.sum(dim=-1, keepdim=True))
    else:
        out = torch.einsum("bqk,bkd->bqd", torch.exp(s - lse[..., None]), v.float())
    return out.to(q.dtype), lse


def _delta(out, g):
    return (g.float() * out.float()).sum(dim=-1)


def flash_backward_plain(q, k, v, out, lse, g, scale=None):
    """The backward kernels' arithmetic in float32: ``P = exp(S - lse)``
    rebuilt from the saved logsumexp, then ``(dq, dk, dv)`` in the input
    type; for bfloat16 inputs P (for dV) and dS (for dQ, dK) are rounded to
    bfloat16 before their products."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.exp(torch.einsum("bqd,bkd->bqk", qf, kf) * scale - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", _operand(p, q.dtype), gf)
    ds = _operand(p * (torch.einsum("bqd,bkd->bqk", gf, vf) - _delta(out, g)[..., None]),
                  q.dtype)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_head_width(d: int) -> int:
    """The head width the kernels run a head of ``d`` channels at: the next
    of ``_HEAD_DIMS``."""
    for width in _HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"the CUDA flash kernels take a head width of at most "
                     f"{_HEAD_DIMS[-1]}, got {d}")


def _pad_head(t, width):
    return F.pad(t, (0, width - t.shape[-1])) if t.shape[-1] != width else t


def padded_forward(forward, q, k, v):
    """``forward(q, k, v, scale)`` on operands zero-padded to the kernels'
    head width (the zero columns add nothing to a logit), with the scale of
    the true width; ``(out, lse)`` with ``out`` sliced back."""
    d = q.shape[-1]
    width = kernel_head_width(d)
    out, lse = forward(*(_pad_head(t, width) for t in (q, k, v)), 1.0 / math.sqrt(d))
    return (out[..., :d].contiguous() if width != d else out), lse


def padded_backward(backward, q, k, v, out, lse, g):
    """``backward(q, k, v, out, lse, g, scale)`` on operands zero-padded to
    the kernels' head width, with the scale of the true width; the
    gradients sliced back."""
    d = q.shape[-1]
    width = kernel_head_width(d)
    grads = backward(*(_pad_head(t, width) for t in (q, k, v, out)), lse,
                     _pad_head(g, width), 1.0 / math.sqrt(d))
    return tuple(x[..., :d].contiguous() for x in grads) if width != d else grads


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared."""
    lib = cuda_build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_forward.argtypes = [p] * 5 + [i] * 4 + [f, p]
    lib.flash_forward.restype = i
    lib.flash_bwd_dq.argtypes = [p] * 7 + [i] * 4 + [f, p]
    lib.flash_bwd_dq.restype = i
    lib.flash_bwd_dkv.argtypes = [p] * 8 + [i] * 4 + [f, p]
    lib.flash_bwd_dkv.restype = i
    return lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(ref, **tensors) -> tuple[int, int, int, int]:
    """Device, type, shape and contiguity of the kernels' operands against
    ``ref`` (q); returns ``(BH, N, D, dtype code)``."""
    bh, n, d = ref.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernels take a head width of {_HEAD_DIMS}, got {d}")
    if ref.dtype not in _DTYPES:
        raise TypeError(f"the CUDA flash kernels take float32 or bfloat16, got {ref.dtype}")
    for name, t in tensors.items():
        want_dtype = torch.float32 if name in ("lse", "delta") else ref.dtype
        want_shape = (bh, n) if name in ("lse", "delta") else (bh, n, d)
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, q on {ref.device}")
        if t.dtype != want_dtype:
            raise TypeError(f"{name} must be {want_dtype}, got {t.dtype}")
        if tuple(t.shape) != want_shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want_shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return bh, n, d, _DTYPES[ref.dtype]


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _launch_forward(q, k, v, scale):
    """``(out, lse)`` on CUDA tensors of a kernel head width: launches
    ``flash_forward``."""
    bh, n, d, code = _check(q, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, n), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = _library().flash_forward(_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse),
                                       bh, n, d, code, _scale(q, scale), _stream(q.device))
    _raise_on(err, "flash_forward launch")
    LAUNCHES["flash_forward"] += 1
    return out, lse


def flash_forward(q, k, v):
    """``(out, lse)``.  CPU tensors take :func:`flash_forward_plain`; CUDA
    tensors launch ``flash_forward`` (on a head padded to the kernels'
    width, :func:`padded_forward`)."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v)
    return padded_forward(_launch_forward, q, k, v)


def bwd_dq(q, k, v, g, lse, delta, scale=None):
    """``dq`` on CUDA tensors of a kernel head width: launches
    ``flash_bwd_dq``."""
    bh, n, d, code = _check(q, q=q, k=k, v=v, g=g, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _library().flash_bwd_dq(_ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(lse),
                                      _ptr(delta), _ptr(dq), bh, n, d, code,
                                      _scale(q, scale), _stream(q.device))
    _raise_on(err, "flash_bwd_dq launch")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def bwd_dkv(q, k, v, g, lse, delta, scale=None):
    """``(dk, dv)`` on CUDA tensors of a kernel head width: launches
    ``flash_bwd_dkv``."""
    bh, n, d, code = _check(q, q=q, k=k, v=v, g=g, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _library().flash_bwd_dkv(_ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(lse),
                                       _ptr(delta), _ptr(dk), _ptr(dv), bh, n, d, code,
                                       _scale(q, scale), _stream(q.device))
    _raise_on(err, "flash_bwd_dkv launch")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _launch_backward(q, k, v, out, lse, g, scale):
    _check(q, out=out)
    delta = _delta(out, g).contiguous()
    return (bwd_dq(q, k, v, g, lse, delta, scale), *bwd_dkv(q, k, v, g, lse, delta, scale))


def flash_backward(q, k, v, out, lse, g):
    """``(dq, dk, dv)``.  CPU tensors take :func:`flash_backward_plain`;
    CUDA tensors launch ``flash_bwd_dq`` and then ``flash_bwd_dkv`` (on a
    head padded to the kernels' width, :func:`padded_backward`), with
    ``delta = rowsum(dO * O)`` from torch."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, g)
    return padded_backward(_launch_backward, q, k, v, out, lse, g)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward the dq and dk/dv kernels (on the CPU, the
    plain versions of both)."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_backward(q, k, v, out, lse, g.contiguous())


def flash_attention(q, k, v):
    """Online-softmax attention: q, k, v ``(BH, N, D)`` -> ``(BH, N, D)``."""
    return _FlashAttention.apply(q, k, v)
