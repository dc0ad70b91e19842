"""SIREN-FiLM decode: the port's CUDA kernels and their plain versions.

The decode is a stack of ``x = sin(w0 * (x @ W1_l + z_l))`` layers over
``T x M`` (latent rows x mesh points) pairs, ``z_l = latents @ W2_l + b1_l``.
As in the JAX package (``confild_tpu/ops/siren_decode.py:143-214``), the
FiLM table ``z`` is computed outside the kernel and ``w0 / (2*pi)`` is
folded into the first and middle weights and into ``z``, so the activation
is ``sin2pi(r) = sin(2*pi*r)``, a round-reduce plus an odd minimax
polynomial.

Kernels:

* ``siren_decode_forward`` (``csrc/siren_decode.cu``) replaces
  ``_decode_kernel``: the full forward.
* ``siren_decode_dz`` (same file) replaces ``_decode_dz_kernel``:
  ``dL/dz`` for every layer, from which ``dL/dlatents`` is two small
  matmuls.
* ``siren_decode_bwd`` (``csrc/siren_decode_bwd.cu``) replaces
  ``_decode_bwd_kernel``: every training cotangent (``dz`` and the weight
  gradients of the first, middle and head layers), as two launches per
  chunk of ``BWD_PAIRS`` pairs.

As in the JAX package, the FiLM table and the folding stay outside the
kernels: the autograd functions take the folded operands, and autograd
chains ``dz`` back through :func:`film_table` and :func:`stack_weights`
to the latents, ``net2`` and the biases, undoing the scale.

Each kernel has a plain PyTorch version beside it that repeats its
arithmetic.  A wrapper takes the plain version only for CPU tensors; for
CUDA tensors it launches its kernel or raises.  ``LAUNCHES`` counts kernel
launches (plain-version calls are not counted).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from confild_tpu_torch.models.cnf import SirenFilm, siren_film_apply
from confild_tpu_torch.ops import cuda_build

# minimax odd polynomial for sin(2*pi*r), r in [-0.5, 0.5]; max abs error
# 9.6e-8 (the JAX package's constants, siren_decode.py:52-59)
_SIN2PI_COEFFS = (
    6.283182820587522,
    -41.341421583622676,
    81.59618849495108,
    -76.58014706347774,
    41.20559778878122,
    -12.271581478633225,
)

LAUNCHES = {"siren_decode_forward": 0, "siren_decode_dz": 0, "siren_decode_bwd": 0}

# pairs per chunk of the training backward: its workspace holds every
# pre-activation and dpre of a chunk, 2 * n_mod * BWD_PAIRS * H floats
# (3.2 GB at Case4)
BWD_PAIRS = 65536
# fixed slices of a chunk's pairs that the backward's reductions sum apart
# (so that their grid fills the card) and add in order at the end; each
# slice keeps a partial of every cotangent, BWD_SLICES x 9.0 MB at Case4
# with 4 rows
BWD_SLICES = 16
# points per chunk of the general op's coordinate gradient (a plain
# autograd recompute), as the JAX package's BWD_CHUNK (siren_decode.py:250)
BWD_CHUNK = 4096


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sin2pi(r: torch.Tensor) -> torch.Tensor:
    """sin(2*pi*r) for any r: r -= round(r), then the odd polynomial."""
    r = r - torch.round(r)
    r2 = r * r
    p = torch.full_like(r, _SIN2PI_COEFFS[-1])
    for c in _SIN2PI_COEFFS[-2::-1]:
        p = p * r2 + c
    return r * p


def _cos2pi_scaled(r: torch.Tensor) -> torch.Tensor:
    """d sin2pi(r) / dr = 2*pi*cos(2*pi*r), via cos(2*pi*r) = sin2pi(r + 1/4)."""
    return (2.0 * math.pi) * _sin2pi(r + 0.25)


# ---------------------------------------------------------------------------
# operands: the folded weights and FiLM table shared by kernels and plain
# versions
# ---------------------------------------------------------------------------

def stack_weights(model: SirenFilm, w0: float):
    """(w_first (C_in,H), w_mid (n_mod-1,H,H), w_head (H,C_out),
    b_head (C_out,), w2 (n_mod,L,H), b1 (n_mod,H), scale); ``w_first`` and
    ``w_mid`` are [in][out] and scaled by w0/(2*pi); the kernel operands
    are contiguous."""
    net1, net2 = model.net1, model.net2
    n_mod = len(net2)
    scale = w0 / (2.0 * math.pi)
    h = net1[0].out_features
    w_first = net1[0].weight.t() * scale
    if n_mod > 1:
        w_mid = torch.stack([net1[i].weight.t() for i in range(1, n_mod)]) * scale
    else:
        w_mid = w_first.new_zeros((0, h, h))
    head = net1[-1]
    b_head = head.bias if head.bias is not None else head.weight.new_zeros(head.out_features)
    w2 = torch.stack([lin.weight.t() for lin in net2])
    b1 = torch.stack([lin.bias if lin.bias is not None else lin.weight.new_zeros(h)
                      for lin in net1[:n_mod]])
    return (w_first.contiguous(), w_mid.contiguous(), head.weight.t().contiguous(),
            b_head.contiguous(), w2, b1, scale)


def film_table(latents, w2, b1, scale):
    """Scaled FiLM rows ``z`` (n_mod, T, H), contiguous."""
    return ((torch.einsum("tl,nlh->nth", latents, w2) + b1[:, None, :]) * scale).contiguous()


# ---------------------------------------------------------------------------
# forward: plain version and kernel
# ---------------------------------------------------------------------------

def decode_forward_plain(coords, z, w_first, w_mid, w_head, b_head):
    """The forward kernel's arithmetic as a layer loop: ``(T, M, C_out)``."""
    x = _sin2pi((coords @ w_first)[None] + z[0][:, None, :])
    for l in range(1, z.shape[0]):
        x = _sin2pi(x @ w_mid[l - 1] + z[l][:, None, :])
    return x @ w_head + b_head


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_hidden(h: int) -> None:
    if h % 32 or h > 512:
        raise ValueError(f"the CUDA decode kernels take a hidden width that is a "
                         f"multiple of 32 and at most 512, got {h}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared."""
    lib = cuda_build.load("siren_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.siren_decode_forward.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.siren_decode_forward.restype = i
    lib.siren_decode_dz.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.siren_decode_dz.restype = i
    lib.siren_tile_pairs.argtypes = []
    lib.siren_tile_pairs.restype = i
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The built training-backward kernels with their C signatures."""
    lib = cuda_build.load("siren_decode_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
            ("siren_bwd_split", [p, p, i, i, p]),
            ("siren_bwd_chain", [p] * 8 + [ll] + [i] * 8 + [p]),
            ("siren_bwd_reduce", [p] * 3 + [ll, ll] + [i] * 5 + [p]),
            ("siren_bwd_sums", [p] * 5 + [ll] * 4 + [i] * 9 + [p]),
            ("siren_bwd_fold", [p, p, ll, i, p]),
            ("siren_bwd_tile_pairs", []),
            ("siren_bwd_shape_ok", [i] * 4)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def decode_forward(coords, z, w_first, w_mid, w_head, b_head) -> torch.Tensor:
    """Fused forward on folded operands: ``(T, M, C_out)``.

    CPU tensors take :func:`decode_forward_plain`; CUDA tensors launch
    ``siren_decode_forward``."""
    if coords.device.type == "cpu":
        return decode_forward_plain(coords, z, w_first, w_mid, w_head, b_head)
    dev = coords.device
    _check_cuda(dev, coords=coords, z=z, w_first=w_first, w_mid=w_mid,
                w_head=w_head, b_head=b_head)
    n_mod, t, h = z.shape
    m, c_in = coords.shape
    c_out = w_head.shape[1]
    _check_hidden(h)
    if (w_first.shape != (c_in, h) or w_mid.shape != (n_mod - 1, h, h)
            or w_head.shape != (h, c_out) or b_head.shape != (c_out,)):
        raise ValueError("decode operands have inconsistent shapes")
    out = torch.empty((t, m, c_out), device=dev, dtype=torch.float32)
    if t == 0 or m == 0:
        return out
    with torch.cuda.device(dev):
        err = _library().siren_decode_forward(
            _ptr(coords), _ptr(z), _ptr(w_first), _ptr(w_mid), _ptr(w_head),
            _ptr(b_head), _ptr(out), t, m, c_in, h, n_mod, c_out,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "siren_decode_forward launch")
    LAUNCHES["siren_decode_forward"] += 1
    return out


# ---------------------------------------------------------------------------
# dz: plain version and kernel
# ---------------------------------------------------------------------------

def _pre_activations(coords, z, w_first, w_mid):
    """Every layer's pre-activation ``r_l`` ``(T, M, H)`` of the forward."""
    pres = []
    for l in range(z.shape[0]):
        x = (coords @ w_first)[None] if l == 0 else _sin2pi(pres[-1]) @ w_mid[l - 1]
        pres.append(x + z[l][:, None, :])
    return pres


def decode_dz_plain(coords, z, g, w_first, w_mid, w_head):
    """The dz kernel's arithmetic: recompute the forward keeping every
    pre-activation, then walk back.  Returns ``dL/dz`` for the scaled FiLM
    table, ``(n_mod, T, H)``."""
    n_mod = z.shape[0]
    pres = _pre_activations(coords, z, w_first, w_mid)
    dz = torch.empty_like(z)
    dx = g @ w_head.t()
    for l in range(n_mod - 1, -1, -1):
        dpre = dx * _cos2pi_scaled(pres[l])
        dz[l] = dpre.sum(dim=1)
        if l > 0:
            dx = dpre @ w_mid[l - 1].t()
    return dz


def decode_dz(coords, z, g, w_first, w_mid, w_head) -> torch.Tensor:
    """``dL/dz`` on folded operands, ``(n_mod, T, H)``.

    CPU tensors take :func:`decode_dz_plain`; CUDA tensors launch
    ``siren_decode_dz``."""
    if coords.device.type == "cpu":
        return decode_dz_plain(coords, z, g, w_first, w_mid, w_head)
    dev = coords.device
    w_mid_t = w_mid.transpose(1, 2).contiguous()
    _check_cuda(dev, coords=coords, z=z, g=g, w_first=w_first, w_mid=w_mid,
                w_head=w_head)
    n_mod, t, h = z.shape
    m, c_in = coords.shape
    c_out = w_head.shape[1]
    _check_hidden(h)
    if (g.shape != (t, m, c_out) or w_first.shape != (c_in, h)
            or w_mid.shape != (n_mod - 1, h, h) or w_head.shape != (h, c_out)):
        raise ValueError("decode operands have inconsistent shapes")
    dz = torch.empty_like(z)
    if t == 0:
        return dz
    if m == 0:
        return dz.zero_()
    lib = _library()
    grid = min(t, 4 * torch.cuda.get_device_properties(dev).multi_processor_count)
    workspace = torch.empty((grid, n_mod, lib.siren_tile_pairs(), h),
                            device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.siren_decode_dz(
            _ptr(coords), _ptr(z), _ptr(g), _ptr(w_first), _ptr(w_mid),
            _ptr(w_mid_t), _ptr(w_head), _ptr(dz), _ptr(workspace), grid,
            t, m, c_in, h, n_mod, c_out,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "siren_decode_dz launch")
    LAUNCHES["siren_decode_dz"] += 1
    return dz


# ---------------------------------------------------------------------------
# training backward: plain version and kernel
# ---------------------------------------------------------------------------

def decode_bwd_plain(coords, z, g, w_first, w_mid, w_head):
    """The training-backward kernel's arithmetic: recompute the forward
    keeping every pre-activation, then walk back.  Returns the cotangents
    of the folded operands ``(dz, dw_first, dw_mid, dw_head)``."""
    n_mod, _, h = z.shape
    pres = _pre_activations(coords, z, w_first, w_mid)
    dw_head = _sin2pi(pres[-1]).reshape(-1, h).t() @ g.reshape(-1, g.shape[-1])
    dz = torch.empty_like(z)
    dw_mid = torch.empty_like(w_mid)
    dx = g @ w_head.t()
    for l in range(n_mod - 1, -1, -1):
        dpre = dx * _cos2pi_scaled(pres[l])
        dz[l] = dpre.sum(dim=1)
        if l > 0:
            dw_mid[l - 1] = _sin2pi(pres[l - 1]).reshape(-1, h).t() @ dpre.reshape(-1, h)
            dx = dpre @ w_mid[l - 1].t()
        else:
            dw_first = coords.t() @ dpre.sum(dim=0)
    return dz, dw_first, dw_mid, dw_head


def decode_bwd(coords, z, g, w_first, w_mid, w_head):
    """Training cotangents on folded operands, ``(dz, dw_first, dw_mid,
    dw_head)``.

    CPU tensors take :func:`decode_bwd_plain`; CUDA tensors launch
    ``siren_decode_bwd``: the weight split once, then per chunk of
    ``BWD_PAIRS`` (row, point) pairs the chain, the tensor-core reduction
    and the CUDA-core sums, then the fold of the ``BWD_SLICES`` partials
    (``csrc/siren_decode_bwd.cu``)."""
    if coords.device.type == "cpu":
        return decode_bwd_plain(coords, z, g, w_first, w_mid, w_head)
    dev = coords.device
    _check_cuda(dev, coords=coords, z=z, g=g, w_first=w_first, w_mid=w_mid,
                w_head=w_head)
    n_mod, t, h = z.shape
    m, c_in = coords.shape
    c_out = w_head.shape[1]
    if (g.shape != (t, m, c_out) or w_first.shape != (c_in, h)
            or w_mid.shape != (n_mod - 1, h, h) or w_head.shape != (h, c_out)):
        raise ValueError("decode operands have inconsistent shapes")
    lib = _bwd_library()
    if not lib.siren_bwd_shape_ok(h, n_mod, c_in, c_out):
        raise ValueError(f"the CUDA training backward takes a hidden width that is a "
                         f"multiple of 64 and at most 384 and at most 4 input and output "
                         f"features, got {h}, {c_in}, {c_out}")
    sizes = (n_mod * t * h, c_in * h, (n_mod - 1) * h * h, h * c_out)
    shapes = (z.shape, w_first.shape, w_mid.shape, w_head.shape)
    n_el = sum(sizes)
    out = torch.zeros(n_el, device=dev, dtype=torch.float32)
    pairs = t * m
    if pairs > 0:
        tile = lib.siren_bwd_tile_pairs()
        chunk = min(pairs, BWD_PAIRS)
        qa = -(-chunk // tile) * tile
        r_ws, d_ws = torch.empty((2, n_mod, qa, h), device=dev, dtype=torch.float32)
        parts = torch.zeros((BWD_SLICES, n_el), device=dev, dtype=torch.float32)
        wsplit = torch.empty((max(n_mod - 1, 1), 4, h, h), device=dev, dtype=torch.float32)
        dwf_off, dwmid_off = sizes[0], sizes[0] + sizes[1]
        dwh_off = dwmid_off + sizes[2]
        with torch.cuda.device(dev):
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
            if n_mod > 1:
                _raise_on(lib.siren_bwd_split(_ptr(w_mid), _ptr(wsplit), h, n_mod - 1, stream),
                          "siren_bwd_split launch")
                LAUNCHES["siren_decode_bwd"] += 1
            for p0 in range(0, pairs, chunk):
                q = min(chunk, pairs - p0)
                err = lib.siren_bwd_chain(
                    _ptr(coords), _ptr(z), _ptr(g), _ptr(w_first), _ptr(wsplit), _ptr(w_head),
                    _ptr(r_ws), _ptr(d_ws), p0, q, qa, t, m, c_in, h, n_mod, c_out, stream)
                _raise_on(err, "siren_bwd_chain launch")
                LAUNCHES["siren_decode_bwd"] += 1
                if n_mod > 1:
                    err = lib.siren_bwd_reduce(_ptr(r_ws), _ptr(d_ws), _ptr(parts), n_el,
                                               dwmid_off, q, qa, h, n_mod, BWD_SLICES, stream)
                    _raise_on(err, "siren_bwd_reduce launch")
                    LAUNCHES["siren_decode_bwd"] += 1
                err = lib.siren_bwd_sums(
                    _ptr(r_ws), _ptr(d_ws), _ptr(coords), _ptr(g), _ptr(parts), n_el, dwf_off,
                    dwh_off, p0, q, qa, t, m, c_in, h, n_mod, c_out, BWD_SLICES, stream)
                _raise_on(err, "siren_bwd_sums launch")
                LAUNCHES["siren_decode_bwd"] += 1
            _raise_on(lib.siren_bwd_fold(_ptr(parts), _ptr(out), n_el, BWD_SLICES, stream),
                      "siren_bwd_fold launch")
            LAUNCHES["siren_decode_bwd"] += 1
    return tuple(x.view(shape) for x, shape in zip(out.split(sizes), shapes))


# ---------------------------------------------------------------------------
# model-level ops
# ---------------------------------------------------------------------------

def _dcoords_chunked(model: SirenFilm, coords, latents, g, w0: float):
    """``dL/dcoords`` by a plain autograd recompute of the reference decode
    in chunks of ``BWD_CHUNK`` points (``confild_tpu/ops/siren_decode.py:
    253-279``): the chunks are independent, so memory stays at one chunk's
    activations."""
    dcoords = torch.empty_like(coords)
    lat = latents.detach()[:, None, :]
    with torch.enable_grad():
        for lo in range(0, coords.shape[0], BWD_CHUNK):
            c = coords[lo:lo + BWD_CHUNK].detach().requires_grad_(True)
            out = siren_film_apply(model, c[None], lat, w0)
            (dcoords[lo:lo + BWD_CHUNK],) = torch.autograd.grad(
                out, c, g[:, lo:lo + BWD_CHUNK])
    return dcoords


class _TrainDecode(torch.autograd.Function):
    """The decode on folded operands: forward kernel, training-backward
    kernel.  ``dcoords_fn(g)`` gives the coordinate gradient (the general
    op) or is None (the train op: query points are frozen)."""

    @staticmethod
    def forward(ctx, coords, z, w_first, w_mid, w_head, b_head, dcoords_fn):
        ctx.save_for_backward(coords, z, w_first, w_mid, w_head)
        ctx.dcoords_fn = dcoords_fn
        return decode_forward(coords, z, w_first, w_mid, w_head, b_head)

    @staticmethod
    def backward(ctx, g):
        coords, z, w_first, w_mid, w_head = ctx.saved_tensors
        g = g.contiguous()
        dz, dw_first, dw_mid, dw_head = decode_bwd(coords, z, g, w_first, w_mid, w_head)
        dcoords = None
        if ctx.needs_input_grad[0] and ctx.dcoords_fn is not None:
            dcoords = ctx.dcoords_fn(g)
        return dcoords, dz, dw_first, dw_mid, dw_head, g.sum(dim=(0, 1)), None


def _decode(model: SirenFilm, coords, latents, w0: float, with_dcoords: bool):
    # net2 stays bias-free (reference FiLM semantics): the JAX op gives a
    # structural net2 bias leaf a zero cotangent (siren_decode.py:598-601);
    # SirenFilm has no such leaf, so there is nothing to zero here
    w_first, w_mid, w_head, b_head, w2, b1, scale = stack_weights(model, w0)
    z = film_table(latents, w2, b1, scale)
    coords = coords.contiguous()
    dcoords_fn = None
    if with_dcoords and coords.requires_grad:
        dcoords_fn = functools.partial(_dcoords_chunked, model, coords.detach(),
                                       latents, w0=w0)
    return _TrainDecode.apply(coords, z, w_first, w_mid, w_head, b_head, dcoords_fn)


def fused_siren_decode(model: SirenFilm, coords, latents, w0: float = 30.0):
    """Decode every latent row at every coordinate: ``(T, M, C_out)``.

    ``coords`` ``(M, C_in)`` (normalized), ``latents`` ``(T, L)``.  The
    forward is the forward kernel; the gradient with respect to the
    latents and the decoder is the training-backward kernel, and the one
    with respect to ``coords`` a chunked plain recompute
    (:func:`_dcoords_chunked`).  On the CPU both are the plain versions."""
    return _decode(model, coords, latents, w0, with_dcoords=True)


def fused_siren_decode_train(model: SirenFilm, coords, latents, w0: float = 30.0):
    """:func:`fused_siren_decode` with frozen query points: the CNF
    training op (``confild_tpu/ops/siren_decode.py:618-644``); ``coords``
    gets no gradient."""
    return _decode(model, coords, latents, w0, with_dcoords=False)


def fused_siren_decode_bwd(model: SirenFilm, coords, latents, g, w0: float = 30.0):
    """Every training cotangent of the decode for the output cotangent
    ``g`` ``(T, M, C_out)``: ``(grads, dlatents)``, ``grads`` keyed by the
    decoder's state-dict names (the JAX function returns the parameter
    pytree, ``confild_tpu/ops/siren_decode.py:491-608``)."""
    with torch.no_grad():
        w_first, w_mid, w_head, _, w2, b1, scale = stack_weights(model, w0)
        z = film_table(latents, w2, b1, scale)
        u = unfold_bwd(decode_bwd(coords.contiguous(), z, g.contiguous(), w_first, w_mid,
                                  w_head), latents, w2, scale)
        n_mod = z.shape[0]
        grads = {}
        for l in range(n_mod):
            grads[f"net1.{l}.weight"] = (u["dW_first"] if l == 0 else u["dW_mid"][l - 1]).t()
            grads[f"net1.{l}.bias"] = u["db1"][l]
            grads[f"net2.{l}.weight"] = u["dW2"][l].t()
        grads[f"net1.{n_mod}.weight"] = u["dW_head"].t()
        grads[f"net1.{n_mod}.bias"] = g.sum(dim=(0, 1))
    return grads, u["dlatents"]


def unfold_bwd(folded, latents, w2, scale) -> dict:
    """The cotangents of the unfolded decoder from the folded ones
    ``(dz, dw_first, dw_mid, dw_head)`` of :func:`decode_bwd`: undo the
    ``w0 / (2*pi)`` scale and chain ``dz`` through the FiLM table to
    ``dlatents``, ``dW2`` and ``db1`` (``confild_tpu/ops/siren_decode.py:
    572-582``).  Weights stay [in][out]."""
    dz, dw_first, dw_mid, dw_head = folded
    dz = dz * scale
    return {"dz": dz, "dW_first": dw_first * scale, "dW_mid": dw_mid * scale,
            "dW_head": dw_head, "dlatents": torch.einsum("nth,nlh->tl", dz, w2),
            "dW2": torch.einsum("tl,nth->nlh", latents, dz), "db1": dz.sum(dim=1)}


def fused_siren_decode_dz(model: SirenFilm, coords, latents, g, w0: float = 30.0):
    """``dL/dlatents`` ``(T, L)`` for the decode's output cotangent ``g``
    ``(T, M, C_out)``: the dz kernel, then ``sum_l dz_l @ W2_l^T``."""
    with torch.no_grad():
        w_first, w_mid, w_head, _, w2, b1, scale = stack_weights(model, w0)
        z = film_table(latents, w2, b1, scale)
        dz = decode_dz(coords.contiguous(), z, g.contiguous(), w_first, w_mid, w_head)
        return torch.einsum("nth,nlh->tl", dz * scale, w2)


class _FrozenDecode(torch.autograd.Function):
    """Frozen decoder and mesh: only the latents get a gradient, and the
    backward is the dz kernel (the DPS contract, reference
    ``measurements.py:76-78``)."""

    @staticmethod
    def forward(ctx, latents, model, coords, w0):
        ctx.model, ctx.w0 = model, w0
        ctx.save_for_backward(latents, coords)
        return fused_siren_decode(model, coords, latents, w0)

    @staticmethod
    def backward(ctx, g):
        latents, coords = ctx.saved_tensors
        return (fused_siren_decode_dz(ctx.model, coords, latents, g, ctx.w0),
                None, None, None)


def fused_siren_decode_frozen(model: SirenFilm, coords, latents, w0: float = 30.0):
    """:func:`fused_siren_decode` differentiable with respect to ``latents``
    only (decoder and coordinates are frozen)."""
    return _FrozenDecode.apply(latents, model, coords, w0)


def siren_decode(model: SirenFilm, coords, latents, w0: float = 30.0,
                 use_pallas: bool = True):
    """Dispatch between the fused kernel and the reference layer loop
    (``torch.sin``, autograd).  ``use_pallas`` keeps the JAX package's name
    for the fused path."""
    if use_pallas:
        return fused_siren_decode(model, coords, latents, w0)
    return siren_film_apply(model, coords[None, :, :], latents[:, None, :], w0)
