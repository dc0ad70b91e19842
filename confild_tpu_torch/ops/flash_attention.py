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

All three kernels run their products on the tensor cores' ``wgmma``, fed
by a producer warpgroup through bulk async copies into operand images: the
forward (its plan: :func:`forward_plan`) and the two backward passes (their
plans: :func:`backward_plan`), with P and dS going to their products as
register operands.  For float32 inputs every product is 3xTF32 (each
float32 operand split into two TF32 halves, three products), which keeps
the float32 result within the same float64 criterion as the plain version
(``chip_smoke.py`` phase 10).  For bfloat16 inputs the kernels, like the
plain versions, round P to bfloat16 before P.V and before dV, and dS before
dQ and dK, as the JAX kernels do (``:80-81, 180, 210, 214``).

``delta`` is computed in torch, as the JAX package computes it outside its
kernels (``:233-234``).  The TPU kernels' block sizes and interpret mode are
Mosaic tiling and have no counterpart; ragged ``N`` is masked inside the
CUDA kernels, with no padded copy.  The kernels take a head width ``D`` of
32, 64 or 128, or any multiple of ``WIDE_GROUP`` (128) above that, as the
JAX kernels take any width that fits their VMEM: a head is zero-padded to
the next of these (:func:`kernel_head_width`; :func:`padded_forward`,
:func:`padded_backward`), which changes no logit, with the logits scaled by
``1/sqrt`` of the true width.  Above 128 each pass has its own kernel (its
plan: the same :func:`forward_plan` and :func:`backward_plan`): a block owns
one group of ``WIDE_GROUP`` output columns and computes S (and in the
backward dP) over the whole head in chunks of :func:`wide_chunk` columns,
so the head's ``D / WIDE_GROUP`` groups each recompute them.  The
forward up to 512 has kernels of its own instead, a block owning
:func:`forward_columns` output columns (the whole head at 256, groups of
256 at 512 and of 128 at 384): in bf16 at ``TMA_WIDTHS``, 128 query rows
a block with Q resident, K and V streamed by TMA tensor copies into the
128-byte swizzle ``wgmma`` reads (V through the transpose bit); in float32
up to ``RESIDENT_MAX``, 64 query rows with Q resident as raw rows, the
register operand of S.  The backward at ``TMA_WIDTHS`` has its own pair
in each type (its plan: :func:`backward_plan`, its columns
:func:`backward_columns`), dk/dv's blocks split by output (a dV block and a
dK block a group): in bf16 two consumer warpgroups a block, the resident
operands and the streamed tiles copied by TMA into the same swizzle, the
products over the streamed rows reading them through the transpose bit; in
float32 64 rows a block and three warpgroups, one computing S and P from
the first operand's raw rows (the register operand of S, as the float32
forward's Q) and handing P to one that computes dP and the output, the
streamed operands as 16 KB items in both TF32 halves (at 384 and 512 the
second operand, dq's dO or dk/dv's V, streamed as raw items too).

Each kernel has a plain PyTorch version beside it.  A wrapper takes the
plain version only for CPU tensors; for CUDA tensors it launches its kernel
or raises.  ``LAUNCHES`` counts kernel launches at D <= 128, and
``LAUNCHES_WIDE`` those above, by pass, type and padded width
(``"flash_forward@D512"`` in float32, ``"flash_forward_bf16@D512"`` in
bf16).  The forward's wrapper is
on the U-Net's path at 144 tokens, where its host time is the call's time:
it checks its operands in one expression (``_check`` names what is wrong),
passes raw pointers and the raw current stream to ``ctypes``, and enters a
device context only when ``q`` is not on the current device.  The
backward's wrapper does the same for its two launches, with one check.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from confild_tpu_torch.ops import cuda_build

LAUNCHES = {"flash_forward": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
LAUNCHES_WIDE: dict[str, int] = {}

_HEAD_DIMS = (32, 64, 128)
# heads wider than 128 (csrc/flash_attention.cu::wide): a block's output
# columns and rows
WIDE_GROUP, WIDE_ROWS = 128, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INV_SQRT = {d: 1.0 / math.sqrt(d) for d in _HEAD_DIMS}
# the raw current-stream handle and the current device's index, on CUDA
# builds (the public lookups build a Stream object, or initialise first)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_get_device = getattr(torch._C, "_cuda_getDevice", None)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_WIDE.clear()


def _count_wide(name: str, d: int, dtype: torch.dtype) -> None:
    key = f"{name}{'_bf16' if dtype == torch.bfloat16 else ''}@D{d}"
    LAUNCHES_WIDE[key] = LAUNCHES_WIDE.get(key, 0) + 1


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
    of ``_HEAD_DIMS``, or above 128 the next multiple of ``WIDE_GROUP``."""
    for width in _HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // WIDE_GROUP) * WIDE_GROUP


def _is_kernel_width(d: int) -> bool:
    return d in _HEAD_DIMS or (d > 0 and d % WIDE_GROUP == 0)


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
    return declare(cuda_build.load("flash_attention"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/flash_attention.cu``) with its C
    signatures declared."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_forward.argtypes = [p] * 5 + [i] * 4 + [f, p]
    lib.flash_forward.restype = i
    lib.flash_forward_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.flash_forward_plan.restype = i
    lib.flash_backward_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.flash_backward_plan.restype = i
    lib.flash_bwd_dq.argtypes = [p] * 7 + [i] * 4 + [f, p]
    lib.flash_bwd_dq.restype = i
    lib.flash_bwd_dkv.argtypes = [p] * 8 + [i] * 4 + [f, p]
    lib.flash_bwd_dkv.restype = i
    return lib


# ---------------------------------------------------------------------------
# the forward kernel's plan and operand images (csrc/flash_attention.cu::fwd)
# ---------------------------------------------------------------------------

FWD_ROWS = 128          # query rows a block: two consumer warpgroups of 64
FWD_MAX_RAW_STAGES = 4
FWD_SMEM_LIMIT = 232448


def forward_plan(d: int, dtype: torch.dtype) -> dict:
    """The forward kernel's plan at head width ``d``: keys a tile, raw
    stages, image stages and bytes of dynamic shared memory (mirrors
    ``fwd::Plan``; above 128 ``wide::Plan``, in float32 up to
    ``RESIDENT_MAX`` ``wq::Plan``, in bf16 at ``TMA_WIDTHS`` ``tma::Plan``;
    ``library_forward_plan`` asks the built library)."""
    if d > 128 and dtype == torch.bfloat16 and d in TMA_WIDTHS:
        return _tma_plan(d)
    if d > 128 and dtype == torch.float32 and d <= RESIDENT_MAX:
        return _resident_plan(d)
    if d > 128:
        tile, stages, smem = _wide_plan(dtype, "fwd")
        return {"keys": tile, "raw_stages": 0, "image_stages": stages, "smem": smem}
    f32 = dtype == torch.float32
    size, halves = (4, 2) if f32 else (2, 1)
    kt = 16 if f32 and d == 128 else 64
    ni = 2
    q_img, kv_img, raw = FWD_ROWS * d * size * halves, kt * d * size * halves, kt * d * size
    fixed = 128 + q_img + ni * 2 * kv_img + 8 * (FWD_MAX_RAW_STAGES + 2 * ni)
    nr = min(FWD_MAX_RAW_STAGES, (FWD_SMEM_LIMIT - fixed) // (2 * raw))
    return {"keys": kt, "raw_stages": nr, "image_stages": ni, "smem": fixed + nr * 2 * raw}


WIDE_MAX_STAGES = 4
# the bf16 forward's widths on TMA tensor copies (csrc/flash_attention.cu::
# tma): a block's 128 resident query rows of Q fit beside two stages up to
# 512; its stages hold K's tile and V's group as TMA writes them
TMA_WIDTHS = (256, 384, 512)
TMA_ROWS, TMA_MAX_STAGES, TMA_ATOM = 128, 4, 1024


# the float32 forward with Q resident (csrc/flash_attention.cu::wq) up to
# this width: 64 raw rows of Q beside six stages of 32-key items
RESIDENT_MAX, RESIDENT_KEYS, RESIDENT_STAGES, RESIDENT_PAD = 512, 32, 6, 4


def forward_columns(d: int, dtype: torch.dtype) -> int:
    """The output columns a forward block owns at kernel width ``d``: the
    whole head up to 128; above, up to 512 (bf16 ``TMA_WIDTHS``, float32
    ``RESIDENT_MAX``) 256 where they divide ``d`` (the whole head at 256),
    else ``WIDE_GROUP``."""
    if d <= 128:
        return d
    if d <= RESIDENT_MAX:
        return 256 if d % 256 == 0 else WIDE_GROUP
    return WIDE_GROUP


def _resident_plan(d: int) -> dict:
    """The float32 forward's plan at 128 < ``d`` <= ``RESIDENT_MAX``
    (mirrors ``wq::Plan``): 32 keys a tile, six image stages of one item
    (32 x 64 floats in both TF32 halves: a chunk of K, or 64 columns of V
    transposed), their barriers, and Q's 64 rows at a stride of ``d`` + 4
    floats."""
    stage = RESIDENT_KEYS * 64 * 8
    smem = 128 + RESIDENT_STAGES * stage + 16 * RESIDENT_STAGES + 64 * (d + RESIDENT_PAD) * 4
    return {"keys": RESIDENT_KEYS, "raw_stages": 0, "image_stages": RESIDENT_STAGES,
            "smem": smem}


def _tma_plan(d: int) -> dict:
    """The bf16 TMA forward's plan at ``d`` (mirrors ``tma::Plan``): keys a
    tile (64 where two stages of K's tile and V's group fit beside Q's 128
    rows and the swizzle's alignment, else 32), its stages as ``raw_stages``
    (TMA writes the operands as ``wgmma`` reads them: no image stage), and
    the bytes: the alignment slack, Q, Q's barrier, then each stage with
    its barrier and its release count."""
    gw = forward_columns(d, torch.bfloat16)
    fixed = TMA_ATOM + TMA_ROWS * d * 2 + 8
    kt = 64 if (FWD_SMEM_LIMIT - fixed) // (64 * (d + gw) * 2 + 16) >= 2 else 32
    stage = kt * (d + gw) * 2
    ns = min(TMA_MAX_STAGES, (FWD_SMEM_LIMIT - fixed) // (stage + 16))
    return {"keys": kt, "raw_stages": ns, "image_stages": 0, "smem": fixed + ns * (stage + 16)}


def wide_chunk(dtype: torch.dtype) -> int:
    """Columns a chunk of the products over the head above 128 (``GC`` of
    ``wide::Plan``): 64 in float32, 128 in bf16."""
    return 64 if dtype == torch.float32 else 128


def _wide_plan(dtype: torch.dtype, kind: str) -> tuple[int, int, int]:
    """``(tile, image stages, bytes)`` of the kernel of ``kind`` ("fwd",
    "dq", "dkv") above 128 (mirrors ``wide::Plan``): a stage holds one item,
    a chunk of the head's columns of the block's ``WIDE_ROWS`` resident
    rows and of the tile's rows, or one group of ``WIDE_GROUP`` columns of
    the tile transposed, the larger (both TF32 halves in float32), and for
    dk/dv the tile's lse and delta; the tile is 64 rows, 32 in float32
    dk/dv (its two accumulators of the group's columns take 128 registers),
    the chunk :func:`wide_chunk`'s columns."""
    eb = 8 if dtype == torch.float32 else 2
    tile = 32 if kind == "dkv" and dtype == torch.float32 else 64
    image = max((WIDE_ROWS + tile) * wide_chunk(dtype) * eb, WIDE_GROUP * tile * eb)
    stage = image + (2 * tile * 4 if kind == "dkv" else 0)
    stages = min(WIDE_MAX_STAGES, (FWD_SMEM_LIMIT - 128 - 16 * WIDE_MAX_STAGES) // stage)
    return tile, stages, 128 + stages * stage + 16 * stages


def library_forward_plan(d: int, dtype: torch.dtype) -> dict:
    """The built library's forward plan (``flash_forward_plan``)."""
    out = (ctypes.c_int * 4)()
    _raise_on(_library().flash_forward_plan(d, _DTYPES[dtype], out), "flash_forward_plan")
    return dict(zip(("keys", "raw_stages", "image_stages", "smem"), out))


def image_offset(r: int, ck: int, rows: int, halves: int) -> int:
    """Byte offset of 16-byte chunk ``ck`` (along K) of row ``r`` in the
    forward's image of an operand of ``rows`` rows (``fwd::img_off``): the
    no-swizzle K-major core matrices, a k-step (two chunks) a block of
    ``rows`` x 32 bytes a half."""
    return (ck >> 1) * (rows * 32 * halves) + (r >> 3) * 256 + (ck & 1) * 128 + (r & 7) * 16


def v_image_keys(dtype: torch.dtype, ck: int) -> list[int]:
    """The keys of a tile that 16-byte chunk ``ck`` of a column of V's image
    holds, in order (``tc::transposed_image``): float32, keys 8 (ck / 2) +
    ck % 2 + 2e (P's register fragment takes key 2t of a k8 step as index t
    and 2t + 1 as t + 4); bf16, keys 8 ck .. 8 ck + 7.  The backward's
    transposed images (K^T in dq; Q^T, dO^T in dk/dv) hold their keys or
    queries in the same order."""
    if dtype == torch.float32:
        return [8 * (ck >> 1) + (ck & 1) + 2 * e for e in range(4)]
    return [8 * ck + e for e in range(8)]


# ---------------------------------------------------------------------------
# the backward kernels' plans (csrc/flash_attention.cu::bwd)
# ---------------------------------------------------------------------------

BWD_KERNELS = ("dq", "dkv")
_BWD_PLAN_KEYS = ("rows", "consumers", "tile", "raw_stages", "image_stages", "smem")


def backward_plan(d: int, dtype: torch.dtype, kernel: str) -> dict:
    """A backward kernel's plan at head width ``d`` (``kernel`` "dq" or
    "dkv"; mirrors ``bwd::Plan``, ``library_backward_plan`` asks the built
    library): rows a block (query rows in dq, keys in dk/dv) in ``consumers``
    warpgroups of 64, the streamed axis's rows a ``tile`` (keys in dq,
    queries in dk/dv), raw and image stages and bytes of dynamic shared
    memory.  A stage holds the streamed images (dq: K, V, K^T; dk/dv: Q, dO,
    Q^T, dO^T) and for dk/dv the tile's lse and delta; the two resident A
    images (Q, dO; K, V) take both TF32 halves in float32, so a float32
    block is one consumer warpgroup and streams 2048 / d rows a tile.  Above
    128: one consumer warpgroup, no raw stage, :func:`_wide_plan`'s stages;
    in bf16 at ``TMA_WIDTHS`` :func:`_tma_backward_plan`, in float32 up to
    ``RESIDENT_MAX`` :func:`_resident_backward_plan`."""
    f32, dkv = dtype == torch.float32, kernel == "dkv"
    if kernel not in BWD_KERNELS:
        raise ValueError(f"kernel is one of {BWD_KERNELS}, got {kernel!r}")
    if d > 128 and dtype == torch.bfloat16 and d in TMA_WIDTHS:
        return _tma_backward_plan(d)
    if d > 128 and dtype == torch.float32 and d <= RESIDENT_MAX:
        return _resident_backward_plan(d)
    if d > 128:
        tile, stages, smem = _wide_plan(dtype, kernel)
        return dict(zip(_BWD_PLAN_KEYS, (WIDE_ROWS, 1, tile, 0, stages, smem)))
    size, halves = (4, 2) if f32 else (2, 1)
    consumers = 1 if f32 else 2
    tile = 2048 // d if f32 else (32 if dkv and d == 128 else 64)
    ni = 1 if f32 and d == 128 and dkv else 2
    rows = 64 * consumers
    stage = (4 if dkv else 3) * tile * d * size * halves + (2 * tile * 4 if dkv else 0)
    raw = tile * d * size
    fixed = 128 + 2 * rows * d * size * halves + ni * stage + 8 * (FWD_MAX_RAW_STAGES + 2 * ni)
    nr = min(FWD_MAX_RAW_STAGES, (FWD_SMEM_LIMIT - fixed) // (2 * raw))
    return dict(zip(_BWD_PLAN_KEYS, (rows, consumers, tile, nr, ni, fixed + nr * 2 * raw)))


def _tma_backward_plan(d: int) -> dict:
    """The bf16 TMA backward's plan at ``d`` (mirrors ``tmab::Plan``), one
    for both passes: two consumer warpgroups a block, of 64 rows each (128
    rows a block) where both resident operands' 128 rows fit beside two
    stages of 32 streamed rows, else both on the same 64 rows, each with its
    own group of :func:`backward_columns` output columns; streamed rows a
    ``tile``, the most of 64, 32 and 16 that leaves two stages; its stages
    as ``raw_stages`` (TMA writes the operands as ``wgmma`` reads them: no
    image stage), up to ``TMA_MAX_STAGES``; the bytes: the alignment slack,
    both resident operands, their barrier, then each stage (both streamed
    operands) with its barrier and its release count."""
    row = 2 * d * 2

    def fit(fixed, tile):
        return (FWD_SMEM_LIMIT - fixed) // (tile * row + 16)
    two = TMA_ATOM + 8 + TMA_ROWS * row + 2 * (32 * row + 16) <= FWD_SMEM_LIMIT
    rows = 128 if two else 64
    fixed = TMA_ATOM + rows * row + 8
    tile = next(t for t in (64, 32, 16) if fit(fixed, t) >= 2 or t == 16)
    stages = min(TMA_MAX_STAGES, fit(fixed, tile))
    return dict(zip(_BWD_PLAN_KEYS, (rows, 2, tile, stages, 0,
                                     fixed + stages * (tile * row + 16))))


# the float32 backward with the resident rows (csrc/flash_attention.cu::
# wqb): 32 streamed rows a tile, items of 16 KB in up to eight stages
RESIDENT_BWD_STAGES = 8


def _resident_backward_plan(d: int) -> dict:
    """The float32 backward's plan at 128 < ``d`` <= ``RESIDENT_MAX``
    (mirrors ``wqb::Plan``), one for both passes: 64 rows a block, two
    consumer warpgroups (S's and the output's, on the same rows), 32
    streamed rows a tile, as many 16 KB item stages as fit up to
    ``RESIDENT_BWD_STAGES`` (no raw stage), and the bytes: the alignment
    slack, the resident operands' 64 rows at a stride of ``d`` + 4 floats
    (both at 256: dq's Q and dO, dk/dv's K and V; the first alone at 384 and
    512), two tiles of P handed between the warpgroups and their four
    barriers, then the stages with their barriers."""
    stage = RESIDENT_KEYS * 64 * 8
    fixed = (128 + (2 if d == 256 else 1) * WIDE_ROWS * (d + RESIDENT_PAD) * 4
             + 2 * WIDE_ROWS * RESIDENT_KEYS * 4 + 32)
    stages = min(RESIDENT_BWD_STAGES, (FWD_SMEM_LIMIT - fixed) // (stage + 16))
    return dict(zip(_BWD_PLAN_KEYS, (WIDE_ROWS, 2, RESIDENT_KEYS, 0, stages,
                                     fixed + stages * (stage + 16))))


def backward_columns(d: int, dtype: torch.dtype) -> int:
    """The output columns a backward block owns at kernel width ``d``: the
    whole head up to 128; above, at ``TMA_WIDTHS`` (the bf16 TMA pair and
    the float32 pair with the resident rows) the whole head at 256, groups
    of 256 at 512, of 192 at 384, where groups of 128 would make the split
    dk/dv dearer than the column-group kernel's (:func:`backward_products`);
    else ``WIDE_GROUP``."""
    if d <= 128:
        return d
    if d in TMA_WIDTHS:
        return 256 if d % 256 == 0 else 192
    return WIDE_GROUP


def backward_products(d: int, dtype: torch.dtype) -> float:
    """The backward pair's products over the least (14 N^2 d flops: S, dP,
    dQ; S^T, dP^T, dV, dK) at kernel width ``d``.  Column-group kernels
    (groups of c = :func:`backward_columns` columns, g = d / c of them)
    recompute S and dP in every group of both passes: (8 g + 6) / 14.  The
    pairs at ``TMA_WIDTHS`` (bf16 on TMA, float32 with the resident rows):
    dq the same, 2 g + 1 of 2 N^2 d; dk/dv splits each group by output, the
    dV block S^T and its dV_g, the dK block S^T, dP^T and its dK_g, 3 g + 2:
    (5 g + 3) / 7."""
    if d <= 128:
        return 1.0
    groups = d // backward_columns(d, dtype)
    if d in TMA_WIDTHS:
        return (5 * groups + 3) / 7
    return (8 * groups + 6) / 14


def library_backward_plan(d: int, dtype: torch.dtype) -> dict:
    """The built library's backward plans (``flash_backward_plan``):
    ``{"dq": plan, "dkv": plan}``."""
    out = (ctypes.c_int * 12)()
    _raise_on(_library().flash_backward_plan(d, _DTYPES[dtype], out), "flash_backward_plan")
    return {kernel: dict(zip(_BWD_PLAN_KEYS, out[6 * i:6 * i + 6]))
            for i, kernel in enumerate(BWD_KERNELS)}


def _check(ref, **tensors) -> tuple[int, int, int, int]:
    """Device, type, shape and contiguity of the kernels' operands against
    ``ref`` (q); returns ``(BH, N, D, dtype code)``."""
    bh, n, d = ref.shape
    if not _is_kernel_width(d):
        raise ValueError(f"the CUDA flash kernels take a head width of 32, 64 or a multiple "
                         f"of {WIDE_GROUP}, got {d}")
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


def _stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device ``index``."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def _on_device(index: int, fn, *args) -> int:
    """``fn(*args, stream)`` with device ``index`` current (a device context
    only where it is not already)."""
    if index == (_get_device() if _get_device is not None else torch.cuda.current_device()):
        return fn(*args, _stream(index))
    with torch.cuda.device(index):
        return fn(*args, _stream(index))


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _launch_forward(q, k, v, scale):
    """``(out, lse)`` on CUDA tensors of a kernel head width: launches
    ``flash_forward``."""
    shape, dtype, device = q.shape, q.dtype, q.device
    bh, n, d = shape
    if not (_is_kernel_width(d) and dtype in _DTYPES and k.dtype is dtype
            and v.dtype is dtype and k.shape == shape and v.shape == shape
            and k.device == device and v.device == device and q.is_contiguous()
            and k.is_contiguous() and v.is_contiguous()):
        _check(q, q=q, k=k, v=v)   # raises, naming what is wrong
    out = torch.empty_like(q)
    lse = q.new_empty((bh, n), dtype=torch.float32)
    err = _on_device(device.index, _library().flash_forward, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, n, d, _DTYPES[dtype],
                     (_INV_SQRT.get(d) or 1.0 / math.sqrt(d)) if scale is None else scale)
    _raise_on(err, "flash_forward launch")
    if d > 128:
        _count_wide("flash_forward", d, dtype)
    else:
        LAUNCHES["flash_forward"] += 1
    return out, lse


def flash_forward(q, k, v):
    """``(out, lse)``.  CPU tensors take :func:`flash_forward_plain`; CUDA
    tensors launch ``flash_forward`` (on a head padded to the kernels'
    width, :func:`padded_forward`)."""
    if q.is_cpu:
        return flash_forward_plain(q, k, v)
    if q.shape[-1] in _HEAD_DIMS:
        return _launch_forward(q, k, v, None)
    return padded_forward(_launch_forward, q, k, v)


def _launch_dq(q, k, v, g, lse, delta, scale, code, index):
    """``dq`` from checked operands: launches ``flash_bwd_dq``."""
    bh, n, d = q.shape
    dq = torch.empty_like(q)
    err = _on_device(index, _library().flash_bwd_dq, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, n, d,
                     code, _scale(q, scale))
    _raise_on(err, "flash_bwd_dq launch")
    if d > 128:
        _count_wide("flash_bwd_dq", d, q.dtype)
    else:
        LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _launch_dkv(q, k, v, g, lse, delta, scale, code, index):
    """``(dk, dv)`` from checked operands: launches ``flash_bwd_dkv``."""
    bh, n, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _on_device(index, _library().flash_bwd_dkv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), bh, n, d, code, _scale(q, scale))
    _raise_on(err, "flash_bwd_dkv launch")
    if d > 128:
        _count_wide("flash_bwd_dkv", d, q.dtype)
    else:
        LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def bwd_dq(q, k, v, g, lse, delta, scale=None):
    """``dq`` on CUDA tensors of a kernel head width: launches
    ``flash_bwd_dq``."""
    code = _check(q, q=q, k=k, v=v, g=g, lse=lse, delta=delta)[3]
    return _launch_dq(q, k, v, g, lse, delta, scale, code, q.get_device())


def bwd_dkv(q, k, v, g, lse, delta, scale=None):
    """``(dk, dv)`` on CUDA tensors of a kernel head width: launches
    ``flash_bwd_dkv``."""
    code = _check(q, q=q, k=k, v=v, g=g, lse=lse, delta=delta)[3]
    return _launch_dkv(q, k, v, g, lse, delta, scale, code, q.get_device())


def _launch_backward(q, k, v, out, lse, g, scale):
    """``(dq, dk, dv)`` on CUDA tensors of a kernel head width: one check of
    every operand (``_check`` names what is wrong), ``delta`` from torch,
    then ``flash_bwd_dq`` and ``flash_bwd_dkv``."""
    shape, dtype, device = q.shape, q.dtype, q.device
    if not (_is_kernel_width(shape[-1]) and dtype in _DTYPES
            and all(t.dtype is dtype and t.shape == shape and t.device == device
                    and t.is_contiguous() for t in (q, k, v, out, g))
            and lse.dtype is torch.float32 and lse.shape == shape[:2]
            and lse.device == device and lse.is_contiguous()):
        _check(q, q=q, k=k, v=v, out=out, g=g, lse=lse)   # raises, naming what is wrong
    delta = _delta(out, g)
    code, index = _DTYPES[dtype], device.index
    return (_launch_dq(q, k, v, g, lse, delta, scale, code, index),
            *_launch_dkv(q, k, v, g, lse, delta, scale, code, index))


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
    """Online-softmax attention: q, k, v ``(BH, N, D)`` -> ``(BH, N, D)``.
    Where no gradient is wanted (sampling), the forward is called without
    the autograd function and saves nothing."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return flash_forward(q.contiguous(), k.contiguous(), v.contiguous())[0]
