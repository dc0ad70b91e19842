"""SIREN-FiLM decode: the port's CUDA kernels and their plain versions.

The decode is a stack of ``x = sin(w0 * (x @ W1_l + z_l))`` layers over
``T x M`` (latent rows x mesh points) pairs, ``z_l = latents @ W2_l + b1_l``.
As in the JAX package (``confild_tpu/ops/siren_decode.py:143-214``), the
FiLM table ``z`` is computed outside the kernel and ``w0 / (2*pi)`` is
folded into the first and middle weights and into ``z``, so the activation
is ``sin2pi(r) = sin(2*pi*r)``, a round-reduce plus an odd minimax
polynomial.

Kernels:

* ``siren_decode_forward_cluster`` (``csrc/siren_fwd_cluster.cu``)
  replaces ``_decode_kernel`` in float32 at every hidden width: a
  thread-block cluster splits every layer's output columns over its blocks
  (``wgmma``, the weights streamed by bulk asynchronous copies, the
  activations read through distributed shared memory), as two launches per
  call (the middle weights split into TF32 halves and laid out as the
  blocks' stage images, :func:`cluster_weight_layout`, then the forward).
* ``siren_decode_forward_cluster_bf16`` (the same source and plan)
  replaces ``_decode_kernel`` with ``compute_dtype=jnp.bfloat16``: every
  product's operands rounded to bfloat16 (the weights after the ``w0 /
  (2*pi)`` scale), float32 accumulation, FiLM and ``sin2pi`` in float32;
  the shares held as bfloat16 and one bf16 ``wgmma`` a K-slice; two
  launches per call (the middle weights rounded to bfloat16 as the blocks'
  stage images, :func:`cluster_bf16_weight_layout`, then the forward).
  As in JAX, the backward kernels stay float32 whatever the forward's
  ``compute_dtype``.
* ``siren_decode_dz_cluster`` (``csrc/siren_chain_cluster.cu``) replaces
  ``_decode_dz_kernel``: ``dL/dz`` for every layer, from which
  ``dL/dlatents`` is two small matmuls.  It is the chain (a forward
  recompute, then the dx chain) as a thread-block cluster kernel on the
  cluster forward's machinery (``csrc/siren_cluster.cuh``) in its dz mode:
  the weights prepared once a call (the forward's products and the dx
  chain's transposed ones, :func:`cluster_chain_weight_layout`), then per
  chunk of ``BWD_PAIRS`` pairs the chain and the fold of its per-cluster
  row sums.
* The training backward replaces ``_decode_bwd_kernel``: every training
  cotangent (``dz`` and the weight gradients of the first, middle and head
  layers): per chunk of ``BWD_PAIRS`` pairs the same cluster chain in its
  training mode (``siren_bwd_chain_cluster``), which writes every
  pre-activation and dpre to a workspace, then the reduction of
  ``dW_mid`` (``wgmma`` with ``sin2pi(R)^T`` in registers and ``D``
  transposed into its K-major image, :func:`reduce_operand_layout`) and
  the sums of that workspace (``csrc/siren_decode_bwd.cu``); the fold of
  their partials at the end.

As in the JAX package, the FiLM table and the folding stay outside the
kernels: the autograd functions take the folded operands, and autograd
chains ``dz`` back through :func:`film_table` and :func:`stack_weights`
to the latents, ``net2`` and the biases, undoing the scale.

Every kernel family (``FAMILIES``: the float32 and bf16 forwards, dz and
the training backward) runs on the cluster kernels and takes hidden widths
up to 3072 (``MAX_HIDDEN``, a cluster of up to 8 blocks,
:func:`cluster_plan`) and any number of input and output features, as the
JAX kernels do: a block's tables hold ``FEATURE_CHUNK`` (16) of them, and
wider coordinates and outputs go through them in chunks, so the plans do
not depend on them.  A hidden
width is zero-padded to the cluster plan's width (up to 512 one of 128,
192, 256, 384 and 512, :func:`kernel_hidden_width`, :func:`pad_hidden`),
which is exact: a padded unit has zero weights, bias and FiLM column, so
its pre-activation is 0, ``sin2pi(0) = 0``, and the next layer's zero rows
ignore it.

Each kernel has a plain PyTorch version beside it that repeats its
arithmetic.  A wrapper takes the plain version only for CPU tensors; for
CUDA tensors it launches its kernel or raises.  ``LAUNCHES`` counts kernel
launches (plain-version calls are not counted), one key a family.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

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

LAUNCHES = {"siren_decode_forward": 0, "siren_decode_forward_bf16": 0,
            "siren_decode_dz": 0, "siren_decode_bwd": 0}
# the forward's compute dtypes (the JAX kernel's ``compute_dtype``)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# each kernel family's widest hidden layer (the cluster plan's,
# csrc/siren_cluster.cuh::plan_for)
FAMILIES = {"forward": "float32 forward", "forward_bf16": "bfloat16 forward",
            "dz": "dz", "bwd": "training backward"}
MAX_HIDDEN = {"forward": 3072, "forward_bf16": 3072, "dz": 3072, "bwd": 3072}
# the features (C_in, C_out) a block's tables hold (csrc/siren_cluster.cuh::
# MAX_C): any C_in and C_out go through them in chunks of this many
FEATURE_CHUNK = 16
# the families that run on the cluster kernels, at every width: all of them
CLUSTER_FAMILIES = tuple(FAMILIES)

# pairs per chunk of the training backward, whatever the width: its
# workspace holds every pre-activation and dpre of a chunk, 2 * n_mod *
# BWD_PAIRS * H floats (3.2 GB at Case4, 8.6 GB at 16 layers of 1024, 9.7 GB
# at six layers of 3072)
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

def _operand_rounding(compute_dtype):
    """What the forward does to each product's operands: nothing in
    float32; in bfloat16 a rounding to bfloat16 (the JAX kernel's ``mxu``
    helper), the product then taken in float32."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    if compute_dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def decode_forward_plain(coords, z, w_first, w_mid, w_head, b_head,
                         compute_dtype=torch.float32):
    """The forward kernels' arithmetic as a layer loop: ``(T, M, C_out)``;
    with ``compute_dtype`` bfloat16 each product's operands are rounded to
    bfloat16 and multiplied in float32, where the bf16 kernel rounds them:
    the coordinates and every weight as it reads them, an activation as it
    stores it in its share (the next product's operand)."""
    r = _operand_rounding(compute_dtype)
    x = _sin2pi((r(coords) @ r(w_first))[None] + z[0][:, None, :])
    for l in range(1, z.shape[0]):
        x = _sin2pi(r(x) @ r(w_mid[l - 1]) + z[l][:, None, :])
    return r(x) @ r(w_head) + b_head


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


# ---------------------------------------------------------------------------
# the cluster kernels' plan and the weights' stage images
# (csrc/siren_cluster.cuh)
# ---------------------------------------------------------------------------

# (S, MT) of the cluster kernels' instantiations: S columns a block, MT m64
# tiles (64 pairs each) a cluster (csrc/siren_cluster.cuh::CONFIGS; up to
# 512 a width pads to 128, 192, 256, 384 or 512)
CLUSTER_CONFIGS = ((128, 2), (192, 2), (256, 2), (384, 1))
CLUSTER_MAX_BLOCKS = 8         # the largest portable cluster
CLUSTER_KSLICE = 16            # weight rows a stage holds
SMEM_PER_BLOCK = 232448        # the shared memory a Hopper block may take
# a share's row padding (float32 and bf16 elements) and the stages' alignment
_SHARE_PAD, _SHARE_PAD_BF16, _SMEM_ALIGN = 16, 32, 128


class ClusterPlan(NamedTuple):
    """How the cluster kernel runs a hidden width: ``blocks`` blocks of
    ``share`` columns over ``64 * m_tiles`` pairs."""
    blocks: int
    share: int
    m_tiles: int

    @property
    def width(self) -> int:
        return self.blocks * self.share

    @property
    def pairs(self) -> int:
        return 64 * self.m_tiles

    def _bytes(self, stages: int, bf16: bool) -> int:
        # the float32 kernels' share and two P x FEATURE_CHUNK tables (one
        # chunk of the features each), or the bf16 forward's two bf16
        # buffers (its tables live in them and in the ring); none depends on
        # C_in or C_out
        p, share = self.pairs, (2 * 2 if bf16 else 4)
        pad = _SHARE_PAD_BF16 if bf16 else _SHARE_PAD
        tables = 0 if bf16 else 2 * p * FEATURE_CHUNK * 4
        return (_SMEM_ALIGN + stages * CLUSTER_KSLICE * self.share * 2 * (1 if bf16 else 4)
                + p * (self.share + pad) * share + tables + p * 4 + 2 * stages * 8)

    def ring(self, bf16: bool = False) -> int:
        """Stages of the weight ring: as many as fit, 2 to 4 for the
        float32 kernels' TF32 halves, 2 to 16 for the bf16 forward's bf16
        stages (a quarter of the bytes)."""
        ns = 16 if bf16 else 4
        while ns > 2 and self._bytes(ns, bf16) > SMEM_PER_BLOCK:
            ns -= 1
        return ns

    def shared_bytes(self, bf16: bool = False) -> int:
        """A block's shared memory: the ring (:meth:`ring`), the shares and
        the tables."""
        return self._bytes(self.ring(bf16), bf16)


def cluster_plan(h: int) -> ClusterPlan:
    """The cluster for hidden width ``h`` (``csrc/siren_cluster.cuh::
    plan_for``): the smallest padded width ``blocks * share >= h`` with at
    most ``CLUSTER_MAX_BLOCKS`` blocks; ties go to more pairs a cluster,
    then to fewer blocks."""
    plans = [ClusterPlan(-(-h // s), s, mt) for s, mt in CLUSTER_CONFIGS
             if -(-h // s) <= CLUSTER_MAX_BLOCKS]
    if h < 1 or not plans:
        raise ValueError(f"no cluster plan for a hidden width of {h}")
    return min(plans, key=lambda p: (p.width, -p.m_tiles, p.blocks))


def tf32_split(x: torch.Tensor):
    """``(big, small)``: ``x`` rounded to TF32 (to nearest, ties away from
    zero, by bit arithmetic as ``csrc/tf32_mma.cuh::rna_tf32``) and the
    rest rounded the same way."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    big = rna(x)
    return big, rna(x - big)


def cluster_weight_layout(w_mid: torch.Tensor, share: int) -> torch.Tensor:
    """What the cluster kernel's preparation writes, flat: for each block
    (its ``share`` columns), middle weight and 16-row K-slice, the stage
    image ``[k8][big, small][n / 8][j / 4][n % 8][j % 4]`` of ``w_mid``
    ``(n_mid, H, H)`` [k][n], split into TF32 halves; fragment row ``j`` of
    k8 step ``kk`` is row ``4 (j % 4) + 2 kk + j / 4`` of the slice (the
    kernel's ``load_a`` reads A in the same order)."""
    n_mid, h, _ = w_mid.shape
    x = torch.stack(tf32_split(w_mid)).view(2, n_mid, h // 16, 4, 2, 2, h // share, share // 8, 8)
    # (half, layer, slice, j % 4, k8, j / 4, block, n / 8, n % 8) -> the image order
    return x.permute(6, 1, 2, 4, 0, 7, 5, 8, 3).reshape(-1)


def cluster_bf16_weight_layout(w_mid: torch.Tensor, share: int) -> torch.Tensor:
    """What the bf16 forward's preparation writes, flat, as bfloat16: for
    each block (its ``share`` columns), middle weight and 16-row K-slice,
    the stage image ``[n / 8][j / 8][n % 8][j % 8]`` of ``w_mid`` ``(n_mid,
    H, H)`` [k][n] rounded to bfloat16 (to nearest even); fragment row
    ``j = 8 h + 2 q + e`` of slice ``2 g + s`` is row ``32 g + 8 q + 4 s + 2 h
    + e`` of the weight (the kernel's ``load_a16`` reads A in the same
    order, a 16-byte load a lane and row for two slices)."""
    n_mid, h, _ = w_mid.shape
    x = w_mid.to(torch.bfloat16).view(n_mid, h // 32, 4, 2, 2, 2, h // share, share // 8, 8)
    # (layer, g, q, s, h, e, block, n / 8, n % 8) -> the image order
    return x.permute(6, 0, 1, 3, 7, 4, 8, 2, 5).reshape(-1)


def cluster_chain_weight_layout(w_mid: torch.Tensor, share: int) -> torch.Tensor:
    """What the cluster chain's preparation writes, flat: for each block,
    the stage images (:func:`cluster_weight_layout`) of the forward's
    products ``w_mid[0] .. w_mid[n_mid - 1]`` followed by the dx chain's
    ``w_mid[n_mid - 1]^T .. w_mid[0]^T``, in the order the chain consumes
    them."""
    return cluster_weight_layout(torch.cat([w_mid, w_mid.transpose(1, 2).flip(0)]), share)


# pairs a step of the training backward's reduction (csrc/siren_decode_bwd.cu)
REDUCE_STEP = 32


def reduce_cols(h: int) -> int:
    """The columns (D's) of the reduction's output tile at workspace width
    ``h`` (``csrc/siren_decode_bwd.cu::reduce_cols``): 192 where they divide
    ``h``, else 128."""
    return 192 if h % 192 == 0 else 128


def reduce_operand_layout(d: torch.Tensor, q0: int, hi: int, b0: int, cols: int) -> torch.Tensor:
    """What the reduction writes, flat, as the B image of the step of
    ``REDUCE_STEP`` pairs from ``q0`` of one layer's dpre ``d`` (pairs x
    H, pair-major) for its output tile's ``cols`` columns from ``b0``
    (``csrc/siren_decode_bwd.cu::reduce_image``): for each K-slice of 16
    pairs, k8 step and TF32 half (big, small), the no-swizzle K-major core
    matrices ``[n / 8][k / 4][n % 8][k % 4]``; pairs from ``hi`` on are
    zero, and so (here) are columns past H."""
    x = torch.zeros((REDUCE_STEP, cols), dtype=torch.float32)
    rows, width = max(0, min(REDUCE_STEP, hi - q0)), max(0, min(cols, d.shape[1] - b0))
    x[:rows, :width] = d[q0:q0 + rows, b0:b0 + width]
    halves = torch.stack(tf32_split(x)).view(2, 2, 2, 2, 4, cols // 8, 8)
    # (half, slice, k8, k / 4, k % 4, n / 8, n % 8) -> the image order
    return halves.permute(1, 2, 0, 5, 3, 6, 4).reshape(-1)


def feature_chunks(c: int) -> list[tuple[int, int]]:
    """``(c0, n)``: the first feature and the count of each chunk of at most
    ``FEATURE_CHUNK`` of ``c`` features, in the order the kernels take
    them."""
    return [(c0, min(FEATURE_CHUNK, c - c0)) for c0 in range(0, c, FEATURE_CHUNK)]


def bwd_sums_jobs(n_mod: int, c_in: int, c_out: int) -> list[tuple[str, int, int]]:
    """The training backward's sums kernel's jobs, in grid order
    (``csrc/siren_decode_bwd.cu::siren_bwd_sums_kernel``): ``(what, layer,
    c0)`` with ``what`` "dz" (layer 0 also dW_first's first chunk of
    features), "head" (dW_head's first chunk), then "first" and "head" for
    every further chunk of dW_first's and dW_head's features from ``c0``."""
    jobs = [("dz", l, 0) for l in range(n_mod)] + [("head", n_mod - 1, 0)]
    jobs += [("first", 0, c0) for c0, _ in feature_chunks(c_in)[1:]]
    return jobs + [("head", n_mod - 1, c0) for c0, _ in feature_chunks(c_out)[1:]]


def kernel_hidden_width(h: int, c_in: int, c_out: int, family: str) -> int:
    """The hidden width the ``family`` kernel (a key of ``FAMILIES``) runs
    a decoder of ``h`` units and ``c_in`` -> ``c_out`` features at: the
    cluster plan's width (up to 512 one of 128, 192, 256, 384 and 512),
    whatever the features.  Raises beyond the family's hidden-width limit
    or on no feature."""
    limit = MAX_HIDDEN[family]
    if h > limit:
        raise ValueError(
            f"the CUDA SIREN {FAMILIES[family]} kernel takes a hidden width of at most {limit} "
            f"(zero-padded to its kernel width), got {h}")
    if c_in < 1 or c_out < 1:
        raise ValueError(f"the CUDA SIREN {FAMILIES[family]} kernel needs at least one input "
                         f"and one output feature, got {c_in}, {c_out}")
    return cluster_plan(h).width


def pad_hidden(z, w_first, w_mid, w_head, width: int):
    """The folded operands with ``width - H`` zero hidden units appended:
    zero FiLM columns, zero weights in and out."""
    p = width - z.shape[-1]
    if p == 0:
        return z, w_first, w_mid, w_head
    return (F.pad(z, (0, p)), F.pad(w_first, (0, p)), F.pad(w_mid, (0, p, 0, p)),
            F.pad(w_head, (0, 0, 0, p)))


def padded_forward(forward, coords, z, w_first, w_mid, w_head, b_head, width: int):
    """``forward`` on operands padded to ``width`` hidden units (the output
    does not change shape)."""
    return forward(coords, *pad_hidden(z, w_first, w_mid, w_head, width), b_head)


def padded_dz(dz_fn, coords, z, g, w_first, w_mid, w_head, width: int):
    """``dz_fn`` on operands padded to ``width`` hidden units; ``dz``
    sliced back to ``H``."""
    h = z.shape[-1]
    zp, w_first, w_mid, w_head = pad_hidden(z, w_first, w_mid, w_head, width)
    return dz_fn(coords, zp, g, w_first, w_mid, w_head)[..., :h].contiguous()


def padded_bwd(bwd_fn, coords, z, g, w_first, w_mid, w_head, width: int):
    """``bwd_fn`` on operands padded to ``width`` hidden units; every
    cotangent sliced back to ``H``."""
    h = z.shape[-1]
    zp, w_first, w_mid, w_head = pad_hidden(z, w_first, w_mid, w_head, width)
    dz, dw_first, dw_mid, dw_head = bwd_fn(coords, zp, g, w_first, w_mid, w_head)
    return (dz[..., :h].contiguous(), dw_first[:, :h].contiguous(),
            dw_mid[:, :h, :h].contiguous(), dw_head[:h].contiguous())


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The built training backward's reduction, sums and fold with their C
    signatures."""
    lib = cuda_build.load("siren_decode_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
            ("siren_bwd_reduce_cols", [i]),
            ("siren_bwd_reduce", [p] * 3 + [ll, ll] + [i] * 5 + [p]),
            ("siren_bwd_sums", [p] * 5 + [ll] * 4 + [i] * 9 + [p]),
            ("siren_bwd_fold", [p, p, ll, i, p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def _operands(family, coords, z, w_first, w_mid, w_head, **more):
    """The CUDA wrappers' checks of the folded operands (device, float32,
    contiguous, consistent shapes); returns ``(n_mod, T, H, M, C_in,
    C_out)`` and the ``family`` kernel's padded hidden width."""
    dev = coords.device
    _check_cuda(dev, coords=coords, z=z, w_first=w_first, w_mid=w_mid, w_head=w_head, **more)
    n_mod, t, h = z.shape
    m, c_in = coords.shape
    c_out = w_head.shape[1]
    g, b_head = more.get("g"), more.get("b_head")
    if (w_first.shape != (c_in, h) or w_mid.shape != (n_mod - 1, h, h)
            or w_head.shape != (h, c_out) or (b_head is not None and b_head.shape != (c_out,))
            or (g is not None and g.shape != (t, m, c_out))):
        raise ValueError("decode operands have inconsistent shapes")
    return (n_mod, t, h, m, c_in, c_out), kernel_hidden_width(h, c_in, c_out, family)


@functools.cache
def _cluster_library() -> ctypes.CDLL:
    """The built cluster forwards (float32 and bf16) with their C
    signatures declared."""
    lib = cuda_build.load("siren_fwd_cluster")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (
            ("siren_fwd_cluster_plan", [i, i, p]),
            ("siren_fwd_cluster_max_clusters", [i, i, i, i, p]),
            ("siren_fwd_cluster_prep", [p, p, i, i, p]),
            ("siren_fwd_cluster_prep_bf16", [p, p, i, i, p]),
            ("siren_decode_forward_cluster", [p] * 7 + [i] * 6 + [p]),
            ("siren_decode_forward_cluster_bf16", [p] * 7 + [i] * 6 + [p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


@functools.cache
def _chain_cluster_library() -> ctypes.CDLL:
    """The built cluster chain (dz and training modes) with its C
    signatures declared."""
    lib = cuda_build.load("siren_chain_cluster")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
            ("siren_chain_cluster_max_clusters", [i, i, i, i, p]),
            ("siren_chain_cluster_prep", [p, p, i, i, p]),
            ("siren_dz_cluster_slots", [i, i]),
            ("siren_bwd_chain_cluster", [p] * 8 + [ll] + [i] * 8 + [p]),
            ("siren_decode_dz_cluster", [p] * 9 + [ll] + [i] * 8 + [p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


@functools.cache
def cluster_capacity(device_index: int, h: int, c_in: int, c_out: int,
                     family: str = "forward") -> int:
    """Clusters of the plan for width ``h`` that the card holds at once
    (``cudaOccupancyMaxActiveClusters``) for the ``family`` kernel (a key of
    ``CLUSTER_FAMILIES``); raises when it holds none."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        if family in ("forward", "forward_bf16"):
            err = _cluster_library().siren_fwd_cluster_max_clusters(
                h, c_in, c_out, int(family == "forward_bf16"), ctypes.byref(n))
        else:
            err = _chain_cluster_library().siren_chain_cluster_max_clusters(
                int(family == "dz"), h, c_in, c_out, ctypes.byref(n))
    _raise_on(err, f"the cluster {FAMILIES[family]} kernel's occupancy query")
    if n.value < 1:
        plan = cluster_plan(h)
        raise RuntimeError(f"the card admits no cluster of {plan.blocks} blocks with "
                           f"{plan.shared_bytes(family == 'forward_bf16')} bytes of shared "
                           f"memory each (H = {h})")
    return n.value


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _launch_forward(coords, z, w_first, w_mid, w_head, b_head, compute_dtype):
    """Launches of the forward on operands of the cluster plan's width: the
    weights' stage images (TF32 halves, or bf16), then the forward."""
    lib = _cluster_library()
    dev = coords.device
    n_mod, t, h = z.shape
    m, c_in = coords.shape
    c_out = w_head.shape[1]
    bf16 = compute_dtype == torch.bfloat16
    name = "siren_decode_forward_bf16" if bf16 else "siren_decode_forward"
    if bf16:
        prep, launch = lib.siren_fwd_cluster_prep_bf16, lib.siren_decode_forward_cluster_bf16
    else:
        prep, launch = lib.siren_fwd_cluster_prep, lib.siren_decode_forward_cluster
    out = torch.empty((t, m, c_out), device=dev, dtype=torch.float32)
    if t == 0 or m == 0:
        return out
    cluster_capacity(_device_index(dev), h, c_in, c_out, "forward_bf16" if bf16 else "forward")
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        wprep = None
        if n_mod > 1:
            wprep = (torch.empty((n_mod - 1) * h * h, device=dev, dtype=torch.bfloat16) if bf16
                     else torch.empty((n_mod - 1) * 2 * h * h, device=dev, dtype=torch.float32))
            _raise_on(prep(_ptr(w_mid), _ptr(wprep), h, n_mod - 1, stream),
                      f"{name} weight preparation launch")
            LAUNCHES[name] += 1
        err = launch(_ptr(coords), _ptr(z), _ptr(w_first),
                     _ptr(wprep) if wprep is not None else None, _ptr(w_head), _ptr(b_head),
                     _ptr(out), t, m, c_in, h, n_mod, c_out, stream)
    _raise_on(err, f"{name} launch")
    LAUNCHES[name] += 1
    return out


def decode_forward(coords, z, w_first, w_mid, w_head, b_head,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """Fused forward on folded operands: ``(T, M, C_out)``.

    CPU tensors take :func:`decode_forward_plain`.  CUDA tensors launch, on
    operands padded to the cluster plan's hidden width
    (``csrc/siren_fwd_cluster.cu``), ``siren_decode_forward_cluster`` for
    ``compute_dtype`` float32 (the middle weights split once into TF32
    halves as the blocks' stage images, then the 3xTF32 cluster forward), or
    ``siren_decode_forward_cluster_bf16`` for bfloat16 (the middle weights
    rounded once to bfloat16 as the blocks' stage images, then the bf16
    cluster forward); any other ``compute_dtype`` raises.  The operands are
    float32 in both modes."""
    _operand_rounding(compute_dtype)
    if coords.device.type == "cpu":
        return decode_forward_plain(coords, z, w_first, w_mid, w_head, b_head, compute_dtype)
    family = "forward_bf16" if compute_dtype == torch.bfloat16 else "forward"
    _, width = _operands(family, coords, z, w_first, w_mid, w_head, b_head=b_head)
    return padded_forward(functools.partial(_launch_forward, compute_dtype=compute_dtype),
                          coords, z, w_first, w_mid, w_head, b_head, width)


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


def pair_chunks(pairs: int, chunk: int) -> list[tuple[int, int]]:
    """``(p0, q)``: the first pair and the length of each chunk of at most
    ``chunk`` pairs, in order."""
    return [(p0, min(chunk, pairs - p0)) for p0 in range(0, pairs, chunk)]


def _chain_setup(w_mid, pairs, stream, counter):
    """What the dz and training-backward wrappers set up alike for the
    cluster chain: the middle weights prepared once as the blocks' stage
    images, the forward's products then the dx chain's (one launch, counted
    under ``counter``; ``csrc/siren_chain_cluster.cu``,
    :func:`cluster_chain_weight_layout`), the pairs a cluster owns, the
    padded length ``qa`` of a chunk's workspace, a multiple of them, and the
    chunks ``(p0, q)`` of at most ``BWD_PAIRS`` pairs."""
    n_mid, h = w_mid.shape[0], w_mid.shape[2]
    wprep = torch.empty((max(n_mid, 1), 4, h, h), device=w_mid.device, dtype=torch.float32)
    if n_mid:
        _raise_on(_chain_cluster_library().siren_chain_cluster_prep(_ptr(w_mid), _ptr(wprep), h,
                                                                   n_mid, stream),
                  f"{counter} weight preparation launch")
        LAUNCHES[counter] += 1
    tile = cluster_plan(h).pairs
    chunk = min(pairs, BWD_PAIRS)
    return wprep, tile, -(-chunk // tile) * tile, pair_chunks(pairs, chunk)


def decode_dz(coords, z, g, w_first, w_mid, w_head) -> torch.Tensor:
    """``dL/dz`` on folded operands, ``(n_mod, T, H)``.

    CPU tensors take :func:`decode_dz_plain`; CUDA tensors launch, on
    operands padded to the kernels' hidden width,
    ``siren_decode_dz_cluster`` (``csrc/siren_chain_cluster.cu``): the
    middle weights prepared once (the forward's products and the dx
    chain's), then per chunk of ``BWD_PAIRS`` (row, point) pairs the
    cluster chain in its dz mode and the fold of its per-cluster row sums
    into ``dz``.  The workspace is one chunk's pre-activations and
    partials, whatever ``T x M``."""
    if coords.device.type == "cpu":
        return decode_dz_plain(coords, z, g, w_first, w_mid, w_head)
    _, width = _operands("dz", coords, z, w_first, w_mid, w_head, g=g)
    return padded_dz(_launch_dz, coords, z, g, w_first, w_mid, w_head, width)


def _launch_dz(coords, z, g, w_first, w_mid, w_head) -> torch.Tensor:
    """Launches on operands of a kernel width: the weights' preparation,
    then per chunk the chain in its dz mode and the fold."""
    dev = coords.device
    n_mod, t, h = z.shape
    m, c_in = coords.shape
    c_out = w_head.shape[1]
    dz = torch.zeros_like(z)
    pairs = t * m
    if pairs == 0:
        return dz
    name, lib = "siren_decode_dz", _chain_cluster_library()
    cluster_capacity(_device_index(dev), h, c_in, c_out, "dz")
    launch, slots = lib.siren_decode_dz_cluster, lib.siren_dz_cluster_slots(m, h)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        wprep, tile, qa, chunks = _chain_setup(w_mid, pairs, stream, name)
        r_ws = torch.empty((n_mod, qa, h), device=dev, dtype=torch.float32)
        parts = torch.empty((qa // tile, n_mod, slots, h), device=dev, dtype=torch.float32)
        for p0, q in chunks:
            err = launch(_ptr(coords), _ptr(z), _ptr(g), _ptr(w_first), _ptr(wprep),
                         _ptr(w_head), _ptr(r_ws), _ptr(parts), _ptr(dz), p0, q, qa, t, m, c_in,
                         h, n_mod, c_out, stream)
            _raise_on(err, f"{name} launch")
            LAUNCHES[name] += 2   # the chain and the fold
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

    CPU tensors take :func:`decode_bwd_plain`; CUDA tensors launch, on
    operands padded to the kernels' hidden width: the weights prepared
    once, then per chunk of ``BWD_PAIRS`` (row, point) pairs the cluster
    chain in its training mode (``csrc/siren_chain_cluster.cu``), the
    ``wgmma`` reduction and the CUDA-core sums, then the fold of the
    ``BWD_SLICES`` partials (``csrc/siren_decode_bwd.cu``)."""
    if coords.device.type == "cpu":
        return decode_bwd_plain(coords, z, g, w_first, w_mid, w_head)
    _, width = _operands("bwd", coords, z, w_first, w_mid, w_head, g=g)
    return padded_bwd(_launch_bwd, coords, z, g, w_first, w_mid, w_head, width)


def _launch_bwd(coords, z, g, w_first, w_mid, w_head):
    """Launches on operands of a kernel width: the weights' preparation,
    per chunk the chain, the reduction and the sums, then the fold."""
    lib = _bwd_library()
    dev = coords.device
    n_mod, t, h = z.shape
    m, c_in = coords.shape
    c_out = w_head.shape[1]
    sizes = (n_mod * t * h, c_in * h, (n_mod - 1) * h * h, h * c_out)
    shapes = (z.shape, w_first.shape, w_mid.shape, w_head.shape)
    n_el = sum(sizes)
    out = torch.zeros(n_el, device=dev, dtype=torch.float32)
    pairs = t * m
    if pairs > 0:
        name, chain = "siren_decode_bwd", _chain_cluster_library().siren_bwd_chain_cluster
        cluster_capacity(_device_index(dev), h, c_in, c_out, "bwd")
        dwf_off, dwmid_off = sizes[0], sizes[0] + sizes[1]
        dwh_off = dwmid_off + sizes[2]
        with torch.cuda.device(dev):
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
            wprep, _, qa, chunks = _chain_setup(w_mid, pairs, stream, name)
            r_ws, d_ws = torch.empty((2, n_mod, qa, h), device=dev, dtype=torch.float32)
            parts = torch.zeros((BWD_SLICES, n_el), device=dev, dtype=torch.float32)
            for p0, q in chunks:
                err = chain(_ptr(coords), _ptr(z), _ptr(g), _ptr(w_first), _ptr(wprep),
                            _ptr(w_head), _ptr(r_ws), _ptr(d_ws), p0, q, qa, t, m, c_in, h,
                            n_mod, c_out, stream)
                _raise_on(err, f"{name} chain launch")
                LAUNCHES[name] += 1
                if n_mod > 1:
                    err = lib.siren_bwd_reduce(_ptr(r_ws), _ptr(d_ws), _ptr(parts), n_el,
                                               dwmid_off, q, qa, h, n_mod, BWD_SLICES, stream)
                    _raise_on(err, "siren_bwd_reduce launch")
                    LAUNCHES[name] += 1
                err = lib.siren_bwd_sums(
                    _ptr(r_ws), _ptr(d_ws), _ptr(coords), _ptr(g), _ptr(parts), n_el, dwf_off,
                    dwh_off, p0, q, qa, t, m, c_in, h, n_mod, c_out, BWD_SLICES, stream)
                _raise_on(err, "siren_bwd_sums launch")
                LAUNCHES[name] += 1
            _raise_on(lib.siren_bwd_fold(_ptr(parts), _ptr(out), n_el, BWD_SLICES, stream),
                      "siren_bwd_fold launch")
            LAUNCHES[name] += 1
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
    """The decode on folded operands: forward kernel (in ``compute_dtype``),
    training-backward kernel (float32 whatever the forward's dtype, as in
    JAX).  ``dcoords_fn(g)`` gives the coordinate gradient (the general op)
    or is None (the train op: query points are frozen)."""

    @staticmethod
    def forward(ctx, coords, z, w_first, w_mid, w_head, b_head, dcoords_fn, compute_dtype):
        ctx.save_for_backward(coords, z, w_first, w_mid, w_head)
        ctx.dcoords_fn = dcoords_fn
        return decode_forward(coords, z, w_first, w_mid, w_head, b_head, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        coords, z, w_first, w_mid, w_head = ctx.saved_tensors
        g = g.contiguous()
        dz, dw_first, dw_mid, dw_head = decode_bwd(coords, z, g, w_first, w_mid, w_head)
        dcoords = None
        if ctx.needs_input_grad[0] and ctx.dcoords_fn is not None:
            dcoords = ctx.dcoords_fn(g)
        return dcoords, dz, dw_first, dw_mid, dw_head, g.sum(dim=(0, 1)), None, None


def _decode(model: SirenFilm, coords, latents, w0: float, with_dcoords: bool,
            compute_dtype=torch.float32):
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
    return _TrainDecode.apply(coords, z, w_first, w_mid, w_head, b_head, dcoords_fn,
                              compute_dtype)


def fused_siren_decode(model: SirenFilm, coords, latents, w0: float = 30.0,
                       compute_dtype=torch.float32):
    """Decode every latent row at every coordinate: ``(T, M, C_out)``.

    ``coords`` ``(M, C_in)`` (normalized), ``latents`` ``(T, L)``.  The
    forward is the forward kernel, its products in ``compute_dtype``
    (float32 or bfloat16); the gradient with respect to the latents and the
    decoder is the training-backward kernel (float32), and the one with
    respect to ``coords`` a chunked plain recompute
    (:func:`_dcoords_chunked`).  On the CPU both are the plain versions."""
    return _decode(model, coords, latents, w0, with_dcoords=True, compute_dtype=compute_dtype)


def fused_siren_decode_train(model: SirenFilm, coords, latents, w0: float = 30.0,
                             compute_dtype=torch.float32):
    """:func:`fused_siren_decode` with frozen query points: the CNF
    training op (``confild_tpu/ops/siren_decode.py:618-644``); ``coords``
    gets no gradient."""
    return _decode(model, coords, latents, w0, with_dcoords=False, compute_dtype=compute_dtype)


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
    def forward(ctx, latents, model, coords, w0, compute_dtype):
        ctx.model, ctx.w0 = model, w0
        ctx.save_for_backward(latents, coords)
        return fused_siren_decode(model, coords, latents, w0, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        latents, coords = ctx.saved_tensors
        return (fused_siren_decode_dz(ctx.model, coords, latents, g, ctx.w0),
                None, None, None, None)


def fused_siren_decode_frozen(model: SirenFilm, coords, latents, w0: float = 30.0,
                              compute_dtype=torch.float32):
    """:func:`fused_siren_decode` differentiable with respect to ``latents``
    only (decoder and coordinates are frozen); the forward's products in
    ``compute_dtype``, the backward the float32 dz kernel, as in JAX."""
    return _FrozenDecode.apply(latents, model, coords, w0, compute_dtype)


def siren_decode(model: SirenFilm, coords, latents, w0: float = 30.0,
                 use_pallas: bool = True):
    """Dispatch between the fused kernel and the reference layer loop
    (``torch.sin``, autograd).  ``use_pallas`` keeps the JAX package's name
    for the fused path."""
    if use_pallas:
        return fused_siren_decode(model, coords, latents, w0)
    return siren_film_apply(model, coords[None, :, :], latents[:, None, :], w0)
