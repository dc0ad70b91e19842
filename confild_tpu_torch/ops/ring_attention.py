"""Ring attention: sequence-parallel attention over the ranks of a mesh, the
port of ``confild_tpu/ops/ring_attention.py``.

The token axis is sharded over a ring of ranks.  Q stays local; the K/V
shards travel around the ring (``dist.batch_isend_irecv`` to the next rank,
from the previous one), and each rank combines its query block's partial
results with the online-softmax recurrence of the JAX package.  The next
shard's transfer is posted before the current block's attention is computed,
so that the two overlap.  The local block is one float32 product, as the
JAX package's ``einsum`` (no Pallas kernel there, no CUDA kernel here).

The backward runs the ring again, flash-style: the forward keeps each row's
log-sum-exp, and the block gradients are recomputed from it; dK and dV
travel with their K/V shard and come home after the last hop.

On CUDA tensors the ring needs NCCL: gloo sends host tensors only, and the
ring never stages K/V through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from confild_tpu_torch.parallel.mesh import DataMesh


def _ring(mesh: DataMesh, axis: str) -> tuple[int, int, int]:
    """``(ring size, next rank, previous rank)`` along ``axis``."""
    ranks = mesh.axis_ranks(axis)
    i = ranks.index(dist.get_rank())
    return len(ranks), ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)]


def _check_backend(t: torch.Tensor, mesh: DataMesh) -> None:
    if t.is_cuda and mesh.backend != "nccl":
        raise RuntimeError(f"ring attention on CUDA tensors needs the NCCL backend "
                           f"(the mesh's is {mesh.backend})")


def _post_rotation(tensors, nxt: int, prv: int, group):
    """Send ``tensors`` to ``nxt`` and receive as many from ``prv``; returns
    ``(receive buffers, requests)``."""
    bufs = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, b, prv, group) for b in bufs])
    return bufs, dist.batch_isend_irecv(ops)


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def _ring_forward(q, k, v, mesh: DataMesh, axis: str):
    """``(out, lse)`` of this rank's queries against every rank's keys."""
    n_ring, nxt, prv = _ring(mesh, axis)
    scale = q.shape[-1] ** -0.5
    m = torch.full((*q.shape[:2], 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n_ring):
        reqs = None
        if step < n_ring - 1:
            (k_nxt, v_nxt), reqs = _post_rotation((k_cur, v_cur), nxt, prv, mesh.group)
        s = torch.matmul(q, k_cur.transpose(1, 2)).float() * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v_cur.dtype), v_cur).float()
        m = m_new
        if reqs is not None:
            _wait(reqs)
            k_cur, v_cur = k_nxt, v_nxt
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _ring_backward(q, k, v, out, lse, dout, mesh: DataMesh, axis: str):
    """``(dq, dk, dv)`` of this rank's shards: dq from the local queries
    against every K/V shard; dk, dv summed over every rank's queries as the
    shard (with its gradient) goes round the ring and home."""
    n_ring, nxt, prv = _ring(mesh, axis)
    scale = q.shape[-1] ** -0.5
    qf, doutf = q.float(), dout.float()
    delta = (doutf * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros_like(qf)
    k_cur, v_cur = k, v
    dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_cur = torch.zeros_like(dk_cur)
    for step in range(n_ring):
        s = torch.matmul(qf, k_cur.float().transpose(1, 2)) * scale
        p = torch.exp(s - lse.unsqueeze(-1))
        dv_cur = dv_cur + torch.matmul(p.transpose(1, 2), doutf)
        ds = p * (torch.matmul(doutf, v_cur.float().transpose(1, 2)) - delta)
        dq = dq + torch.matmul(ds, k_cur.float()) * scale
        dk_cur = dk_cur + torch.matmul(ds.transpose(1, 2), qf) * scale
        if n_ring > 1:
            # the gradients go on with their shard; after the last hop each
            # shard, and its summed gradient, is home
            moving = (dk_cur, dv_cur) if step == n_ring - 1 else (k_cur, v_cur, dk_cur, dv_cur)
            bufs, reqs = _post_rotation(moving, nxt, prv, mesh.group)
            _wait(reqs)
            if step == n_ring - 1:
                dk_cur, dv_cur = bufs
            else:
                k_cur, v_cur, dk_cur, dv_cur = bufs
    return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


class _RingShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis):
        out, lse = _ring_forward(q, k, v, mesh, axis)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axis = mesh, axis
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_ring_backward(q, k, v, out, lse, dout.contiguous(), ctx.mesh, ctx.axis),
                None, None)


class _Scatter(torch.autograd.Function):
    """This rank's token slice of a replicated tensor; the backward gathers
    the slices' gradients, so the replicated input gets its full gradient
    on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        n_ring, index = len(mesh.axis_ranks(axis)), mesh.axis_ranks(axis).index(dist.get_rank())
        ctx.mesh, ctx.axis = mesh, axis
        return x.chunk(n_ring, dim=1)[index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_tokens(g, ctx.mesh, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    """The token slices of every rank of the ring, concatenated; the
    backward keeps this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _gather_tokens(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        ranks = ctx.mesh.axis_ranks(ctx.axis)
        return g.chunk(len(ranks), dim=1)[ranks.index(dist.get_rank())].contiguous(), None, None


def _gather_tokens(x, mesh: DataMesh, axis: str):
    ranks = mesh.axis_ranks(axis)
    if len(ranks) == 1:
        return x
    if len(ranks) != mesh.size:
        raise ValueError("ring attention runs over a 1-D mesh: its ring is the mesh")
    parts = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=1)


def ring_attention(q, k, v, mesh: DataMesh, axis: str = "data"):
    """Sequence-parallel attention with the JAX package's interface:
    ``q, k, v`` ``(BH, N, D)`` replicated on every rank of the ring (as
    the U-Net computes them); each rank attends with its contiguous token
    slice of Q while the K/V slices go round the ring, and the output's
    slices are gathered, so every rank returns the full ``(BH, N, D)``.
    Gradients reach the replicated inputs in full on every rank.  Requires
    N divisible by the ring size."""
    n_ring = len(mesh.axis_ranks(axis))
    n = q.shape[1]
    if n % n_ring:
        raise ValueError(f"token axis {n} not divisible by the ring of {n_ring}")
    _check_backend(q, mesh)
    q, k, v = (_Scatter.apply(t, mesh, axis) for t in (q, k, v))
    return _Gather.apply(_RingShard.apply(q, k, v, mesh, axis), mesh, axis)
