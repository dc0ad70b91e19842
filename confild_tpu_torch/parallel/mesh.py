"""A data mesh over ``torch.distributed`` ranks, the port of
``confild_tpu/parallel/mesh.py``.

The JAX package runs one program over a ``Mesh`` of devices and lets XLA
place the collectives.  Here each rank is one process driving one device,
and :class:`DataMesh` is the grid of ranks with its axis names and the
process group over them.  The collectives are ``torch.distributed`` calls:
NCCL for CUDA tensors, gloo for CPU tensors.  The semantics are the JAX
package's:

* every rank passes the *global* batch, as every JAX process does, and
  :func:`shard_batch` keeps this rank's contiguous slice, in the order in
  which JAX lays the shards over the mesh (row-major over the batch axes);
* parameters are replicated: :func:`replicate` broadcasts them from the
  mesh's first rank;
* gradients are averaged over the mesh (:func:`all_reduce_mean_`, or DDP),
  which is what JAX's ``psum`` of a sharded batch's mean loss computes.

A mesh is built collectively: every rank of the process group calls
:func:`get_mesh` or :func:`get_hybrid_mesh` with the same arguments.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from confild_tpu_torch.device import resolve_device

DATA_AXIS = "data"

# mesh axes reserved for non-batch parallelism; every other axis is treated
# as data-parallel by ``batch_axes`` (a hybrid mesh shards the batch over
# ('replica', 'data') jointly)
NON_BATCH_AXES = frozenset({"model", "tensor", "seq", "pipe", "pipeline"})

# every process group is created with a finite timeout: a rank that dies
# leaves the others waiting at most this long
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """The counterpart of ``jax.sharding.Mesh``: ``ranks`` is the grid of
    global ranks (one axis per name in ``axis_names``), ``group`` the
    process group over them (None: the default group)."""

    ranks: np.ndarray
    axis_names: tuple[str, ...]
    group: Any = None

    def __post_init__(self):
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"a {self.ranks.ndim}-D rank grid needs as many axis names, "
                             f"got {self.axis_names}")

    def __deepcopy__(self, memo):
        # a process group cannot be copied: a copied model shares the mesh
        return self

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        return bool((self.ranks == dist.get_rank()).any())

    def _coords(self) -> tuple[int, ...]:
        found = np.argwhere(self.ranks == dist.get_rank())
        if not len(found):
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh {self.ranks.tolist()}")
        return tuple(int(c) for c in found[0])

    def batch_index(self) -> tuple[int, int]:
        """``(this rank's batch shard, number of batch shards)``: the
        position over the batch axes, row-major as JAX lays a batch
        sharded over several axes."""
        axes = [i for i, a in enumerate(self.axis_names) if a not in NON_BATCH_AXES]
        coords, sizes = self._coords(), self.ranks.shape
        index = 0
        for i in axes:
            index = index * sizes[i] + coords[i]
        return index, int(np.prod([sizes[i] for i in axes]))

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks along ``axis`` through this rank, in order."""
        coords = list(self._coords())
        i = self.axis_names.index(axis)
        coords[i] = slice(None)
        return [int(r) for r in self.ranks[tuple(coords)]]


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def initialize_distributed(device=None, *, timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                           **kwargs) -> torch.device:
    """Join the process group and return this rank's device.

    The device is ``device``, or ``cuda:LOCAL_RANK`` (torchrun's variable)
    when ``device`` is None or ``"cuda"``; it must be ``"cpu"`` to run on
    the CPU.  With ``kwargs`` (``init_method``, ``world_size``, ``rank``,
    ``backend``), or when torchrun's ``WORLD_SIZE`` exceeds 1, the process
    group is initialized with ``timeout`` and the backend NCCL for a CUDA
    device, gloo for the CPU (pass ``backend="gloo"`` for several ranks on
    one card: NCCL refuses two ranks on one device).  A group that is
    already initialized is kept.  On a card, the first rank of each host
    builds the CUDA kernels before a barrier, so that N ranks do not run
    ``nvcc`` N times."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized() or not (kwargs or int(os.environ.get("WORLD_SIZE", 1)) > 1):
        return dev
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(timeout=timeout, **kwargs)
    if dev.type == "cuda":
        from confild_tpu_torch.ops import cuda_build
        if int(os.environ.get("LOCAL_RANK", dist.get_rank())) == 0:
            cuda_build.build_all(sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu")))
        barrier(DataMesh(np.arange(dist.get_world_size()), (DATA_AXIS,)))
    return dev


def barrier(mesh: DataMesh | None) -> None:
    """Wait for every rank of ``mesh``; a no-op without a mesh."""
    if mesh is None:
        return
    if mesh.backend == "nccl":
        dist.barrier(mesh.group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(mesh.group)


def batch_axes(mesh: DataMesh) -> tuple[str, ...]:
    """The mesh axes the batch dim shards over: every axis not reserved
    for model, tensor, sequence or pipeline parallelism."""
    return tuple(a for a in mesh.axis_names if a not in NON_BATCH_AXES)


def batch_spec(mesh: DataMesh):
    """The batch dim's sharding: one axis name, or the tuple of them on a
    hybrid mesh (``PartitionSpec``'s first entry in the JAX package)."""
    axes = batch_axes(mesh)
    if not axes:
        raise ValueError(
            f"mesh {mesh.axis_names} has no data-parallel axis (all axes are "
            f"in NON_BATCH_AXES={sorted(NON_BATCH_AXES)}); add a batch axis "
            f"such as 'data' to shard inputs over it")
    return axes if len(axes) > 1 else axes[0]


def _group(ranks: np.ndarray):
    """The default group when ``ranks`` are all of them, else a new group
    (created collectively: every rank must call this)."""
    if ranks.size == dist.get_world_size():
        return None
    return dist.new_group(ranks=sorted(int(r) for r in ranks.flat))


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call initialize_distributed() first "
                           "(or launch with torchrun)")
    return dist.get_world_size()


def get_mesh(n_devices: int | None = None,
             axis_names: Sequence[str] = (DATA_AXIS,)) -> DataMesh:
    """A 1-D data mesh over ranks ``0 .. n_devices - 1`` (all by default)."""
    world = _world()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(
            f"requested a {n}-rank device mesh but the process group holds only "
            f"{world} ranks; launch {n} (torchrun --nproc-per-node {n})")
    if len(axis_names) > 1:
        raise ValueError("pass an explicit rank grid for multi-axis meshes"
                         " (or use get_hybrid_mesh for a (replica, data) layout)")
    ranks = np.arange(n)
    return DataMesh(ranks, tuple(axis_names), _group(ranks))


def get_hybrid_mesh(n_slices: int | None = None,
                    axis_names: Sequence[str] = ("replica", DATA_AXIS)) -> DataMesh:
    """A 2-D (replica, data) mesh over every rank: ``n_slices`` rows (by
    default one per host, from torchrun's ``LOCAL_WORLD_SIZE``), the ranks
    of one row on one host.  The batch shards over both axes jointly, which
    is flat data parallelism over all ranks."""
    world = _world()
    if n_slices is None:
        n_slices = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % n_slices:
        raise ValueError(f"{world} ranks do not fold into {n_slices} slices")
    ranks = np.arange(world).reshape(n_slices, -1)
    return DataMesh(ranks, tuple(axis_names), None)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_slice(n: int, mesh: DataMesh) -> slice:
    """This rank's contiguous part of ``n`` batch rows."""
    index, shards = mesh.batch_index()
    if n % shards:
        raise ValueError(f"a batch of {n} does not shard over {shards} ranks")
    per = n // shards
    return slice(index * per, (index + 1) * per)


def shard_batch(batch: Any, mesh: DataMesh, axis: int = 0) -> Any:
    """This rank's slice of every leaf (tensors and arrays) along ``axis``.
    Every rank passes the same global batch."""
    def take(x):
        sl = shard_slice(x.shape[axis], mesh)
        if isinstance(x, torch.Tensor):
            return x.narrow(axis, sl.start, sl.stop - sl.start)
        return np.asarray(x)[(slice(None),) * axis + (sl,)]
    return _tree_map(take, batch)


@torch.no_grad()
def replicate(tree: Any, mesh: DataMesh) -> Any:
    """Broadcast every tensor of ``tree`` in place from the mesh's first
    rank; returns ``tree``."""
    src = int(mesh.ranks.flat[0])

    def bcast(x):
        if isinstance(x, torch.Tensor):
            dist.broadcast(x.data, src, group=mesh.group)
        return x
    return _tree_map(bcast, tree)


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: DataMesh) -> None:
    """Average ``tensors`` (one dtype, one device) over the mesh in place,
    with one all-reduce of their concatenation."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_gather_cat(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along its first dim in the mesh's
    order, on every rank.  Over gloo the shards go through the host explicitly:
    gloo gathers CPU tensors only."""
    src = t.detach().contiguous()
    if mesh.backend == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k
