"""Checkpoint files of the CNF and diffusion trainers
(``confild_tpu/io/checkpoint.py``): discovery, rotation, and atomic
``torch.save``.

* CNF, the reference's layout (``scripts/train.py:468-528``):
  ``checkpoint_{epoch}.pt`` holds ``epoch``, ``model_state_dict``,
  ``hidden_states``, ``optim_net_dec_dict`` and ``optim_states_dict``; one
  ``normalizer_params.pt`` sits beside them.
* diffusion, the reference's triplet (``train_util.py:272-311``):
  ``model{step:06d}.pt`` and ``ema_{rate}_{step:06d}.pt`` (U-Net state
  dicts with the reference keys) and ``opt{step:06d}.pt`` (the AdamW state
  dict); the resume step is parsed from the file name.

The JAX package's ``.ckpt`` pickles of either kind are found too and read
by :mod:`confild_tpu_torch.io.convert`.  Orbax directories (the JAX
package's multi-process checkpoints) are not read by the port: reading them
needs orbax, which imports JAX (:func:`confild_tpu_torch.io.convert.read_ckpt`
says how to convert one).

Under a process group the state is replicated, so one file holds it: rank 0
writes it (:func:`save` is a no-op on the other ranks; the trainers add a
barrier after a save), every rank reads it, and only rank 0 rotates
(``confild_tpu/io/checkpoint.py:104-110``).
"""

from __future__ import annotations

import glob
import os
import re
import shutil
from typing import Any

import torch

from confild_tpu_torch.parallel.mesh import process_index


def save(path: str, obj: Any) -> None:
    """``torch.save`` through a temporary file and an atomic rename, so a
    crash never leaves a truncated checkpoint under the final name.  Only
    rank 0 of a process group writes."""
    if process_index() != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def latest_checkpoint(save_path: str,
                      pattern: str = "checkpoint_*.pt") -> tuple[str, int] | None:
    """The newest ``checkpoint_{id}`` file matching ``pattern``: ``(path,
    id)`` or None (reference ``load(-1)`` discovery, ``scripts/train.py:
    483-496``).  A checkpoint the JAX package stranded as ``*.old`` while
    replacing a directory checkpoint is renamed back first."""
    for stranded in glob.glob(os.path.join(save_path, pattern + ".old")):
        target = stranded[: -len(".old")]
        if not os.path.exists(target):
            os.rename(stranded, target)
    best = None
    for p in glob.glob(os.path.join(save_path, pattern)):
        m = re.search(r"_(\d+)\.\w+$", p)
        if m and (best is None or int(m.group(1)) > best[1]):
            best = (p, int(m.group(1)))
    return best


# file name -> generation, per checkpoint kind
_GENERATION = {"cnf": r"^checkpoint_(\d+)\.pt$",
               "diffusion": r"^(?:model|opt|ema_[\d.]+_)(\d+)\.pt$"}


def rotate_checkpoints(save_path: str, keep: int, kind: str = "cnf") -> list[str]:
    """Delete all but the newest ``keep`` generations of the port's ``.pt``
    checkpoints in ``save_path`` (rank 0 only: the other ranks delete
    nothing); returns the deleted paths.  ``kind``:
    ``"cnf"`` (``checkpoint_{epoch}.pt``) or ``"diffusion"`` (the
    ``model/ema_*/opt{step:06d}.pt`` triplet, rotated as a unit so a kept
    model keeps its EMA and optimizer)."""
    if kind not in _GENERATION:
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    if not keep or keep <= 0 or process_index() != 0:
        return []
    groups: dict[int, list[str]] = {}
    for p in glob.glob(os.path.join(save_path, "*.pt")):
        m = re.search(_GENERATION[kind], os.path.basename(p))
        if m:
            groups.setdefault(int(m.group(1)), []).append(p)
    deleted = []
    for gen in sorted(groups)[:-keep]:
        for p in groups[gen]:
            (shutil.rmtree if os.path.isdir(p) else os.remove)(p)
            deleted.append(p)
    return deleted


def parse_resume_step(filename: str) -> int:
    """``model123456.pt -> 123456`` (reference ``train_util.py:298-311``)."""
    m = re.search(r"model(\d+)\.\w+$", os.path.basename(filename))
    return int(m.group(1)) if m else 0


def diffusion_paths(save_dir: str, step: int, rates) -> dict:
    """The triplet's file names at ``step``: ``{"model", "opt", "ema":
    {rate: path}}`` (reference ``train_util.py:272-295``)."""
    return {"model": os.path.join(save_dir, f"model{step:06d}.pt"),
            "opt": os.path.join(save_dir, f"opt{step:06d}.pt"),
            "ema": {r: os.path.join(save_dir, f"ema_{r}_{step:06d}.pt") for r in rates}}


def find_ema_checkpoint(main_path: str | None, step: int, rate: str) -> str | None:
    """``ema_{rate}_{step:06d}`` beside ``main_path``, with its extension
    (``.pt``, or the JAX package's ``.ckpt``) or else the other one."""
    if not main_path:
        return None
    ext = os.path.splitext(main_path)[1]
    for e in (ext, ".ckpt" if ext == ".pt" else ".pt"):
        path = os.path.join(os.path.dirname(main_path), f"ema_{rate}_{step:06d}{e}")
        if os.path.exists(path):
            return path
    return None
