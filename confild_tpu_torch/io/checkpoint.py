"""Checkpoint files of the CNF trainer (``confild_tpu/io/checkpoint.py``):
discovery of the newest ``checkpoint_{epoch}`` file, rotation, and atomic
``torch.save``.

The CNF layout is the reference's (``scripts/train.py:468-528``):
``checkpoint_{epoch}.pt`` holds ``epoch``, ``model_state_dict``,
``hidden_states``, ``optim_net_dec_dict`` and ``optim_states_dict``; one
``normalizer_params.pt`` sits beside them.  The JAX package's
``checkpoint_{epoch}.ckpt`` pickles are found too and read by
:mod:`confild_tpu_torch.io.convert`.  Orbax directories (the JAX
package's multi-process checkpoints) are not read by the port.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
from typing import Any

import torch


def save(path: str, obj: Any) -> None:
    """``torch.save`` through a temporary file and an atomic rename, so a
    crash never leaves a truncated checkpoint under the final name."""
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


def rotate_checkpoints(save_path: str, keep: int) -> list[str]:
    """Delete all but the newest ``keep`` generations of the CNF trainer's
    ``checkpoint_{epoch}.pt`` files; returns the deleted paths.  The
    diffusion trainer's ``model*/ema_*/opt*`` files come with its slice."""
    if not keep or keep <= 0:
        return []
    groups: dict[int, list[str]] = {}
    for p in glob.glob(os.path.join(save_path, "checkpoint_*.pt")):
        m = re.search(r"_(\d+)\.pt$", p)
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
