"""Dataset loader registry (reference ``cnf/utils/readdata.py``): tiny
``np.load`` wrappers selected by name from the recipe's ``load_data_fn``.
The port's own copy of ``confild_tpu/utils/readdata.py``."""

from __future__ import annotations

import numpy as np


def load_elbow_flow(path: str):
    """Elbow flow: drop the first frame (reference ``readdata.py:6-8``)."""
    return np.load(path)[1:]


def load_channel_flow(path: str, t_start: int = 0, t_end: int | None = None,
                      t_every: int = 1):
    return np.load(path)[t_start:t_end:t_every]


def load_channel_flow_complete(path: str):
    return np.load(path)


def load_periodic_hill_flow(path: str):
    return np.load(path)


def load_3d_flow(path: str):
    return np.load(path)


REGISTRY = {
    name: fn for name, fn in list(globals().items())
    if callable(fn) and name.startswith("load_")
}


def get_loader(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown load_data_fn {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
