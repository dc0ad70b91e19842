"""Latent <-> image packing, coordinate grids and mask scatter.

The diffusion stage treats a trajectory's latent sequence ``(T, L)`` as a
1-channel "image" ``(B, 1, T, L)`` (reference ``README.md:161-163``).
``reconstruct_frame`` scatters flat mesh-point decodes back onto a dense grid
through a geometry mask (reference ``cnf/inference_function.py:15-19``).
Coordinate grids are unit-cube meshgrids with ``ij`` indexing.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def create_coordinates_grid(shape: Sequence[int], dtype=np.float32) -> np.ndarray:
    """Unit-cube coordinate grid: ``shape=(H, W, ...) -> (H, W, ..., ndim)``."""
    axes = [np.linspace(0.0, 1.0, s, dtype=dtype) for s in shape]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def reconstruct_frame(flat_values, mask, shape: Sequence[int],
                      fill_value=0.0) -> torch.Tensor:
    """Scatter ``(n_points, C)`` values into a ``(*shape, C)`` grid.

    ``mask`` is a boolean array of ``shape`` selecting the mesh points in
    row-major order; cells outside the geometry hold ``fill_value``.
    """
    idx = np.nonzero(np.asarray(mask, dtype=bool).reshape(-1))[0]
    values = torch.as_tensor(flat_values)
    if values.shape[0] != idx.shape[0]:
        raise ValueError(
            f"{values.shape[0]} values for {idx.shape[0]} masked cells")
    n_cells = int(np.prod(shape))
    out = torch.full((n_cells, values.shape[-1]), fill_value,
                     dtype=values.dtype, device=values.device)
    out[torch.as_tensor(idx, device=values.device)] = values
    return out.reshape(*shape, values.shape[-1])


def unit_interval_to_minmax(data_norm, data_max, data_min):
    """[-1, 1] -> original range (reference ``scripts/inference.py:59-61``,
    ``measurements.py:88-89``)."""
    return (data_norm + 1.0) * (data_max - data_min) / 2.0 + data_min
