"""CNF inference API (reference ``ConditionalNeuralField/cnf/
inference_function.py``): batched decode helpers and the checkpoint-driven
``CNF_inference`` class.  The decoder is any name of the registry: a
``SIRENAutodecoder_film`` decodes through the fused CUDA kernel
(:mod:`confild_tpu_torch.ops.siren_decode`) on the card, every other one on
the plain route (its own forward under autograd), as the JAX package decodes
a non-FiLM decoder.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import yaml

from confild_tpu_torch.core import normalize as cnorm
from confild_tpu_torch.core.packing import create_coordinates_grid
from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.io import convert
from confild_tpu_torch.models.cnf import SirenFilm, create_nf, nf_kwargs
from confild_tpu_torch.ops.siren_decode import siren_decode


def _f32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _inputs(coords, latents, x_normalizer, device):
    return x_normalizer.normalize(_f32(coords, device)), _f32(latents, device)


def _decode(model: torch.nn.Module, coords, rows, w0: float, use_pallas: bool):
    """``(T, L) x (M, C) -> (T, M, C_out)``: the FiLM decoder through
    ``siren_decode`` (the kernel when ``use_pallas``), any other decoder
    through its forward."""
    if isinstance(model, SirenFilm):
        return siren_decode(model, coords, rows, w0, use_pallas)
    return model(coords[None], rows[:, None])


def pass_through_model_batch(coords, latents, model: torch.nn.Module, x_normalizer,
                             y_normalizer, batch_size: int = 16,
                             use_pallas: bool = True, w0: float = 30.0,
                             device=None) -> torch.Tensor:
    """Batched decode ``(T, L) x (M, C) -> (T, M, C_out)`` kept on the
    device (reference ``inference_function.py:22-48``)."""
    coords, latents = _inputs(coords, latents, x_normalizer, resolve_device(device))
    outs = [y_normalizer.denormalize(
                _decode(model, coords, latents[sid:sid + batch_size], w0, use_pallas))
            for sid in range(0, latents.shape[0], batch_size)]
    return torch.cat(outs, dim=0)


@torch.no_grad()
def decoder(coords, latents, model: torch.nn.Module, x_normalizer, y_normalizer,
            batch_size: int = 16, use_pallas: bool = True, w0: float = 30.0,
            device=None) -> np.ndarray:
    """Streaming decode without gradients: each row chunk is copied to host
    numpy as it finishes, so any number of rows fits (reference
    ``inference_function.py:51-76`` streams to the CPU)."""
    coords, latents = _inputs(coords, latents, x_normalizer, resolve_device(device))
    outs = [y_normalizer.denormalize(
                _decode(model, coords, latents[sid:sid + batch_size], w0, use_pallas)
            ).cpu().numpy()
            for sid in range(0, latents.shape[0], batch_size)]
    return np.concatenate(outs, axis=0)


class CNF_inference:
    """Load a trained CNF (checkpoint + recipe + normalizers) and decode.

    Reads reference ``.pt`` checkpoints, including the published raw-tensor
    latent layout (``is_pub``, reference ``inference_function.py:182-212``),
    and the JAX package's ``.ckpt`` pytrees.
    """

    def __init__(self, checkpoint_path: str, config_path: str,
                 data_path: str | None = None, is_pub: bool = False,
                 use_pallas: bool = True, device=None):
        self.device = resolve_device(device)
        self.use_pallas = use_pallas
        with open(config_path) as f:
            self.config = yaml.safe_load(f)
        x_par, y_par = convert.load_normalizer_pair(checkpoint_path)
        self.x_normalizer = cnorm.Normalizer(x_par, "-11", 0).to(self.device)
        self.y_normalizer = cnorm.Normalizer(y_par, "-11", 0).to(self.device)

        nf = self.config["NF"]
        self.model = create_nf(nf["name"], **nf_kwargs(nf, self.config["dims"],
                                                        self.config["hidden_size"]))
        state, latents = convert.load_cnf_checkpoint(checkpoint_path, nf["name"])
        self.model.load_state_dict(state)
        self.model.to(self.device).requires_grad_(False)
        self.latents = (None if latents is None else
                        torch.tensor(latents, dtype=torch.float32, device=self.device))
        self.data = np.load(data_path) if data_path else None

    def predict(self, coords, latent_indices: Sequence[int] | None = None,
                batch_size: int = 16) -> np.ndarray:
        """Decode stored latents at physical coords (reference :219-259)."""
        latents = (self.latents if latent_indices is None
                   else self.latents[torch.as_tensor(latent_indices)])
        return decoder(coords, latents, self.model, self.x_normalizer,
                       self.y_normalizer, batch_size, use_pallas=self.use_pallas,
                       w0=getattr(self.model, "w0", 30.0), device=self.device)

    def get_all_predictions(self, coords, batch_size: int = 16) -> np.ndarray:
        return self.predict(coords, None, batch_size)

    def create_coordinates_grid(self, shape: Sequence[int] | None = None):
        """Unit-cube grid; the shape comes from the data when omitted
        (reference :266-304)."""
        if shape is None:
            if self.data is None:
                raise ValueError("need data or an explicit shape")
            shape = self.data.shape[1:-1]
        return create_coordinates_grid(shape)
