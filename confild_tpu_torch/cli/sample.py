"""Unconditional generation CLI, the port of ``confild_tpu/cli/sample.py``
(reference ``UnconditionalDiffusionTraining_and_Generation/scripts/
inference.py``):

    python -m confild_tpu_torch.cli.sample case.yml

Samples ``test_batch_size`` latent images ``(1, time_length,
latent_length)`` with the EMA U-Net (``ema_path``, ``.pt`` or the JAX
package's ``.ckpt``) through the ancestral loop, denormalizes them with the
saved ``max_val`` / ``min_val``, decodes every latent row at the CNF's
training coordinates through the trained CNF (``cnf_case_file_path``: its
newest checkpoint in ``save_path``, decoder only) in ``decode_batch_size``
chunks, and saves the ``(B, T, M, C)`` fields to ``save_path``.  The draws
come from a generator seeded with ``seed``.  ``device`` (optional; the
default is the CUDA card).  A bf16 U-Net (``use_bf16``) has its torso's
convolutions pre-cast after loading (``UNetModel.cast_torso_params``).  The
decode is ``CNFTrainer.infer``, the plain SIREN-FiLM decode, as in the JAX
package.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.cli.train_diffusion import build_model_and_diffusion
from confild_tpu_torch.core.packing import unit_interval_to_minmax, unpack_latents
from confild_tpu_torch.device import resolve_device, synchronize
from confild_tpu_torch.io.convert import load_unet_state_dict
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.train.cnf_trainer import CNFTrainer


def load_unet(path: str, model: tunet.UNetModel) -> tunet.UNetModel:
    """Counterpart of ``confild_tpu/cli/sample.py::load_unet_params``."""
    model.load_state_dict(load_unet_state_dict(path, model))
    return model


def main(argv=None) -> dict:
    """Run the recipe; returns the wall seconds of the sampling loop and of
    the decode, the step count, and the denormalized latents ``(B, T, L)``."""
    argv = argv if argv is not None else sys.argv[1:]
    hp = cfgmod.basic_input(argv[0])
    device = resolve_device(hp.get("device"))

    model, diffusion = build_model_and_diffusion(hp)
    # sampling only: the torso's convolutions pre-cast once (bit-identical
    # to the cast at use), as the JAX CLI does on every load
    model = load_unet(hp.ema_path, model).to(device).eval().requires_grad_(False)
    model.cast_torso_params()
    shape = (hp.test_batch_size, 1, hp.time_length, hp.latent_length)

    synchronize(device)
    t0 = time.perf_counter()
    gen = diffusion.p_sample_loop(
        model, shape, generator=torch.Generator(device).manual_seed(hp.get("seed", 0)))
    synchronize(device)
    t_sample = time.perf_counter() - t0

    max_val = float(np.load(hp.max_val))
    min_val = float(np.load(hp.min_val))
    gen_latents = unit_interval_to_minmax(unpack_latents(gen), max_val, min_val)

    # decode through the CNF stage (the reference reuses the CNF trainer,
    # scripts/inference.py:64-79)
    fptrainer = CNFTrainer(cfgmod.basic_input(hp.cnf_case_file_path), device=device)
    fptrainer.load(-1, siren_only=True)
    decode_bs = hp.get("decode_batch_size", 16)
    t0 = time.perf_counter()
    fields = np.stack([
        np.concatenate([fptrainer.infer(fptrainer.train_coord, lat[i:i + decode_bs])
                        .cpu().numpy() for i in range(0, lat.shape[0], decode_bs)])
        for lat in gen_latents])
    t_decode = time.perf_counter() - t0

    os.makedirs(os.path.dirname(os.path.abspath(hp.save_path)), exist_ok=True)
    np.save(hp.save_path, fields)
    steps = diffusion.num_timesteps
    print(f"saved generated fields {fields.shape} -> {hp.save_path}; {steps} steps in "
          f"{t_sample:.3f} s, decode {t_decode:.3f} s")
    return {"sample_s": t_sample, "decode_s": t_decode, "steps": steps,
            "latents": gen_latents.cpu().numpy()}


if __name__ == "__main__":
    main()
