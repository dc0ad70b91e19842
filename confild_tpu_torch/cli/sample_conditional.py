"""Conditional (DPS) generation CLI, the Case4 random-sensor workflow
(reference ``ConditionalDiffusionGeneration/inference_scripts/Case4/
random_sensor/inference_phy_random_sensor.ipynb``):

    python -m confild_tpu_torch.cli.sample_conditional recipe.yml

Config keys follow ``confild_tpu/cli/sample_conditional.py`` (reference
``README.md:100-131``):

  cnf_checkpoint, cnf_normalizer, cnf_coords   — full-mesh decode assets
  sensor_coords, sensor_measures               — sparse sensor data
  data_max, data_min                           — latent scale files
  ema_path + U-Net keys                        — diffusion model (.pt or .ckpt)
  operator, conditioning, scale, sampler, steps, noise_schedule, ...
  no_of_samples, time_length, latent_size, seed, save_path
  infos (optional .npz with Mask + reduced_shape for grid reconstruction)
  device (optional; the default is the CUDA card, cuda:LOCAL_RANK under
  torchrun)

The ensemble is a batch dimension: samples are independent, each with its
own misfit and gradient.  Under ``torchrun --nproc-per-node N`` with N
dividing ``no_of_samples``, the ensemble shards over the ranks
(``confild_tpu/cli/sample_conditional.py:94-101``): ``x_start`` and every
step's noise are drawn for the whole ensemble and each rank keeps its
members, so a member's trajectory is the one it has in one process; rank 0
gathers the samples, decodes and saves them.  The operator routes by the
rows of the batch it sees, a rank's shard (``guidance/operators.py``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.cli.sample import load_unet
from confild_tpu_torch.cli.train_diffusion import build_model_and_diffusion
from confild_tpu_torch.core.packing import reconstruct_frame
from confild_tpu_torch.device import synchronize
from confild_tpu_torch.guidance import (create_sampler, get_conditioning_method,
                                        get_noise, get_operator)
from confild_tpu_torch.inference import decoder
from confild_tpu_torch.parallel import mesh as pmesh


def main(argv=None) -> dict | None:
    """Run the recipe; returns the wall seconds of the guided sampling and
    (on rank 0) of the full-field decode, the step count and whether this
    rank's operator took the kernels (None on a rank that takes no part)."""
    argv = argv if argv is not None else sys.argv[1:]
    hp = cfgmod.basic_input(argv[0])
    device = pmesh.initialize_distributed(hp.get("device"))
    n = hp.get("no_of_samples", 10)
    world = pmesh.process_count()
    mesh = pmesh.get_mesh(world) if world > 1 and n % world == 0 else None
    rank = pmesh.process_index()
    if mesh is None and rank > 0:
        print(f"rank {rank}: {n} samples do not shard over {world} ranks, not sampling")
        return None

    model, _ = build_model_and_diffusion(hp)
    # sampling only: the torso's convolutions pre-cast once (bit-identical
    # to the cast at use), as the JAX CLI does on every load
    model = load_unet(hp.ema_path, model).to(device).eval().requires_grad_(False)
    model.cast_torso_params()

    measurement = torch.as_tensor(np.load(hp.sensor_measures), dtype=torch.float32,
                                  device=device)
    mask = torch.ones_like(measurement)

    operator = get_operator(
        hp.get("operator", "case4"),
        coords_path=hp.sensor_coords, max_val_path=hp.data_max,
        min_val_path=hp.data_min, normalizer_params_path=hp.cnf_normalizer,
        ckpt_path=hp.cnf_checkpoint, batch_size=hp.get("operator_batch_size", 384),
        device=device)
    noiser = get_noise(hp.get("noise", "gaussian"), sigma=hp.get("noise_sigma", 0.0))
    cond_method = get_conditioning_method(hp.get("conditioning", "ps"), operator, noiser,
                                          scale=hp.get("scale", 1.0))
    sampler = create_sampler(
        sampler=hp.get("sampler", "ddpm"),
        steps=hp.get("steps", 1000),
        noise_schedule=hp.get("noise_schedule", "cosine"),
        model_mean_type=hp.get("model_mean_type", "epsilon"),
        model_var_type=hp.get("model_var_type", "fixed_large"),
        dynamic_threshold=hp.get("dynamic_threshold", False),
        clip_denoised=hp.get("clip_denoised", True),
        timestep_respacing=hp.get("timestep_respacing") or None,
    )

    seed = hp.get("seed", 0)
    shape = (n, 1, hp.time_length, hp.latent_size)
    rows = slice(0, n) if mesh is None else pmesh.shard_slice(n, mesh)
    x_start = torch.randn(shape, generator=torch.Generator(device).manual_seed(seed),
                          device=device)[rows]
    # the noise model applied to the measurements (notebook cell 14:
    # y_n = noiser(y)); 'clean' / sigma=0 is the identity
    measurement = noiser(measurement, generator=torch.Generator(device).manual_seed(seed + 2))
    noise_fn = sampler.sharded_noise_fn(shape, measurement, cond_method,
                                        torch.Generator(device).manual_seed(seed + 1), rows)
    fused = getattr(operator, "fused_route", lambda _: False)(x_start.shape[0] * hp.time_length)

    synchronize(device)
    t0 = time.perf_counter()
    samples = sampler.p_sample_loop(lambda x, t: model(x, t), x_start, mask * measurement,
                                    cond_method, noise_fn=noise_fn)
    synchronize(device)
    t_sample = time.perf_counter() - t0
    steps = sampler.diffusion.num_timesteps
    if mesh is not None:
        samples = pmesh.all_gather_cat(samples, mesh)
        if rank > 0:
            return {"sample_s": t_sample, "decode_s": None, "steps": steps, "fused": fused}
    samples = samples.reshape(n, hp.time_length, hp.latent_size)

    # decode full-resolution fields at the full mesh coords
    gen_latents = operator._unnorm(samples[:, None])[:, 0]
    t0 = time.perf_counter()
    fields = decoder(np.load(hp.cnf_coords), gen_latents.reshape(-1, hp.latent_size),
                     operator.model, operator.x_normalizer, operator.y_normalizer,
                     batch_size=hp.get("decode_batch_size", 16), w0=operator.w0,
                     device=device)
    t_decode = time.perf_counter() - t0
    fields = fields.reshape(n, hp.time_length, *fields.shape[1:])

    os.makedirs(os.path.dirname(os.path.abspath(hp.save_path)), exist_ok=True)
    np.save(hp.save_path, fields)
    print(f"saved conditional samples {fields.shape} -> {hp.save_path}; "
          f"{steps} guided steps in {t_sample:.3f} s ({x_start.shape[0]} samples on each of "
          f"{1 if mesh is None else mesh.size} ranks, the operator on the "
          f"{'kernels' if fused else 'plain decode'}), decode {t_decode:.3f} s")

    if hp.get("infos"):
        info = np.load(hp.infos)
        grid = reconstruct_frame(fields[0, 0], info["Mask"], info["reduced_shape"], 0.0)
        print(f"grid reconstruction: {tuple(grid.shape)}")
    return {"sample_s": t_sample, "decode_s": t_decode, "steps": steps, "fused": fused}


if __name__ == "__main__":
    main()
