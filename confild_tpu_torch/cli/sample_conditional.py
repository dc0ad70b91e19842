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
  device (optional; the default is the CUDA card)

The ensemble is a batch dimension: samples are independent, each with its
own misfit and gradient.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.core.packing import reconstruct_frame
from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.guidance import (create_sampler, get_conditioning_method,
                                        get_noise, get_operator)
from confild_tpu_torch.inference import decoder
from confild_tpu_torch.io.convert import load_unet_state_dict
from confild_tpu_torch.models import unet as tunet


def build_model_and_diffusion(hp):
    """Counterpart of ``confild_tpu/cli/train_diffusion.py::
    build_model_and_diffusion``: the U-Net and its diffusion from a recipe."""
    if hp.get("use_bf16", hp.get("use_fp16", False)):
        raise NotImplementedError(
            "the bf16 U-Net torso is not ported yet (ROADMAP.md Queue 1, "
            "item 10: diffusion training with a bf16 torso)")
    model = tunet.create_model(
        image_size=hp.image_size,
        num_channels=hp.num_channels,
        num_res_blocks=hp.num_res_blocks,
        channel_mult=hp.get("channel_mult"),
        attention_resolutions=hp.attention_resolutions,
        num_heads=hp.get("num_heads", 4),
        num_head_channels=hp.get("num_head_channels", -1),
        out_channels=hp.get("out_channels", 1),
        dims=hp.get("dims", 2),
        use_scale_shift_norm=hp.get("use_scale_shift_norm", False),
        dropout=hp.get("dropout", 0.0),
        use_flash_attention=hp.get("use_flash_attention"),
    )
    diffusion = create_gaussian_diffusion(
        steps=hp.steps,
        noise_schedule=hp.noise_schedule,
        learn_sigma=hp.get("learn_sigma", False),
        timestep_respacing=hp.get("timestep_respacing") or None,
    )
    return model, diffusion


def load_unet(path: str, model: tunet.UNetModel) -> tunet.UNetModel:
    """Counterpart of ``confild_tpu/cli/sample.py::load_unet_params``."""
    model.load_state_dict(load_unet_state_dict(path, model))
    return model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the recipe; returns the wall seconds of the guided sampling and
    of the full-field decode."""
    argv = argv if argv is not None else sys.argv[1:]
    hp = cfgmod.basic_input(argv[0])
    device = resolve_device(hp.get("device"))

    model, _ = build_model_and_diffusion(hp)
    model = load_unet(hp.ema_path, model).to(device).eval().requires_grad_(False)

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
    n = hp.get("no_of_samples", 10)
    x_start = torch.randn((n, 1, hp.time_length, hp.latent_size),
                          generator=torch.Generator(device).manual_seed(seed),
                          device=device)
    # the noise model applied to the measurements (notebook cell 14:
    # y_n = noiser(y)); 'clean' / sigma=0 is the identity
    measurement = noiser(measurement, generator=torch.Generator(device).manual_seed(seed + 2))

    _sync(device)
    t0 = time.perf_counter()
    samples = sampler.p_sample_loop(
        lambda x, t: model(x, t), x_start, mask * measurement, cond_method,
        generator=torch.Generator(device).manual_seed(seed + 1))
    _sync(device)
    t_sample = time.perf_counter() - t0
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
    steps = sampler.diffusion.num_timesteps
    print(f"saved conditional samples {fields.shape} -> {hp.save_path}; "
          f"{steps} guided steps in {t_sample:.3f} s, decode {t_decode:.3f} s")

    if hp.get("infos"):
        info = np.load(hp.infos)
        grid = reconstruct_frame(fields[0, 0], info["Mask"], info["reduced_shape"], 0.0)
        print(f"grid reconstruction: {tuple(grid.shape)}")
    return {"sample_s": t_sample, "decode_s": t_decode, "steps": steps}


if __name__ == "__main__":
    main()
