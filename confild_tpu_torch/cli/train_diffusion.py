"""Diffusion training CLI, the port of ``confild_tpu/cli/train_diffusion.py``
(reference ``UnconditionalDiffusionTraining_and_Generation/scripts/train.py``):

    python -m confild_tpu_torch.cli.train_diffusion case.yml

Data contract preserved: ``train_data_path`` / ``valid_data_path`` .npy
latent stacks, global min-max to [-1, 1], channel dim added; the (max, min)
pair is saved to the log dir as ``data_max.npy`` / ``data_min.npy`` for the
inference CLIs.  A fresh run starts from the reference initialisation drawn
from ``seed`` (default 42); ``resume_checkpoint`` names a
``model{step:06d}.pt`` (or JAX ``.ckpt``) triplet to continue.  ``device``
(optional; the default is the CUDA card, ``cuda:LOCAL_RANK`` under
torchrun).

Data parallel over ranks: ``torchrun --nproc-per-node N -m
confild_tpu_torch.cli.train_diffusion case.yml``.  The mesh is the largest
count of ranks that divides ``batch_size``, as the JAX CLI picks devices;
ranks beyond it take no part.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.parallel import mesh as pmesh
from confild_tpu_torch.train.diffusion_trainer import TrainLoop, load_latent_image_data
from confild_tpu_torch.utils import logger as tlog


def build_model_and_diffusion(hp):
    """The U-Net and its diffusion from a recipe (``confild_tpu/cli/
    train_diffusion.py:28-53``)."""
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
        use_bf16=hp.get("use_bf16", hp.get("use_fp16", False)),
        use_checkpoint=hp.get("use_checkpoint", False),
        remat_policy=hp.get("remat_policy", "full"),
        use_flash_attention=hp.get("use_flash_attention"),
        use_f32_tail=hp.get("use_f32_tail", False),
    )
    diffusion = create_gaussian_diffusion(
        steps=hp.steps,
        noise_schedule=hp.noise_schedule,
        learn_sigma=hp.get("learn_sigma", False),
        timestep_respacing=hp.get("timestep_respacing") or None,
    )
    return model, diffusion


def main(argv=None) -> TrainLoop | None:
    """Train the recipe; returns the finished :class:`TrainLoop` (None on a
    rank outside the mesh)."""
    argv = argv if argv is not None else sys.argv[1:]
    hp = cfgmod.basic_input(argv[0])
    device = pmesh.initialize_distributed(hp.get("device"))
    # the data mesh must evenly divide the batch
    n = pmesh.process_count()
    while n > 1 and hp.batch_size % n:
        n -= 1
    mesh = pmesh.get_mesh(n) if n > 1 else None
    if pmesh.process_index() >= n:
        print(f"rank {pmesh.process_index()}: outside the {n}-rank mesh, not training")
        return None

    log_dir = hp.get("log_path") or "./diffusion_logs"
    tlog.configure(log_dir, ["stdout", "log", "csv", "tensorboard"])

    # every rank reads the same global batches (the same seed) and keeps
    # its slice of each
    data, valid_data, (mx, mn) = load_latent_image_data(
        hp.train_data_path, hp.get("valid_data_path"), hp.batch_size)
    if pmesh.process_index() == 0:
        np.save(os.path.join(log_dir, "data_max.npy"), mx)
        np.save(os.path.join(log_dir, "data_min.npy"), mn)

    seed = hp.get("seed", 42)
    model, diffusion = build_model_and_diffusion(hp)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    loop = TrainLoop(
        model=model,
        diffusion=diffusion,
        data=data,
        valid_data=valid_data,
        batch_size=hp.batch_size,
        microbatch=hp.get("microbatch", -1),
        lr=float(hp.lr),
        ema_rate=hp.get("ema_rate", "0.9999"),
        log_interval=hp.get("log_interval", 10),
        save_interval=hp.get("save_interval", 10000),
        resume_checkpoint=hp.get("resume_checkpoint", ""),
        weight_decay=hp.get("weight_decay", 0.0),
        lr_anneal_steps=hp.get("lr_anneal_steps", 0),
        save_dir=log_dir,
        mesh=mesh,
        seed=seed,
        device=device,
    )
    loop.run_loop()
    return loop


if __name__ == "__main__":
    main()
