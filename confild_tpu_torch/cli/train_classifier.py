"""Noised-classifier training CLI, the port of ``confild_tpu/cli/
train_classifier.py`` (upstream guided-diffusion's ``classifier_train.py``):

    python -m confild_tpu_torch.cli.train_classifier case.yml
    torchrun --nproc-per-node N -m confild_tpu_torch.cli.train_classifier case.yml

The JAX CLI's recipe keys::

    train_data_path: latents.npy      # (N, T, L) latent images
    label_path: labels.npy            # (N,) int class labels
    image_size: 64
    classifier_width: 128
    classifier_depth: 2
    classifier_attention_resolutions: "32,16,8"
    out_channels: 2                   # number of classes
    batch_size: 32
    lr: 3.e-4
    weight_decay: 0.05
    lr_anneal_steps: 10000
    noised: true                      # classify q_sample(x, t) at random t
    steps: 1000
    noise_schedule: cosine
    diffusion_log_path: ./diff_logs   # optional: the diffusion run's
                                      # data_max/min.npy scale
    data_max: 3.2                     # optional: an explicit scale
    data_min: -3.2

plus ``device`` (optional; the default is the CUDA card, ``cuda:LOCAL_RANK``
under torchrun).  The scale contract is the JAX CLI's: ``data_max`` /
``data_min`` first, else the diffusion run's persisted scale, else the
training tensor's min-max.  The classifier starts from the reference
initialisation drawn from seed 42.  Data parallel over ranks as
``train_diffusion``: the mesh is the largest count of ranks that divides
``batch_size``; ranks beyond it take no part.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.models.unet_extras import create_classifier
from confild_tpu_torch.parallel import mesh as pmesh
from confild_tpu_torch.train.classifier_trainer import ClassifierTrainLoop
from confild_tpu_torch.utils import logger as tlog

SEED = 42


def load_labeled_data(hp) -> tuple[np.ndarray, np.ndarray]:
    """``(normed (N, 1, T, L) in [-1, 1], labels (N,))`` under the JAX CLI's
    scale contract (``confild_tpu/cli/train_classifier.py:55-76``): the
    classifier sees the latent-image space the sampler will ask it to
    grade."""
    raw = np.load(hp.train_data_path).astype(np.float32)
    if hp.get("data_max") is not None and hp.get("data_min") is not None:
        mx, mn = float(hp.data_max), float(hp.data_min)
    elif hp.get("diffusion_log_path"):
        mx = float(np.load(os.path.join(hp.diffusion_log_path, "data_max.npy")))
        mn = float(np.load(os.path.join(hp.diffusion_log_path, "data_min.npy")))
    else:
        mx, mn = float(raw.max()), float(raw.min())
    if mx <= mn:
        raise ValueError(f"degenerate latent scale: data_max={mx} <= data_min={mn}")
    normed = ((raw - mn) / (mx - mn) * 2 - 1)[:, None]
    labels = np.load(hp.label_path).astype(np.int32)
    if len(labels) != len(normed):
        raise ValueError(f"{len(labels)} labels for {len(normed)} samples")
    return normed, labels


def labeled_batches(normed: np.ndarray, labels: np.ndarray, batch_size: int):
    """Batches drawn with replacement, the JAX CLI's ``default_rng(42)``."""
    rng = np.random.default_rng(SEED)
    while True:
        idx = rng.integers(0, len(normed), size=batch_size)
        yield normed[idx], labels[idx]


def main(argv=None) -> ClassifierTrainLoop | None:
    """Train the recipe; returns the finished loop (None on a rank outside
    the mesh)."""
    argv = argv if argv is not None else sys.argv[1:]
    hp = cfgmod.basic_input(argv[0])
    device = pmesh.initialize_distributed(hp.get("device"))
    n = pmesh.process_count()
    while n > 1 and hp.batch_size % n:
        n -= 1
    mesh = pmesh.get_mesh(n) if n > 1 else None
    if pmesh.process_index() >= n:
        print(f"rank {pmesh.process_index()}: outside the {n}-rank mesh, not training")
        return None

    log_dir = hp.get("log_path") or "./classifier_logs"
    tlog.configure(log_dir, ["stdout", "log", "csv"])
    normed, labels = load_labeled_data(hp)
    model = create_classifier(
        image_size=hp.image_size,
        classifier_width=hp.get("classifier_width", 128),
        classifier_depth=hp.get("classifier_depth", 2),
        classifier_attention_resolutions=hp.get("classifier_attention_resolutions",
                                                "32,16,8"),
        out_channels=hp.get("out_channels", 2),
        dims=hp.get("dims", 2),
    ).reset_parameters(torch.Generator().manual_seed(SEED))
    diffusion = create_gaussian_diffusion(steps=hp.get("steps", 1000),
                                          noise_schedule=hp.get("noise_schedule", "cosine"))
    loop = ClassifierTrainLoop(
        model=model,
        diffusion=diffusion,
        data=labeled_batches(normed, labels, hp.batch_size),
        batch_size=hp.batch_size,
        lr=float(hp.lr),
        weight_decay=hp.get("weight_decay", 0.05),
        lr_anneal_steps=hp.get("lr_anneal_steps", 0),
        noised=hp.get("noised", True),
        log_interval=hp.get("log_interval", 10),
        save_interval=hp.get("save_interval", 10000),
        save_dir=log_dir,
        mesh=mesh,
        seed=SEED,
        keep_checkpoints=hp.get("keep_checkpoints", 0),
        device=device,
    )
    loop.run_loop()
    return loop


if __name__ == "__main__":
    main()
