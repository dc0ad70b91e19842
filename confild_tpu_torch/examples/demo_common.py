"""Shared model construction for the port's turbulence demo, its own copy
of ``examples/demo_common.py``.

The stage-2 U-Net must be built identically by whatever trains it and
whatever loads its checkpoints (the demo itself, ``demo_conditional`` and
``demo_report``), or the checkpoints fail to load (or, worse,
load into another structure): ``attention_resolutions`` entries are divided
into the image size to obtain downsample factors, so the entry is derived
from the image size, keeping attention at the deepest levels the channel
mult reaches for every latent width.  The construction arguments are
persisted as ``unet.json`` next to the diffusion checkpoints.
"""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np
import torch

from confild_tpu_torch.device import synchronize
from confild_tpu_torch.io.convert import load_unet_state_dict
from confild_tpu_torch.models import unet as tunet


def sliding_windows(per_traj: np.ndarray, window: int, stride: int) -> np.ndarray:
    """(n_traj, n_snap, ...) -> (n_traj * n_win, window, ...) sliding
    temporal windows, the reference's diffusion data prep (its case recipes
    train on pre-windowed latent segments).  ``window == n_snap`` is the
    identity (one window per trajectory)."""
    n_snap = per_traj.shape[1]
    if window > n_snap or (n_snap - window) % stride:
        raise ValueError(f"window {window} / stride {stride} do not tile "
                         f"{n_snap} snapshots")
    starts = range(0, n_snap - window + 1, stride)
    return np.stack([per_traj[i, s:s + window]
                     for i in range(per_traj.shape[0]) for s in starts])


def build_demo_unet(n_snap: int, latent: int, num_channels: int = 64,
                    channel_mult: str = "1,2,2", num_head_channels: int = 16):
    """ADM U-Net over (1, n_snap, latent) latent images with a bf16 torso.
    Three levels or fewer: attention at downsample factor 4 only; deeper
    mults: attention at the two deepest levels, capped at factor 16 (a
    64-row window survives at most that before the time axis
    degenerates)."""
    img = max(n_snap, latent)
    n_levels = len(str(channel_mult).split(","))
    if n_levels <= 3:
        attn = f"{img // 4}"
    else:
        max_ds = min(2 ** (n_levels - 1), 16)
        attn = f"{img // max_ds},{img // (max_ds // 2)}"
    return tunet.create_model(
        image_size=img, num_channels=num_channels, num_res_blocks=2,
        channel_mult=channel_mult, attention_resolutions=attn,
        num_heads=4, num_head_channels=num_head_channels, use_bf16=True)


def save_demo_unet_config(dckpt_dir: str, n_snap: int, latent: int, **overrides) -> dict:
    """Persist the demo U-Net's construction arguments as ``unet.json`` in
    the checkpoint directory.  On a directory that already holds one (a
    resume), the arguments must match it; a directory with model
    checkpoints but no ``unet.json`` is refused."""
    cfg = {"n_snap": n_snap, "latent": latent, **overrides}
    os.makedirs(dckpt_dir, exist_ok=True)
    path = os.path.join(dckpt_dir, "unet.json")
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        if prev != cfg:
            raise ValueError(
                f"resume mismatch: {path} holds {prev} but this run was "
                f"configured for {cfg} — rerun with matching "
                "--unet-channels/--unet-mult or use a fresh run dir")
        return cfg
    if glob.glob(os.path.join(dckpt_dir, "model*.pt")) or \
            glob.glob(os.path.join(dckpt_dir, "model*.ckpt")):
        raise ValueError(
            f"{dckpt_dir} holds model checkpoints but no unet.json — "
            "a run dir without its config cannot be safely re-stamped; "
            "use a fresh run dir")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg


def load_demo_unet(dckpt_dir: str, n_snap: int, latent: int):
    """Rebuild the demo U-Net from the directory's ``unet.json``; without
    one, the default construction."""
    path = os.path.join(dckpt_dir, "unet.json")
    if os.path.exists(path):
        with open(path) as f:
            cfg = json.load(f)
        if cfg.get("n_snap", n_snap) != n_snap or cfg.get("latent", latent) != latent:
            raise ValueError(f"unet.json {cfg} does not match the run's "
                             f"latent-image shape ({n_snap}, {latent})")
        kw = {k: v for k, v in cfg.items() if k not in ("n_snap", "latent")}
        return build_demo_unet(n_snap, latent, **kw)
    return build_demo_unet(n_snap, latent)


def read_run_config(out_dir: str) -> dict:
    """The ``config`` block of a demo run directory's ``demo_metrics.json``.
    Only the run directory's own file is read: another run's metrics would
    describe another configuration."""
    path = os.path.join(out_dir, "demo_metrics.json")
    if not os.path.exists(path):
        raise SystemExit(f"{path} missing — this run dir's pipeline has not completed "
                         "(rerun demo_turbulence for this out dir)")
    with open(path) as f:
        return json.load(f)["config"]


def latent_scale(out_dir: str, latents: np.ndarray) -> tuple[float, float]:
    """The latent-image scale ``(max, min)`` the diffusion stage persisted in
    ``dckpt/`` (sigma-based under ``--scale-sigmas``), else the latent
    table's own min-max."""
    try:
        return (float(np.load(os.path.join(out_dir, "dckpt", "data_max.npy"))),
                float(np.load(os.path.join(out_dir, "dckpt", "data_min.npy"))))
    except FileNotFoundError:
        return float(latents.max()), float(latents.min())


def load_demo_ema(out_dir: str, n_snap: int, latent: int, device):
    """The demo U-Net of ``unet.json`` carrying the newest EMA checkpoint
    of ``dckpt/`` (the port's ``.pt`` or the JAX package's ``.ckpt``), on
    ``device`` for sampling: eval mode, no parameter gradients, the bf16
    torso pre-cast."""
    dckpt = os.path.join(out_dir, "dckpt")
    emas = sorted(glob.glob(os.path.join(dckpt, "ema_*.pt"))
                  + glob.glob(os.path.join(dckpt, "ema_*.ckpt")))
    if not emas:
        raise FileNotFoundError(f"no EMA checkpoint under {dckpt} — stage 2 (diffusion "
                                "training) has not completed")
    model = load_demo_unet(dckpt, n_snap, latent)
    model.load_state_dict(load_unet_state_dict(emas[-1], model))
    return model.to(device).eval().requires_grad_(False).cast_torso_params()


def clock(device) -> float:
    """The host clock after the card's queued work is done."""
    synchronize(device)
    return time.perf_counter()


def device_entry(device, **timing) -> dict:
    """What ran the script, for its report: the card's name and count (or
    the CPU), and the timings measured there."""
    if device.type == "cuda":
        kind, count = torch.cuda.get_device_name(device), torch.cuda.device_count()
    else:
        kind, count = "cpu", 1
    return {"kind": kind, "count": count, "timing": timing}
