"""End-to-end CoNFiLD demo on simulated 2-D turbulence, on the port.

The port of ``examples/demo_turbulence.py``:

1. simulate 2-D turbulence (pseudo-spectral vorticity-form Navier-Stokes,
   2/3-dealiased, RK2; numpy on the host): trajectories of (u, v)
   snapshots on a periodic grid;
2. stage 1: fit the CNF by auto-decoding (``CNFTrainer``; on the card its
   batch steps run the SIREN forward and training-backward kernels);
3. stage 2: pack the latent table into latent images and train the bf16
   ADM U-Net (``TrainLoop`` over a device-resident image set, several steps
   a call);
4. sample latent images (``p_sample_loop``, respaced) and decode them
   through the CNF (``CNFTrainer.infer``);
5. physics gates: the CNF's reconstruction rMAE, the energy-spectrum
   relative error and the integral-timescale ratio of generated against
   simulated fields (``analysis.metrics``).

Run::

    python -m confild_tpu_torch.examples.demo_turbulence --fast
    python -m confild_tpu_torch.examples.demo_turbulence --fast --device cpu

It writes under ``--out`` (default ``demo_out_torch/`` at the repo root),
``demo_metrics.json`` included, and nowhere else.  The flags are the JAX
demo's, plus ``--device`` (default ``cuda``: without a card it raises
unless asked for the CPU).
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.analysis.metrics import (integral_timescale, per_channel_rmae,
                                                spectra_relative_error)
from confild_tpu_torch.core.packing import minmax_to_unit_interval, unit_interval_to_minmax
from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.examples.demo_common import (build_demo_unet, clock,
                                                    save_demo_unet_config, sliding_windows)
from confild_tpu_torch.io import checkpoint as ckpt_io
from confild_tpu_torch.train.cnf_trainer import CNFTrainer
from confild_tpu_torch.train.diffusion_trainer import TrainLoop
from confild_tpu_torch.utils import logger as tlog

REPO_ROOT = Path(__file__).resolve().parents[2]

# ---------------------------------------------------------------------------
# 2-D turbulence (pseudo-spectral NS, vorticity form)
# ---------------------------------------------------------------------------

# ``decaying``: freely decaying; ``forced``: Kolmogorov forcing and Ekman
# drag, statistically stationary (held-out trajectories share the training
# attractor); ``forced_soft``: the same at 4x viscosity, a halved high-k
# tail
FLOW_PRESETS = {
    "decaying": dict(forcing=0.0, drag=0.0, k_f=0,
                     steps_per_snap=4, burn_in=40),
    "forced": dict(forcing=1.2, drag=0.2, k_f=6,
                   steps_per_snap=12, burn_in=3000),
    "forced_soft": dict(forcing=1.2, drag=0.2, k_f=6, nu=4e-3,
                        steps_per_snap=12, burn_in=3000),
}


def simulate_turbulence(n: int = 64, n_snapshots: int = 64, n_traj: int = 16,
                        nu: float = 1e-3, dt: float = 5e-3,
                        steps_per_snap: int = 4, seed: int = 0,
                        forcing: float = 0.0, drag: float = 0.0,
                        k_f: int = 6, burn_in: int = 40) -> np.ndarray:
    """Pseudo-spectral 2-D Navier-Stokes (vorticity form, 2/3-dealiased,
    RK2).  ``forcing > 0`` adds Kolmogorov forcing ``f_u = A sin(k_f y)``
    (as the vorticity source ``-A k_f cos(k_f y)``) and linear Ekman drag
    ``-drag * w``.  Returns velocity fields (n_traj, n_snapshots, n, n, 2)."""
    rng = np.random.default_rng(seed)
    k = np.fft.fftfreq(n, 1.0 / n)
    kx, ky = np.meshgrid(k, k, indexing="ij")
    k2 = kx ** 2 + ky ** 2
    k2_inv = np.where(k2 == 0, 1.0, k2)
    dealias = (np.abs(kx) < n / 3) & (np.abs(ky) < n / 3)
    f_hat = 0.0
    if forcing:
        y = np.linspace(0, 2 * np.pi, n, endpoint=False)
        _, Y = np.meshgrid(y, y, indexing="ij")
        f_hat = np.fft.fft2(-forcing * k_f * np.cos(k_f * Y))

    def velocity(w_hat):
        psi_hat = w_hat / k2_inv
        u = np.real(np.fft.ifft2(1j * ky * psi_hat))
        v = np.real(np.fft.ifft2(-1j * kx * psi_hat))
        return u, v

    def rhs(w_hat):
        u, v = velocity(w_hat)
        wx = np.real(np.fft.ifft2(1j * kx * w_hat))
        wy = np.real(np.fft.ifft2(1j * ky * w_hat))
        adv_hat = np.fft.fft2(u * wx + v * wy) * dealias
        return -adv_hat - (nu * k2 + drag) * w_hat + f_hat

    all_traj = []
    for _traj in range(n_traj):
        # random initial vorticity peaked around |k| ~ 4
        amp = np.exp(-((np.sqrt(k2) - 4.0) ** 2) / 4.0)
        phase = rng.uniform(0, 2 * np.pi, (n, n))
        w_hat = amp * np.exp(1j * phase) * n * n * 0.1
        w = np.real(np.fft.ifft2(w_hat))
        w_hat = np.fft.fft2(w / max(np.abs(w).max(), 1e-9) * 5.0)

        for _ in range(burn_in):
            k1 = rhs(w_hat)
            k2_ = rhs(w_hat + dt * k1)
            w_hat = w_hat + dt * 0.5 * (k1 + k2_)

        snaps = []
        for _ in range(n_snapshots):
            for _ in range(steps_per_snap):
                k1 = rhs(w_hat)
                k2_ = rhs(w_hat + dt * k1)
                w_hat = w_hat + dt * 0.5 * (k1 + k2_)
            u, v = velocity(w_hat)
            snaps.append(np.stack([u, v], axis=-1))
        all_traj.append(np.stack(snaps))
    return np.stack(all_traj).astype(np.float32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="tiny run for smoke testing")
    ap.add_argument("--out", default=None,
                    help="output directory (default demo_out_torch/ at the repo root)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card cuda raises")
    ap.add_argument("--cnf-epochs", type=int, default=None,
                    help="stage-1 epochs (a total horizon: a resumed run trains the rest)")
    ap.add_argument("--diff-steps", type=int, default=None,
                    help="stage-2 diffusion training steps (a total horizon)")
    ap.add_argument("--sample-steps", type=int, default=None,
                    help="respaced sampling steps of the generated windows (default 500, "
                         "10 under --fast)")
    ap.add_argument("--latent", type=int, default=None,
                    help="latent features per snapshot row (default 64, 32 under --fast)")
    ap.add_argument("--hidden", type=int, default=128, help="SIREN hidden width")
    ap.add_argument("--nf-layers", type=int, default=4, help="SIREN hidden layers")
    ap.add_argument("--nf-w0", type=float, default=None, help="SIREN omega_0 (default 30)")
    ap.add_argument("--flow", choices=sorted(FLOW_PRESETS), default="decaying")
    ap.add_argument("--n-traj", type=int, default=None,
                    help="simulated trajectories (default 64, 4 under --fast)")
    ap.add_argument("--n-snap", type=int, default=None,
                    help="snapshots per trajectory (default 64, 16 under --fast)")
    ap.add_argument("--window", type=int, default=0,
                    help="train the prior on sliding windows of this many snapshots "
                         "(0: whole trajectories)")
    ap.add_argument("--window-stride", type=int, default=4)
    ap.add_argument("--diff-batch", type=int, default=None,
                    help="stage-2 batch size (default min(16, n_images); 8 under --fast)")
    ap.add_argument("--scale-sigmas", type=float, default=0.0,
                    help="scale latent images by center +- K*std instead of min-max "
                         "(0: the reference's min-max)")
    ap.add_argument("--decoder-from", default=None,
                    help="bootstrap the decoder and normalizers from a stage-1 run dir "
                         "(siren_only load, fresh optimizer states)")
    ap.add_argument("--fix-nf-epochs", type=int, default=0,
                    help="latent-only (frozen decoder) epochs before the joint ones")
    ap.add_argument("--latent-lr-end", type=float, default=None)
    ap.add_argument("--nf-lr", type=float, default=1e-4)
    ap.add_argument("--nf-lr-end", type=float, default=None)
    ap.add_argument("--latent-noise-std", type=float, default=0.0)
    ap.add_argument("--latent-l2", type=float, default=0.0)
    ap.add_argument("--latent-init", default=None, help=".npy latent-table init")
    ap.add_argument("--nf-cadence", choices=["epoch", "batch"], default="epoch")
    ap.add_argument("--cnf-run-dir", default="cnf_run")
    ap.add_argument("--unet-channels", type=int, default=64)
    ap.add_argument("--unet-mult", default="1,2,2")
    return ap.parse_args(argv)


def _cnf_batch_step_ms(save_path: str, epochs: int, n_batches: int):
    """The last epoch's wall time over its batch steps, from the trainer's
    log of this run (``wait_train_chunk``: one epoch, synchronized by the
    loss read at its end), or None when no epoch ran."""
    path = os.path.join(save_path, "progress.csv")
    if epochs <= 0 or not os.path.exists(path):
        return None
    with open(path) as f:
        chunks = [float(r["wait_train_chunk"]) for r in csv.DictReader(f)
                  if r.get("wait_train_chunk")]
    return chunks[-1] * 1e3 / n_batches if chunks else None


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    out_dir = os.path.abspath(args.out or os.path.join(REPO_ROOT, "demo_out_torch"))
    os.makedirs(out_dir, exist_ok=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    n_traj, n_snap, grid = (4, 16, 32) if args.fast else (64, 64, 64)
    if args.n_traj is not None:
        n_traj = args.n_traj
    if args.n_snap is not None:
        n_snap = args.n_snap
    window = args.window or n_snap
    if window > n_snap or (n_snap - window) % args.window_stride:
        raise SystemExit(f"--window {window} / stride {args.window_stride} "
                         f"do not tile {n_snap} snapshots")
    latent = args.latent or (32 if args.fast else 64)
    cnf_epochs = (args.cnf_epochs if args.cnf_epochs is not None
                  else (40 if args.fast else 2500))
    diff_steps = (args.diff_steps if args.diff_steps is not None
                  else (30 if args.fast else 30000))
    sample_steps = args.sample_steps or (10 if args.fast else 500)
    n_gen = 8 if args.fast else 64
    stage_s = {}

    t0 = clock(device)
    flow_kw = FLOW_PRESETS[args.flow]
    print(f"[1/5] simulating {n_traj}x{n_snap} snapshots of {args.flow} "
          f"2-D turbulence on {grid}^2 ...")
    foi_path = os.path.join(out_dir, "fois.npy")
    meta_path = os.path.join(out_dir, "sim_meta.json")
    expected = (n_traj * n_snap, grid * grid, 2)
    if os.path.exists(foi_path):
        # the simulation is deterministic (seed 0): an existing dataset of
        # the right shape and flow is this data
        prev_flow = "decaying"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                prev_flow = json.load(f).get("flow", "decaying")
        flat = np.load(foi_path)
        if flat.shape != expected or prev_flow != args.flow:
            raise SystemExit(f"{foi_path} is {prev_flow} {flat.shape}, expected "
                             f"{args.flow} {expected} — remove it to re-simulate")
        fields = flat.reshape(n_traj, n_snap, grid, grid, 2)
        print("      loaded existing dataset")
    else:
        fields = simulate_turbulence(grid, n_snap, n_traj, **flow_kw)
        flat = fields.reshape(n_traj * n_snap, grid * grid, 2)
        np.save(foi_path, flat)
        with open(meta_path, "w") as f:
            json.dump({"flow": args.flow, "n_traj": n_traj, "n_snap": n_snap,
                       "grid": grid, **flow_kw}, f)
    coords = np.stack(np.meshgrid(np.linspace(0, 1, grid), np.linspace(0, 1, grid),
                                  indexing="ij"), -1).reshape(-1, 2)
    np.save(os.path.join(out_dir, "coords.npy"), coords.astype(np.float32))
    stage_s["simulate"] = time.perf_counter() - t0
    print(f"      data {fields.shape}, {stage_s['simulate']:.1f}s")

    print("[2/5] stage 1: CNF auto-decoding fit ...")
    t1 = clock(device)
    lr_block = {"nf": args.nf_lr, "latents": 1e-2}
    total_epochs = args.fix_nf_epochs + cnf_epochs
    if args.latent_lr_end is not None:
        lr_block["latents_end"] = args.latent_lr_end
        lr_block["decay_epochs"] = total_epochs
    if args.nf_lr_end is not None:
        lr_block["nf_end"] = args.nf_lr_end
        lr_block["decay_epochs"] = total_epochs
    recipe = {
        "data_path": os.path.join(out_dir, "fois.npy"),
        "coor_path": os.path.join(out_dir, "coords.npy"),
        "save_path": os.path.join(out_dir, args.cnf_run_dir),
        "lumped_latent": True,
        "normalizer": {"method": "-11", "dim": 0},
        "batch_size": 128 if not args.fast else 64,
        "test_batch_size": 64, "multiGPU": 1,
        "readin_data_shape": "t N c", "batch_shape": "t N c",
        "hidden_size": latent, "epochs": cnf_epochs, "loss_fn": "MSELoss",
        "test_criteria": "rMAE",
        # the eval and checkpoint cadence from the total epochs of this run
        "save_every": max(min(total_epochs // 8, 250), 1),
        "dims": 2,
        "NF": {"name": "SIRENAutodecoder_film",
               "num_hidden_layers": args.nf_layers,
               "out_features": 2, "hidden_features": args.hidden,
               **({"omega_0": args.nf_w0} if args.nf_w0 else {})},
        "lr": lr_block,
        "nf_optim_cadence": args.nf_cadence,
        "device": device.type,
        **({"latent_noise_std": args.latent_noise_std} if args.latent_noise_std else {}),
        **({"latent_l2": args.latent_l2} if args.latent_l2 else {}),
        **({"latent_init": args.latent_init} if args.latent_init else {}),
    }
    cnf_yml = os.path.join(out_dir, "cnf.yml")
    with open(cnf_yml, "w") as f:
        yaml.safe_dump(recipe, f)

    if args.decoder_from:
        # the donor run's normalizers (the decoder was trained against
        # them) and its newest decoder checkpoint
        os.makedirs(recipe["save_path"], exist_ok=True)
        for name in ("normalizer_params.ckpt", "normalizer_params.pt"):
            src = os.path.join(args.decoder_from, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(recipe["save_path"], name))
                break
        donors = [d for d in (ckpt_io.latest_checkpoint(args.decoder_from, pat)
                              for pat in ("checkpoint_*.pt", "checkpoint_*.ckpt")) if d]
        if not donors:
            raise SystemExit(f"--decoder-from {args.decoder_from}: no checkpoint found "
                             "(needs a completed stage-1 run directory)")
        donor = max(donors, key=lambda d: d[1])
        tgt = os.path.join(recipe["save_path"], os.path.basename(donor[0]))
        if not os.path.exists(tgt):
            shutil.copy(donor[0], tgt)
        hp = cfgmod.basic_input(cnf_yml)
        tr = CNFTrainer(hp)
        st = tr.load(-1, siren_only=True)
        # fresh optimizer states, as the JAX demo
        tr._new_state(st.latents.detach(), st.epoch)
    else:
        hp = cfgmod.basic_input(cnf_yml)
        tr = CNFTrainer(hp)
        tr.load(-1)
        # --cnf-epochs is a total horizon for plain runs: a resumed run
        # trains only the remaining epochs
        if tr.state is not None and not args.fix_nf_epochs:
            done = int(tr.state.epoch)
            if done:
                hp.epochs = max(cnf_epochs - done, 0)
                print(f"      resuming stage 1 at epoch {done}: "
                      f"{hp.epochs} of {cnf_epochs} remain")

    if args.fix_nf_epochs:
        # latent-only fit against the frozen decoder
        hp.epochs = args.fix_nf_epochs
        tr.train(fix_nf=True, log_formats=())
        oracle = tr.eval_rmae()
        print(f"      latent-only (frozen decoder) rMAE: {oracle}")
        hp.epochs = cnf_epochs
    joint_epochs = hp.epochs
    tr.train(log_formats=())
    cnf_batch_ms = _cnf_batch_step_ms(recipe["save_path"], joint_epochs,
                                      max(tr.N_samples // recipe["batch_size"], 1))

    n_eval = min(4 * n_snap, n_traj * n_snap)
    recon = tr.infer(tr.train_coord, tr.state.latents[:n_eval].detach()).cpu().numpy()
    cnf_rmae = per_channel_rmae(recon, flat[:n_eval])
    # the reconstruction's spectra error bounds what generated fields can
    # reach (decoder fidelity, independent of the diffusion fit)
    recon_spec_err = spectra_relative_error(
        recon.reshape(n_eval, grid, grid, 2)[..., 0].reshape(-1, grid),
        flat[:n_eval].reshape(n_eval, grid, grid, 2)[..., 0].reshape(-1, grid), axis=-1)
    stage_s["cnf"] = clock(device) - t1
    print(f"      CNF rMAE per channel: {cnf_rmae}, recon spectra err "
          f"{recon_spec_err:.4f} ({stage_s['cnf']:.1f}s)")

    print("[3/5] stage 2: diffusion training on latent images ...")
    t2 = clock(device)
    latents = tr.state.latents.detach().cpu().numpy()       # (T*traj, latent)
    imgs = latents.reshape(n_traj, n_snap, latent)
    if args.scale_sigmas:
        c, s = float(latents.mean()), float(latents.std())
        mx, mn = c + args.scale_sigmas * s, c - args.scale_sigmas * s
    else:
        mx, mn = float(latents.max()), float(latents.min())
    normed = minmax_to_unit_interval(imgs, mx, mn)
    print(f"      latent-image scale: [{mn:.3f}, {mx:.3f}] -> unit-interval "
          f"std {normed.std():.3f}")
    dckpt = os.path.join(out_dir, "dckpt")
    os.makedirs(dckpt, exist_ok=True)
    np.save(os.path.join(dckpt, "data_max.npy"), np.float32(mx))
    np.save(os.path.join(dckpt, "data_min.npy"), np.float32(mn))
    train = sliding_windows(normed, window, args.window_stride)[:, None]
    if window != n_snap:
        print(f"      {train.shape[0]} training images ({window}x{latent}) "
              f"from {n_traj} trajectories")
    unet_kw = {}
    if args.unet_channels != 64:
        unet_kw["num_channels"] = args.unet_channels
    if args.unet_mult != "1,2,2":
        unet_kw["channel_mult"] = args.unet_mult
    save_demo_unet_config(dckpt, window, latent, **unet_kw)
    model = build_demo_unet(window, latent, **unet_kw)
    model.reset_parameters(torch.Generator().manual_seed(42))
    diffusion = create_gaussian_diffusion(steps=1000, noise_schedule="cosine")
    diff_batch = args.diff_batch or min(16 if not args.fast else 8, train.shape[0])

    tlog.configure(os.path.join(out_dir, "dlogs"), ["csv"])
    # resume from the newest model checkpoint (lr_anneal_steps is a total
    # horizon, so a resumed loop finishes the remaining steps only)
    saved = sorted(glob.glob(os.path.join(dckpt, "model*.pt")), key=ckpt_io.parse_resume_step)
    resume_path = saved[-1] if saved and not args.fast else ""
    if resume_path:
        print(f"      resuming diffusion from {resume_path}")
    loop = TrainLoop(model=model, diffusion=diffusion, data=None,
                     device_data=train.astype(np.float32),
                     batch_size=diff_batch, lr=1e-4, ema_rate="0.999",
                     log_interval=200,
                     save_interval=10 ** 9 if args.fast else 2500,
                     lr_anneal_steps=diff_steps,
                     resume_checkpoint=resume_path,
                     steps_per_call=1 if args.fast else 25,
                     save_dir=dckpt, device=device)
    first_step = loop.step
    t_loop = clock(device)
    loop.run_loop()
    loop_s = clock(device) - t_loop
    steps_run = loop.step - first_step
    stage_s["diffusion"] = clock(device) - t2
    print(f"      {loop.step} steps done ({stage_s['diffusion']:.1f}s)")

    print("[4/5] sampling + decode ...")
    t3 = clock(device)
    respaced = create_gaussian_diffusion(steps=1000, noise_schedule="cosine",
                                         timestep_respacing=str(sample_steps))
    sampler = build_demo_unet(window, latent, **unet_kw)
    sampler.load_state_dict(loop.ema_state_dict(0))
    sampler = sampler.to(device).eval().cast_torso_params()
    sample_bs = min(32, max(n_gen, 1))
    gen_batches = []
    with torch.no_grad():
        for b in range(max(-(-n_gen // sample_bs), 1)):
            gen = respaced.p_sample_loop(sampler, (sample_bs, 1, window, latent),
                                         generator=torch.Generator(device).manual_seed(b))
            gen_batches.append(gen[:, 0].float().cpu().numpy())
    gen = np.concatenate(gen_batches)[:n_gen]                 # (n_gen, T, L)
    gen_lat = unit_interval_to_minmax(gen, mx, mn)
    stage_s["sample"] = clock(device) - t3
    t4 = time.perf_counter()
    gen_fields = np.stack([tr.infer(tr.train_coord, gen_lat[s]).cpu().numpy()
                           for s in range(gen_lat.shape[0])])   # (n_gen, T, n*n, 2)
    gen_grid = gen_fields.reshape(n_gen, window, grid, grid, 2)
    stage_s["decode"] = time.perf_counter() - t4
    print(f"      decoded {gen_grid.shape} ({stage_s['sample']:.1f}s sampling, "
          f"{stage_s['decode']:.1f}s decoding)")

    print("[5/5] physics metrics ...")
    t5 = time.perf_counter()
    # spectra over both velocity components, full ensembles on both sides
    spec_err = spectra_relative_error(
        np.concatenate([gen_grid[..., 0], gen_grid[..., 1]]).reshape(-1, grid),
        np.concatenate([fields[..., 0], fields[..., 1]]).reshape(-1, grid), axis=-1)
    # the integral timescale averaged over every trajectory (windowed like
    # the training data) and every generated sample
    real_wins = fields if window == n_snap else sliding_windows(fields, window,
                                                               args.window_stride)
    tau_real = float(np.mean([integral_timescale(real_wins[i, :, :, :, 0], 1.0)
                              for i in range(real_wins.shape[0])]))
    tau_gen = float(np.mean([integral_timescale(gen_grid[i, :, :, :, 0], 1.0)
                             for i in range(n_gen)]))
    stage_s["metrics"] = time.perf_counter() - t5

    metrics = {
        "run_dir": os.path.relpath(out_dir, REPO_ROOT),
        "cnf_rmae": [float(x) for x in cnf_rmae],
        "cnf_recon_spectra_error": float(recon_spec_err),
        "spectra_relative_error": float(spec_err),
        "integral_timescale_real": tau_real,
        "integral_timescale_generated": tau_gen,
        "timescale_ratio": tau_gen / tau_real,
        "wall_clock_s": round(time.perf_counter() - t0, 1),
        "timing": {
            "stage_s": stage_s,
            # the joint epochs' last epoch over its batch steps
            "cnf_batch_step_ms": cnf_batch_ms,
            # run_loop's wall over its steps (its final checkpoint included)
            "diffusion_step_ms": loop_s * 1e3 / steps_run if steps_run else None,
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None),
        },
        "config": {"n_traj": n_traj, "n_snap": n_snap, "grid": grid,
                   "latent": latent, "cnf_epochs": cnf_epochs,
                   "diff_steps": diff_steps, "sample_steps": sample_steps,
                   "n_gen": n_gen, "window": window,
                   "window_stride": args.window_stride,
                   "n_train_images": int(train.shape[0]),
                   "flow": args.flow, "backend": device.type},
    }
    path = os.path.join(out_dir, "demo_metrics.json")
    with open(path, "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))
    print(f"metrics -> {path}")
    return metrics


if __name__ == "__main__":
    main()
