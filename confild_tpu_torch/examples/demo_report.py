"""Quality report from a completed turbulence-demo run directory, on the
port.

The port of ``examples/demo_report.py``: it loads what ``demo_turbulence``
left in its run directory (the simulated fields, the CNF checkpoint, the
diffusion EMA checkpoint), regenerates an ensemble, recomputes the physics
gates with bootstrap 95% intervals over the ensemble's members, and scores
the velocity PDFs and the two-point correlation:

* ``demo_spectra.png``   -- 1-D energy spectra: simulation, CNF
                            reconstruction and generated (log-log), and the
                            per-mode relative error;
* ``demo_autocorr.png``  -- the spatially averaged temporal
                            autocorrelation, simulated against generated;
* ``demo_pdf.png``       -- the standardized u and v PDFs;
* ``demo_two_point.png`` -- the two-point correlation of u;
* ``demo_snapshots.png`` -- u-velocity snapshots, simulated and generated.

Run after the demo::

    python -m confild_tpu_torch.examples.demo_report --out demo_out_torch
    python -m confild_tpu_torch.examples.demo_report --device cpu --out DIR

It writes ``demo_report.json`` and, where matplotlib imports, the plots
into ``--out`` and nowhere else.  The flags are the JAX script's, plus
``--device`` (default ``cuda``: without a card it raises unless asked for
the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.analysis.metrics import (energy_spectrum_1d, integral_timescale,
                                                pdf_jensen_shannon, per_channel_rmae,
                                                spectra_relative_error,
                                                temporal_autocorrelation,
                                                two_point_correlation, velocity_pdf)
from confild_tpu_torch.core.packing import unit_interval_to_minmax
from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.examples.demo_common import (clock, device_entry, latent_scale,
                                                    load_demo_ema, read_run_config,
                                                    sliding_windows)
from confild_tpu_torch.train.cnf_trainer import CNFTrainer

REPO_ROOT = Path(__file__).resolve().parents[2]
BOOTSTRAP_RESAMPLES = 500


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="demo run directory (default demo_out_torch/ at the repo root)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card cuda raises")
    ap.add_argument("--n-gen", type=int, default=None)
    ap.add_argument("--sample-steps", type=int, default=None)
    return ap.parse_args(argv)


def load_fields(out_dir: str, c: dict) -> np.ndarray:
    """The run's simulated fields ``(n_traj, n_snap, grid, grid, 2)``,
    checked against the run's configuration."""
    n_traj, n_snap, grid = c["n_traj"], c["n_snap"], c["grid"]
    flat = np.load(os.path.join(out_dir, "fois.npy"))
    if flat.shape != (n_traj * n_snap, grid * grid, 2):
        raise SystemExit(f"{out_dir}/fois.npy has shape {flat.shape} but its demo_metrics.json "
                         f"describes n_traj={n_traj} n_snap={n_snap} grid={grid} — the "
                         "metrics config does not belong to this run dir")
    return flat.reshape(n_traj, n_snap, grid, grid, 2)


def reconstruct(tr: CNFTrainer, n_eval: int) -> np.ndarray:
    """The CNF's decode of the first ``n_eval`` latent rows on the
    training mesh, ``(n_eval, N, 2)``."""
    return tr.infer(tr.train_coord, tr.state.latents[:n_eval].detach()).cpu().numpy()


@torch.no_grad()
def regenerate(unet, diffusion, n_gen: int, window: int, latent: int, device,
               draws=None) -> np.ndarray:
    """``n_gen`` latent images ``(n_gen, window, latent)`` in the unit
    interval, by batches of up to 64 (batch ``b`` from a generator seeded
    ``100 + b``); ``draws(b)`` returns a batch's ``(noise, step_noise)``
    instead, as ``p_sample_loop`` takes them."""
    sample_bs = min(64, max(n_gen, 1))
    batches = []
    for b in range(max(-(-n_gen // sample_bs), 1)):
        noise, step_noise = draws(b) if draws is not None else (None, None)
        img = diffusion.p_sample_loop(unet, (sample_bs, 1, window, latent), noise=noise,
                                      generator=torch.Generator(device).manual_seed(100 + b),
                                      step_noise=step_noise)
        batches.append(img[:, 0].float().cpu().numpy())
    return np.concatenate(batches)[:n_gen]


def report_metrics(fields: np.ndarray, real_wins: np.ndarray, gen_grid: np.ndarray,
                   recon_grid: np.ndarray, real_eval: np.ndarray) -> dict:
    """The report's physics numbers (the demo's definitions): the
    generated ensemble's spectra error over both velocity channels, the
    reconstruction's, the integral timescales (the truth over its windows),
    bootstrap 95% intervals over members of the spectra error and the
    timescale ratio (``BOOTSTRAP_RESAMPLES`` resamples from
    ``default_rng(0)``), the velocity PDFs' Jensen-Shannon divergence and
    the two-point correlation's relative L2 error."""
    n_gen, grid = gen_grid.shape[0], fields.shape[2]
    spec_err = spectra_relative_error(
        np.concatenate([gen_grid[..., 0], gen_grid[..., 1]]).reshape(-1, grid),
        np.concatenate([fields[..., 0], fields[..., 1]]).reshape(-1, grid), axis=-1)
    recon_spec_err = spectra_relative_error(recon_grid[..., 0].reshape(-1, grid),
                                            real_eval[..., 0].reshape(-1, grid), axis=-1)
    tau_real = float(np.mean([integral_timescale(real_wins[i, ..., 0], 1.0)
                              for i in range(real_wins.shape[0])]))
    per_member_tau = np.array([integral_timescale(gen_grid[i, ..., 0], 1.0)
                               for i in range(n_gen)])
    tau_gen = float(per_member_tau.mean())
    # the ensemble spectrum is the members' mean (equal row counts), so
    # resampling members bootstraps the gate metric itself
    member_spec = np.stack([
        energy_spectrum_1d(np.concatenate([gen_grid[s, ..., 0],
                                           gen_grid[s, ..., 1]]).reshape(-1, grid))[1]
        for s in range(n_gen)])
    _, e_real = energy_spectrum_1d(np.concatenate([fields[..., 0],
                                                   fields[..., 1]]).reshape(-1, grid))
    rng = np.random.default_rng(0)
    boot_spec, boot_tau = [], []
    for _ in range(BOOTSTRAP_RESAMPLES):
        idx = rng.integers(0, n_gen, n_gen)
        boot_spec.append(float(np.linalg.norm(member_spec[idx].mean(axis=0) - e_real)
                               / np.linalg.norm(e_real)))
        boot_tau.append(float(per_member_tau[idx].mean()) / tau_real)
    r_real = two_point_correlation(fields[..., 0].reshape(-1, grid))
    r_gen = two_point_correlation(gen_grid[..., 0].reshape(-1, grid))
    return {
        "cnf_recon_spectra_error": float(recon_spec_err),
        "spectra_relative_error": float(spec_err),
        "integral_timescale_real": tau_real,
        "integral_timescale_generated": tau_gen,
        "timescale_ratio": tau_gen / tau_real,
        "spectra_error_ci95": [float(np.percentile(boot_spec, q)) for q in (2.5, 97.5)],
        "timescale_ratio_ci95": [float(np.percentile(boot_tau, q)) for q in (2.5, 97.5)],
        "velocity_pdf_js_divergence": {
            "u": pdf_jensen_shannon(gen_grid[..., 0], fields[..., 0]),
            "v": pdf_jensen_shannon(gen_grid[..., 1], fields[..., 1])},
        "two_point_correlation_error": float(np.linalg.norm(r_gen - r_real)
                                             / np.linalg.norm(r_real)),
        "bootstrap_resamples": BOOTSTRAP_RESAMPLES,
    }


def plot_report(out_dir: str, fields, real_wins, gen_grid, recon_grid, m: dict) -> None:
    """The five figures of the report, from the fields and its numbers."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plots")
        return
    grid, n_snap = fields.shape[2], fields.shape[1]
    n_gen, window = gen_grid.shape[0], gen_grid.shape[1]
    k, e_real = energy_spectrum_1d(fields[..., 0].reshape(-1, grid))
    _, e_gen = energy_spectrum_1d(gen_grid[..., 0].reshape(-1, grid))
    _, e_rec = energy_spectrum_1d(recon_grid[..., 0].reshape(-1, grid))
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))
    ax1.loglog(k[1:], e_real[1:], "k-", lw=2, label="simulation")
    ax1.loglog(k[1:], e_rec[1:], "g--", lw=1.5, label="CNF reconstruction")
    ax1.loglog(k[1:], e_gen[1:], "r-", lw=1.5, label="generated")
    ax1.set_xlabel("wavenumber k")
    ax1.set_ylabel("E(k)")
    ax1.set_title(f"u-velocity energy spectra (rel. L2 err {m['spectra_relative_error']:.3f})")
    ax1.grid(True, which="both", alpha=0.3)
    ax1.legend()
    # the resolved band: the simulation's 2/3 dealiasing zeroes the modes
    # beyond its cutoff
    resolved = e_real[1:] > 1e-8 * e_real.max()
    rel = (np.abs(e_gen[1:] - e_real[1:]) / np.abs(e_real[1:]))[resolved]
    ax2.loglog(k[1:][resolved], rel, "r-")
    ax2.set_xlabel("wavenumber k")
    ax2.set_ylabel("|E_gen - E_real| / E_real")
    ax2.set_title("per-mode relative spectrum error (resolved band)")
    ax2.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "demo_spectra.png"), dpi=120)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(7, 4))
    for i in range(min(real_wins.shape[0], 8)):
        ax.plot(temporal_autocorrelation(real_wins[i, ..., 0]), "k-", alpha=0.3,
                label="simulation" if i == 0 else None)
    for i in range(min(n_gen, 8)):
        ax.plot(temporal_autocorrelation(gen_grid[i, ..., 0]), "r-", alpha=0.3,
                label="generated" if i == 0 else None)
    ax.axhline(0.05, color="b", ls="--", lw=0.8, label="cutoff 0.05")
    ax.set_xlabel("time lag (snapshots)")
    ax.set_ylabel("autocorrelation")
    ax.set_title(f"temporal autocorrelation (timescale real {m['integral_timescale_real']:.1f}"
                 f" / gen {m['integral_timescale_generated']:.1f})")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "demo_autocorr.png"), dpi=120)
    plt.close(fig)

    fig, axes = plt.subplots(1, 2, figsize=(10, 3.8))
    for j, (ax, ch) in enumerate(zip(axes, ("u", "v"))):
        cr, pr = velocity_pdf(fields[..., j])
        cg, pg = velocity_pdf(gen_grid[..., j])
        ax.semilogy(cr, np.maximum(pr, 1e-8), "k-", lw=2, label="simulation")
        ax.semilogy(cg, np.maximum(pg, 1e-8), "r--", lw=1.5, label="generated")
        ax.set_xlabel(f"standardized {ch}")
        ax.set_ylabel("PDF")
        ax.set_title(f"{ch}-velocity PDF (JS divergence "
                     f"{m['velocity_pdf_js_divergence'][ch]:.4f})")
        ax.grid(alpha=0.3)
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "demo_pdf.png"), dpi=120)
    plt.close(fig)

    r_real = two_point_correlation(fields[..., 0].reshape(-1, grid))
    r_gen = two_point_correlation(gen_grid[..., 0].reshape(-1, grid))
    half = grid // 2 + 1
    fig, ax = plt.subplots(figsize=(6.5, 4))
    ax.plot(np.arange(half), r_real[:half], "k-", lw=2, label="simulation")
    ax.plot(np.arange(half), r_gen[:half], "r--", lw=1.5, label="generated")
    ax.set_xlabel("separation r (grid points)")
    ax.set_ylabel("R_uu(r)")
    ax.set_title(f"two-point correlation (rel. L2 err {m['two_point_correlation_error']:.4f})")
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "demo_two_point.png"), dpi=120)
    plt.close(fig)

    n_show = min(4, fields.shape[0], n_gen)
    fig, axes = plt.subplots(2, n_show, figsize=(3 * n_show, 6), squeeze=False)
    vmax = np.abs(fields[..., 0]).max()
    for j in range(n_show):
        axes[0, j].imshow(fields[j, n_snap // 2, :, :, 0], cmap="RdBu_r", vmin=-vmax,
                          vmax=vmax)
        axes[0, j].set_title(f"simulated #{j}")
        axes[1, j].imshow(gen_grid[j, window // 2, :, :, 0], cmap="RdBu_r", vmin=-vmax,
                          vmax=vmax)
        axes[1, j].set_title(f"generated #{j}")
    for ax in axes.flat:
        ax.axis("off")
    fig.suptitle("u-velocity snapshots (mid-trajectory)")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "demo_snapshots.png"), dpi=120)
    plt.close(fig)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    out_dir = os.path.abspath(args.out or os.path.join(REPO_ROOT, "demo_out_torch"))
    stage_s = {}
    t0 = clock(device)
    c = read_run_config(out_dir)
    n_traj, n_snap, grid, latent = c["n_traj"], c["n_snap"], c["grid"], c["latent"]
    # a run trained on sliding windows generates windows; the truth-side
    # timescale windows the simulated trajectories alike
    window = c.get("window") or n_snap
    n_gen = args.n_gen or c.get("n_gen", 64)
    sample_steps = args.sample_steps or c.get("sample_steps", 500)
    fields = load_fields(out_dir, c)
    real_wins = (fields if window == n_snap
                 else sliding_windows(fields, window, c.get("window_stride", 4)))

    print("[1/4] CNF reconstruction ...")
    tr = CNFTrainer(cfgmod.basic_input(os.path.join(out_dir, "cnf.yml")), device=device)
    tr.load(-1)
    mx, mn = latent_scale(out_dir, tr.state.latents.detach().cpu().numpy())
    n_eval = min(2 * n_snap, n_traj * n_snap)
    recon = reconstruct(tr, n_eval)
    flat_eval = fields.reshape(n_traj * n_snap, grid * grid, 2)[:n_eval]
    stage_s["reconstruct"] = clock(device) - t0

    print(f"[2/4] regenerating {n_gen} samples ({sample_steps} steps) ...")
    unet = load_demo_ema(out_dir, window, latent, device)
    diffusion = create_gaussian_diffusion(steps=1000, noise_schedule="cosine",
                                          timestep_respacing=str(sample_steps))
    t = clock(device)
    gen = regenerate(unet, diffusion, n_gen, window, latent, device)
    stage_s["sample"] = clock(device) - t
    n_batches = max(-(-n_gen // min(64, max(n_gen, 1))), 1)
    t = clock(device)
    gen_lat = unit_interval_to_minmax(gen, mx, mn)
    gen_grid = np.stack([tr.infer(tr.train_coord, x).cpu().numpy()
                         for x in gen_lat]).reshape(n_gen, window, grid, grid, 2)
    stage_s["decode"] = clock(device) - t

    print("[3/4] metrics ...")
    t = clock(device)
    recon_grid = recon.reshape(n_eval, grid, grid, 2)
    m = report_metrics(fields, real_wins, gen_grid, recon_grid,
                       flat_eval.reshape(n_eval, grid, grid, 2))
    stage_s["metrics"] = clock(device) - t
    print("[4/4] plots ...")
    plot_report(out_dir, fields, real_wins, gen_grid, recon_grid, m)

    report = {
        "run_dir": os.path.relpath(out_dir, REPO_ROOT),
        "cnf_rmae": [float(x) for x in per_channel_rmae(recon, flat_eval)],
        **m,
        "n_gen": n_gen,
        "sample_steps": sample_steps,
        # the sampling wall over its batches' steps
        "device": device_entry(device, stage_s=stage_s,
                               sample_step_ms=stage_s["sample"] * 1e3
                               / (diffusion.num_timesteps * n_batches)),
    }
    with open(os.path.join(out_dir, "demo_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
