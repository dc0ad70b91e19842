"""Zero-shot sparse-sensor reconstruction of held-out turbulence by DPS, on
the port.

The port of ``examples/demo_conditional.py`` (reference
``ConditionalDiffusionGeneration/inference_scripts/Case4/random_sensor/
inference_phy_random_sensor.ipynb`` cells 22-39): from a few random sensor
readings a frame, reconstruct the whole spatiotemporal field of
trajectories that neither the CNF nor the diffusion prior saw, by steering
the unconditional latent prior with the CNF's measurement misfit at every
reverse step (diffusion posterior sampling).

Protocol, as the JAX script's:

1. simulate ``--n-held`` trajectories from a seed disjoint from the
   training seed 0, and place ``--n-sensors`` random mesh points on each;
2. with ``--prior-check``: an oracle latent fit of each trajectory against
   the frozen decoder, and noise-and-denoise round trips of that latent
   image through the prior;
3. tune the guidance (method, scale) on trajectory 0 at the full step
   count, with a physics qualifier, then reconstruct every trajectory with
   ``--n-ens`` members;
4. the sensor-count sweep on trajectory 0 (``--sensor-sweep``), an
   in-distribution control (with ``--prior-check``) and an unconditional
   control;
5. pooled metrics over the trajectories other than 0, whose full-field
   truth chose the guidance.

Each stage is a function of this module.  An ensemble's members run as one
batch (the JAX script vmaps them): each member gets exactly its own
gradient, and the CNF operator routes by the whole batch's rows x points,
so the sweep's 1000 sensors (4 x 64 x 1000 pairs) decode through the SIREN
forward and dz kernels where the JAX script, seeing one member's rows,
decodes plain.

Run after ``demo_turbulence`` has written the run directory::

    python -m confild_tpu_torch.examples.demo_conditional --out demo_out_torch
    python -m confild_tpu_torch.examples.demo_conditional --device cpu --out DIR

It writes ``demo_conditional.json`` and, where matplotlib imports, the
``demo_cond_{sensors,fields,sweep}.png`` plots into ``--out`` and nowhere
else.  The flags are the JAX script's, plus ``--device`` (default ``cuda``:
without a card it raises unless asked for the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.analysis.metrics import (integral_timescale, per_channel_rmae,
                                                spectra_relative_error)
from confild_tpu_torch.core.normalize import Normalizer
from confild_tpu_torch.core.packing import minmax_to_unit_interval, unit_interval_to_minmax
from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.examples.demo_common import (clock, device_entry, latent_scale,
                                                    load_demo_ema, read_run_config)
from confild_tpu_torch.examples.demo_turbulence import FLOW_PRESETS, simulate_turbulence
from confild_tpu_torch.guidance import create_sampler, get_conditioning_method, get_noise
from confild_tpu_torch.guidance.operators import CNFDecodeOperator
from confild_tpu_torch.models.cnf import siren_film_apply
from confild_tpu_torch.train.cnf_trainer import CNFTrainer
from confild_tpu_torch.train.schedulers import cosine_decay_schedule

REPO_ROOT = Path(__file__).resolve().parents[2]
# the oracle fit: latent-only Adam over the trainer's cosine-decayed latent
# learning rate, enough steps to converge on the f3/f4 decoders
N_FIT = 4000
FIT_LR = 1e-2


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="demo run directory (default demo_out_torch/ at the repo root)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card cuda raises")
    ap.add_argument("--n-held", type=int, default=4,
                    help="held-out trajectories to reconstruct")
    ap.add_argument("--n-sensors", type=int, default=16,
                    help="random sensor points per trajectory")
    ap.add_argument("--n-ens", type=int, default=8, help="DPS samples per trajectory")
    ap.add_argument("--steps", type=int, default=1000, help="reverse steps for the final runs")
    ap.add_argument("--seed", type=int, default=777,
                    help="held-out simulation seed (training used 0)")
    ap.add_argument("--scales", default="0.1,0.3,1.0,3.0",
                    help="guidance scales swept on trajectory 0")
    ap.add_argument("--prior-check", action=argparse.BooleanOptionalAction, default=True,
                    help="prior-coverage diagnostic: oracle latent fit of each held-out "
                         "trajectory (frozen decoder) + noise-and-denoise round trips of "
                         "the oracle latent image through the unconditional prior")
    ap.add_argument("--sensor-sweep", default="1,10,100,1000",
                    help="sensor counts swept on trajectory 0 with the tuned guidance "
                         "(the reference notebook's 1,10,100,1000); empty disables")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Assets:
    """What the stages share: the run's CNF trainer (decoder, normalizers,
    latent table), the EMA U-Net, the latent-image scale, the shapes."""
    tr: CNFTrainer
    unet: torch.nn.Module
    mx: float
    mn: float
    grid: int
    n_snap: int
    latent: int
    flow: str
    device: torch.device

    @property
    def full_coords(self) -> np.ndarray:
        """The ``(grid^2, 2)`` mesh in ``[0, 1]^2``, ``ij`` order."""
        ax = np.linspace(0, 1, self.grid)
        return np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(
            np.float32)


def load_assets(out_dir: str, device) -> Assets:
    """The trained CNF (newest checkpoint, latents included), the newest
    EMA U-Net and the latent-image scale of a demo run directory."""
    c = read_run_config(out_dir)
    # the prior's image length: the sliding window when the run trained on
    # windows, else the whole trajectory
    n_snap = c.get("window") or c["n_snap"]
    tr = CNFTrainer(cfgmod.basic_input(os.path.join(out_dir, "cnf.yml")), infer_mode=True,
                    device=device)
    tr.load(-1)
    mx, mn = latent_scale(out_dir, tr.state.latents.detach().cpu().numpy())
    unet = load_demo_ema(out_dir, n_snap, c["latent"], device)
    return Assets(tr, unet, mx, mn, c["grid"], n_snap, c["latent"],
                  c.get("flow", "decaying"), device)


def place_sensors(held_flat: np.ndarray, n_sensors: int, seed: int):
    """``n_sensors`` random mesh points per trajectory, fixed over it, and
    the ``(n_held, T, S, 2)`` velocity traces there."""
    n_held, _, n_points, _ = held_flat.shape
    rng = np.random.default_rng(seed + 1)
    sensor_idx = np.stack([rng.choice(n_points, size=n_sensors, replace=False)
                           for _ in range(n_held)])
    measures = np.stack([held_flat[i, :, sensor_idx[i], :].transpose(1, 0, 2)
                         for i in range(n_held)])
    return sensor_idx, measures


def ynorm_sliced(y_normalizer: Normalizer, point_idx) -> tuple:
    """The demo's '-11' normalizer is fit with dim 0 over (t, N, c): its
    params are per mesh point, ``(1, N, c)``; decoding at a subset of the
    points takes the params of those points."""
    params = tuple(np.asarray(p) for p in y_normalizer.params)
    if point_idx is not None and params[0].ndim == 3:
        return tuple(p[:, point_idx, :] for p in params)
    return params


def fit_oracle(assets: Assets, y_target: np.ndarray, n_fit: int = N_FIT):
    """The latent rows minimizing the frozen decoder's misfit to
    ``y_target`` ``(T, N, 2)`` over the whole mesh: Adam on the latents
    alone, from zeros, at optax's ``cosine_decay_schedule(1e-2, n_fit,
    alpha=1e-2)``; the loss is the plain decode's mean squared error
    against the normalized target.  Returns the rows, the last step's
    loss and step ``n_fit // 2``'s (the plateau ratio of the two says
    whether the fit converged)."""
    tr, dev = assets.tr, assets.device
    coords = tr.in_normalizer.to(dev).normalize(torch.as_tensor(assets.full_coords, device=dev))
    target = tr.out_normalizer.to(dev).normalize(
        torch.as_tensor(y_target, dtype=torch.float32, device=dev))
    z = torch.zeros((y_target.shape[0], assets.latent), device=dev, requires_grad=True)
    opt = torch.optim.Adam([z], lr=FIT_LR)
    schedule = cosine_decay_schedule(FIT_LR, n_fit, alpha=1e-2)
    mid = max(n_fit // 2 - 1, 0)
    for step in range(n_fit):
        loss = torch.mean((siren_film_apply(tr.model, coords, z[:, None, :], tr.w0)
                           - target) ** 2)
        # the decoder takes no gradient: only the latents are differentiated
        (z.grad,) = torch.autograd.grad(loss, z)
        opt.param_groups[0]["lr"] = schedule(step)
        opt.step()
        if step == mid:
            loss_mid = loss.detach()
    return z.detach(), float(loss.detach()), float(loss_mid)


@torch.no_grad()
def roundtrip(assets: Assets, diffusion, x0: torch.Tensor, t_star: int,
              generator: torch.Generator | None = None, noise=None, step_noise=None):
    """``q_sample`` the latent image ``x0`` ``(B, 1, T, L)`` to the
    (respaced) step ``t_star``, then reverse-diffuse it to 0 through the
    unconditional prior.  ``noise`` and ``step_noise(i)`` replace the draws
    from ``generator``.  The JAX script runs every step and freezes those
    at or above ``t_star`` (one compiled scan for any ``t_star``); the loop
    here starts below it."""
    b = x0.shape[0]
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device)
    img = diffusion.q_sample(x0, torch.full((b,), t_star, dtype=torch.long), noise)
    for i in range(t_star - 1, -1, -1):
        img = diffusion.p_sample(assets.unet, img, torch.full((b,), i, dtype=torch.long),
                                 generator, None if step_noise is None else step_noise(i))["sample"]
    return img


def dps_method(assets: Assets, coords, yn_params, method: str = "ps", scale: float = 1.0,
               use_pallas: bool | None = None):
    """The conditioning method on the CNF operator that decodes at
    ``coords`` with the sliced y-normalizer params and the latent-image
    scale; ``use_pallas`` forces the operator's route (None: by rows x
    points)."""
    tr = assets.tr
    y_norm = tr.out_normalizer
    op = CNFDecodeOperator(model=tr.model, coords=coords, x_normalizer=tr.in_normalizer,
                           y_normalizer=Normalizer(yn_params, y_norm.method, y_norm.dim),
                           max_val=assets.mx, min_val=assets.mn, w0=tr.w0,
                           use_pallas=use_pallas, device=assets.device)
    return get_conditioning_method(method, op, get_noise("clean"), scale=scale)


def run_ensemble(assets: Assets, coords, yn_params, measurement, scale: float, steps: int,
                 n_ens: int, seed: int, method: str = "ps", x_start=None, noise_fn=None):
    """One guided DDPM trajectory (``steps`` respaced of 1000, cosine) for
    ``n_ens`` members as one batch, decoding at ``coords`` with the sliced
    y-normalizer params.  ``x_start`` and ``noise_fn`` (the sampler's)
    replace the draws from a generator seeded with ``seed``.  Returns the
    samples ``(n_ens, T, L)`` in the unit interval, each member's final
    misfit, and ms per guided step."""
    dev = assets.device
    sampler = create_sampler(sampler="ddpm", steps=1000, noise_schedule="cosine",
                             timestep_respacing=str(steps) if steps != 1000 else None)
    cond = dps_method(assets, coords, yn_params, method, scale)
    gen = torch.Generator(dev).manual_seed(seed)
    if x_start is None:
        x_start = torch.randn((n_ens, 1, assets.n_snap, assets.latent), generator=gen,
                              device=dev)
    y = torch.as_tensor(measurement, dtype=torch.float32, device=dev)
    t0 = clock(dev)
    samples, dists = sampler.p_sample_loop(assets.unet, x_start, y, cond, generator=gen,
                                           noise_fn=noise_fn, return_distances=True)
    step_ms = (clock(dev) - t0) * 1e3 / sampler.diffusion.num_timesteps
    return samples[:, 0].float().cpu().numpy(), dists[-1].cpu().numpy(), step_ms


def decode_fields(assets: Assets, samples: np.ndarray) -> np.ndarray:
    """Unit-interval latent images ``(E, T, L)`` -> ``(E, T, grid^2, 2)``
    fields on the full mesh (``CNFTrainer.infer``, the plain decode)."""
    lat = unit_interval_to_minmax(samples, assets.mx, assets.mn)
    return np.stack([assets.tr.infer(assets.full_coords, x).cpu().numpy() for x in lat])


def prior_coverage(assets: Assets, held_flat: np.ndarray, steps: int):
    """The prior-coverage diagnostic: an oracle fit of each trajectory, and
    its latent image noised to 1/4, 1/2 and 3/4 of the (respaced) steps and
    denoised by the prior (a generator seeded ``50 + i`` for trajectory
    ``i``).  Returns the report's ``prior_coverage`` and the fit's ms per
    step."""
    dev = assets.device
    diffusion = create_gaussian_diffusion(steps=1000, noise_schedule="cosine",
                                          timestep_respacing=str(steps) if steps != 1000 else "")
    n_ts = diffusion.num_timesteps
    oracle_rmae, rt_rows, fit_conv, fit_s = [], [], [], 0.0
    for i in range(held_flat.shape[0]):
        t0 = clock(dev)
        z, loss_end, loss_mid = fit_oracle(assets, held_flat[i])
        fit_s += clock(dev) - t0
        fit_conv.append({"loss_mid": loss_mid, "loss_end": loss_end})
        z = z.cpu().numpy()
        dec = assets.tr.infer(assets.full_coords, z).cpu().numpy()
        oracle_rmae.append(float(np.mean(per_channel_rmae(dec, held_flat[i]))))
        x0 = minmax_to_unit_interval(z, assets.mx, assets.mn)
        for t_star in (n_ts // 4, n_ts // 2, (3 * n_ts) // 4):
            img = roundtrip(assets, diffusion,
                            torch.as_tensor(x0, dtype=torch.float32, device=dev)[None, None],
                            t_star, torch.Generator(dev).manual_seed(50 + i))
            img = img[0, 0].float().cpu().numpy()
            rt_dec = decode_fields(assets, img[None])[0]
            rt_rows.append({
                "traj": i, "t_star": int(t_star), "t_star_frac": float(t_star) / n_ts,
                "field_rmae_vs_truth": float(np.mean(per_channel_rmae(rt_dec, held_flat[i]))),
                "latent_rel_l2": float(np.linalg.norm(img - x0) / np.linalg.norm(x0)),
            })
        print(f"      traj {i}: oracle rMAE {oracle_rmae[-1]:.4f}, round-trip rMAE "
              f"{[round(r['field_rmae_vs_truth'], 3) for r in rt_rows[-3:]]} @ t*/T=1/4,1/2,3/4")
    report = {"oracle_field_rmae": oracle_rmae,
              "oracle_field_rmae_mean": float(np.mean(oracle_rmae)),
              "oracle_fit_convergence": fit_conv, "roundtrip": rt_rows}
    return report, fit_s * 1e3 / (N_FIT * held_flat.shape[0])


def tune_guidance(assets: Assets, held: np.ndarray, sensor_idx, measures, scales, steps: int,
                  step_ms: dict):
    """``ps`` at each scale and ``ps_linear_decay`` at 1.0 on trajectory 0
    (4 members, seed 10): the candidates meeting the trajectory-0 physics
    bars (timescale ratio >= 0.6, spectra error <= 0.10), best field rMAE
    among them, else best field rMAE overall.  Returns the sweep, the
    chosen method and scale, and the count that qualified."""
    grid, n_snap = assets.grid, assets.n_snap
    held_flat0 = held[0].reshape(n_snap, grid * grid, 2)
    coords0, yn0 = assets.full_coords[sensor_idx[0]], ynorm_sliced(
        assets.tr.out_normalizer, sensor_idx[0])
    true_grid0 = held[0]
    tau_true0 = max(float(integral_timescale(true_grid0[..., 0], 1.0)), 1e-9)
    sweep = {}
    for method, s in [("ps", s) for s in scales] + [("ps_linear_decay", 1.0)]:
        samples, final_dist, ms = run_ensemble(assets, coords0, yn0, measures[0], s, steps, 4,
                                               10, method)
        step_ms[f"tuning {method}@{s}"] = ms
        fields = decode_fields(assets, samples)
        frmae = float(np.mean(per_channel_rmae(fields.mean(0), held_flat0)))
        cand_grid = fields.reshape(-1, n_snap, grid, grid, 2)
        tau = float(np.mean([integral_timescale(cand_grid[e, ..., 0], 1.0)
                             for e in range(cand_grid.shape[0])]))
        cspec = float(spectra_relative_error(
            np.concatenate([cand_grid[..., 0], cand_grid[..., 1]]).reshape(-1, grid),
            np.concatenate([true_grid0[..., 0], true_grid0[..., 1]]).reshape(-1, grid),
            axis=-1))
        sweep[f"{method}@{s}"] = {"field_rmae": frmae, "sensor_misfit": float(np.mean(final_dist)),
                                  "timescale": tau, "timescale_ratio": tau / tau_true0,
                                  "spectra_error": cspec}
        print(f"      {method}@{s}: field rMAE {frmae:.4f}, sensor misfit "
              f"{np.mean(final_dist):.3f}, timescale {tau:.2f} (ratio {tau / tau_true0:.2f}), "
              f"spectra {cspec:.3f}, {ms:.1f} ms a guided step")
    qualified = [k for k, v in sweep.items()
                 if v["timescale_ratio"] >= 0.6 and v["spectra_error"] <= 0.10]
    if not qualified:
        print("      WARNING: no candidate meets the traj-0 physics bars (timescale ratio "
              ">= 0.6, spectra <= 0.10) — falling back to best field rMAE")
    best_key = min(qualified or list(sweep), key=lambda k: sweep[k]["field_rmae"])
    method, scale = best_key.split("@")
    return sweep, method, float(scale), len(qualified)


def reconstruct_held_out(assets: Assets, held_flat, sensor_idx, measures, method: str,
                         scale: float, steps: int, n_ens: int, step_ms: dict):
    """Every trajectory reconstructed by ``n_ens`` members (seed ``100 +
    i``): sensor-trace rMAE and 3-sigma coverage of the decoded fields, the
    ensemble mean's and the members' field rMAE, the mean's relative L2.
    Returns the per-trajectory rows and the fields ``(n_held, E, T, N, 2)``."""
    per_traj, ens_fields = [], []
    for i in range(held_flat.shape[0]):
        samples, _, ms = run_ensemble(
            assets, assets.full_coords[sensor_idx[i]],
            ynorm_sliced(assets.tr.out_normalizer, sensor_idx[i]), measures[i], scale, steps,
            n_ens, 100 + i, method)
        step_ms[f"held_out traj {i}"] = ms
        fields = decode_fields(assets, samples)
        ens_fields.append(fields)
        mean_f = fields.mean(0)
        tr_pred, tr_true = fields[:, :, sensor_idx[i], :], measures[i]
        m, sd = tr_pred.mean(0), tr_pred.std(0)
        cover = float(np.mean((tr_true >= m - 3 * sd) & (tr_true <= m + 3 * sd)))
        sensor_rmae = float(np.mean(np.abs(m - tr_true)) / np.mean(np.abs(tr_true)))
        field_rmae = [float(x) for x in per_channel_rmae(mean_f, held_flat[i])]
        member_rmae = float(np.mean([np.mean(per_channel_rmae(fields[e], held_flat[i]))
                                     for e in range(fields.shape[0])]))
        rel_l2 = float(np.linalg.norm(mean_f - held_flat[i]) / np.linalg.norm(held_flat[i]))
        per_traj.append({"traj": i, "role": "validation" if i == 0 else "held_out",
                         "sensor_rmae": sensor_rmae, "sigma3_coverage": cover,
                         "field_rmae_mean": field_rmae, "field_rmae_per_member": member_rmae,
                         "field_rel_l2_mean": rel_l2})
        print(f"      traj {i}: sensor rMAE {sensor_rmae:.4f}, 3sigma coverage {cover:.3f}, "
              f"field rMAE {field_rmae}, member rMAE {member_rmae:.4f}, {ms:.1f} ms a "
              "guided step")
    return per_traj, np.stack(ens_fields)


def sweep_sensors(assets: Assets, truth, idx, method: str, scale: float, steps: int,
                  seed: int):
    """One sensor budget of the sweep on one trajectory's fields ``truth``
    ``(T, N, 2)``: 4 members at the points ``idx``.  Returns the
    sweep row and ms per guided step."""
    meas = truth[:, idx, :]
    samples, final_dist, ms = run_ensemble(
        assets, assets.full_coords[idx], ynorm_sliced(assets.tr.out_normalizer, idx), meas,
        scale, steps, 4, seed, method)
    fields = decode_fields(assets, samples)
    mean_f = fields.mean(0)
    n_points = assets.grid * assets.grid
    return {
        "n_sensors": len(idx), "sensor_fraction": len(idx) / n_points,
        "field_rmae": float(np.mean(per_channel_rmae(mean_f, truth))),
        "field_rel_l2": float(np.linalg.norm(mean_f - truth) / np.linalg.norm(truth)),
        "sensor_rmae": float(np.mean(np.abs(fields[:, :, idx, :].mean(0) - meas))
                             / np.mean(np.abs(meas))),
        "sensor_misfit": float(np.mean(final_dist)),
    }, ms


def sweep_indices(grid: int, counts, seed: int) -> list:
    """The sweep's sorted sensor points, one draw per count in order."""
    rng = np.random.default_rng(seed + 2)
    return [np.sort(rng.choice(grid * grid, size=n, replace=False)) for n in counts]


def in_distribution_control(assets: Assets, n_sensors: int, seed: int, method: str,
                            scale: float, steps: int, step_ms: dict) -> dict:
    """DPS on training trajectory 0's decoded fields from the same sensor
    budget (4 members, seed 400): low error here with high held-out error
    puts the failure on the prior's coverage, high error here too on the
    guidance."""
    latents = assets.tr.state.latents.detach().cpu().numpy()
    train0 = assets.tr.infer(assets.full_coords, latents[:assets.n_snap]).cpu().numpy()
    idx0 = np.sort(np.random.default_rng(seed + 3).choice(
        assets.grid * assets.grid, size=n_sensors, replace=False))
    meas0 = train0[:, idx0, :]
    samples, _, step_ms["in_dist"] = run_ensemble(
        assets, assets.full_coords[idx0], ynorm_sliced(assets.tr.out_normalizer, idx0), meas0,
        scale, steps, 4, 400, method)
    fields = decode_fields(assets, samples)
    return {"n_train_snaps_total": int(latents.shape[0]),
            "field_rmae": float(np.mean(per_channel_rmae(fields.mean(0), train0))),
            "sensor_rmae": float(np.mean(np.abs(fields[:, :, idx0, :].mean(0) - meas0))
                                 / np.mean(np.abs(meas0)))}


@torch.no_grad()
def unconditional_control(assets: Assets, n_ens: int, steps: int):
    """``n_ens`` unguided samples (a generator seeded 999) decoded on the
    full mesh, and ms per step."""
    dev = assets.device
    diffusion = create_gaussian_diffusion(steps=1000, noise_schedule="cosine",
                                          timestep_respacing=str(steps) if steps != 1000 else "")
    t0 = clock(dev)
    img = diffusion.p_sample_loop(assets.unet, (n_ens, 1, assets.n_snap, assets.latent),
                                  generator=torch.Generator(dev).manual_seed(999))
    ms = (clock(dev) - t0) * 1e3 / diffusion.num_timesteps
    return decode_fields(assets, img[:, 0].float().cpu().numpy()), ms


def plot_conditional(out_dir: str, held: np.ndarray, ens_fields, sensor_idx, measures,
                     sensor_sweep, uncond_rmae0: float) -> None:
    """The sensor traces of trajectory 0 (the notebook's +-3 sigma
    acceptance plot), mid-trajectory fields of every trajectory, and the
    sweep's error against the sensor budget."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plots")
        return
    n_held, n_snap, grid = held.shape[0], held.shape[1], held.shape[2]
    tr_pred = ens_fields[0][:, :, sensor_idx[0], :]
    m, sd = tr_pred.mean(0), tr_pred.std(0)
    tt = np.arange(n_snap)
    fig, axes = plt.subplots(2, 2, figsize=(11, 6), sharex=True)
    for j, ax in enumerate(axes.flat[:min(4, sensor_idx.shape[1])]):
        ax.fill_between(tt, m[:, j, 0] - 3 * sd[:, j, 0], m[:, j, 0] + 3 * sd[:, j, 0],
                        color="r", alpha=0.25, label="DPS ensemble +-3 sigma")
        ax.plot(tt, m[:, j, 0], "r-", lw=1.2, label="DPS ensemble mean")
        ax.plot(tt, measures[0][:, j, 0], "k.", ms=3.5, label="sensor truth")
        ax.set_title(f"sensor {j} (u)")
        ax.grid(alpha=0.3)
        if j == 0:
            ax.legend(fontsize=8)
    for ax in axes[1]:
        ax.set_xlabel("snapshot")
    fig.suptitle("held-out trajectory 0: sensor traces, truth vs DPS reconstruction")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "demo_cond_sensors.png"), dpi=120)
    plt.close(fig)

    fig, axes = plt.subplots(n_held, 3, figsize=(9, 2.6 * n_held), squeeze=False)
    vmax = np.abs(held[..., 0]).max()
    for i in range(n_held):
        tru = held[i, n_snap // 2, :, :, 0]
        rec = ens_fields[i].mean(0)[n_snap // 2].reshape(grid, grid, 2)[..., 0]
        axes[i, 0].imshow(tru, cmap="RdBu_r", vmin=-vmax, vmax=vmax)
        axes[i, 1].imshow(rec, cmap="RdBu_r", vmin=-vmax, vmax=vmax)
        axes[i, 2].imshow(np.abs(rec - tru), cmap="magma", vmin=0, vmax=vmax / 2)
        ys, xs = np.unravel_index(sensor_idx[i], (grid, grid))
        axes[i, 0].scatter(xs, ys, s=8, c="lime", marker="o", edgecolors="k", linewidths=0.4)
        axes[i, 0].set_ylabel(f"traj {i}")
        for ax, title in zip(axes[i], ("truth (+ sensors)", "DPS mean", "|error|")):
            if i == 0:
                ax.set_title(title)
            ax.set_xticks([])
            ax.set_yticks([])
    fig.suptitle("held-out u-velocity, mid-trajectory snapshot")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "demo_cond_fields.png"), dpi=120)
    plt.close(fig)

    if sensor_sweep:
        fig, ax = plt.subplots(figsize=(5.5, 3.6))
        ns = [r["n_sensors"] for r in sensor_sweep]
        ax.semilogx(ns, [r["field_rmae"] for r in sensor_sweep], "o-",
                    label="DPS field rMAE (ens. mean)")
        ax.semilogx(ns, [r["sensor_rmae"] for r in sensor_sweep], "s--",
                    label="sensor-trace rMAE")
        ax.axhline(uncond_rmae0, color="gray", ls=":", label="unconditional control")
        ax.set_xlabel("number of sensors")
        ax.set_ylabel("rMAE")
        ax.grid(alpha=0.3, which="both")
        ax.legend(fontsize=8)
        fig.suptitle("trajectory 0: reconstruction vs sensor budget")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "demo_cond_sweep.png"), dpi=120)
        plt.close(fig)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    out_dir = os.path.abspath(args.out or os.path.join(REPO_ROOT, "demo_out_torch"))
    stage_s, step_ms, timing = {}, {}, {}
    t0 = clock(device)

    print("[1/5] loading stage-1/2 assets ...")
    assets = load_assets(out_dir, device)
    grid, n_snap = assets.grid, assets.n_snap
    stage_s["load"] = clock(device) - t0
    t = clock(device)
    print(f"      simulating {args.n_held} held-out {assets.flow} trajectories ({n_snap} snaps, "
          f"seed {args.seed}) ...")
    held = simulate_turbulence(grid, n_snap, args.n_held, seed=args.seed,
                               **FLOW_PRESETS[assets.flow])
    held_flat = held.reshape(args.n_held, n_snap, grid * grid, 2)
    sensor_idx, measures = place_sensors(held_flat, args.n_sensors, args.seed)
    stage_s["simulate"] = clock(device) - t

    coverage = None
    if args.prior_check:
        print("[2b/5] prior-coverage diagnostic ...")
        t = clock(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        coverage, timing["oracle_fit_ms_per_step"] = prior_coverage(assets, held_flat,
                                                                     args.steps)
        if device.type == "cuda":
            timing["prior_check_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        stage_s["prior_check"] = clock(device) - t

    scales = [float(s) for s in args.scales.split(",")]
    print(f"[3/5] tuning guidance on trajectory 0 ({args.steps} steps) ...")
    t = clock(device)
    sweep, best_method, best_scale, n_qualified = tune_guidance(
        assets, held, sensor_idx, measures, scales, args.steps, step_ms)
    print(f"      chosen: {best_method} scale {best_scale} "
          f"(physics-qualified: {n_qualified}/{len(sweep)})")
    stage_s["tuning"] = clock(device) - t

    print(f"[4/5] DPS reconstruction: {args.n_held} trajectories x {args.n_ens} samples x "
          f"{args.steps} steps ...")
    t = clock(device)
    per_traj, ens_fields = reconstruct_held_out(assets, held_flat, sensor_idx, measures,
                                                best_method, best_scale, args.steps,
                                                args.n_ens, step_ms)
    stage_s["held_out"] = clock(device) - t

    sensor_sweep = []
    counts = [int(s) for s in args.sensor_sweep.split(",") if s]
    if counts:
        print(f"[4b/5] sensor-count sweep on trajectory 0: {counts} sensors x {args.steps} "
              "steps ...")
        t = clock(device)
        for n_s, idx in zip(counts, sweep_indices(grid, counts, args.seed)):
            row, step_ms[f"sweep {n_s}"] = sweep_sensors(assets, held_flat[0], idx,
                                                         best_method, best_scale, args.steps,
                                                         300 + n_s)
            sensor_sweep.append(row)
            print(f"      {n_s:5d} sensors: field rMAE {row['field_rmae']:.4f}, rel L2 "
                  f"{row['field_rel_l2']:.4f}, sensor rMAE {row['sensor_rmae']:.4f}, "
                  f"{step_ms[f'sweep {n_s}']:.1f} ms a guided step")
        stage_s["sensor_sweep"] = clock(device) - t

    in_dist = None
    if args.prior_check:
        print("      in-distribution control: DPS on training traj 0 ...")
        t = clock(device)
        in_dist = in_distribution_control(assets, args.n_sensors, args.seed, best_method,
                                          best_scale, args.steps, step_ms)
        print(f"      in-dist field rMAE {in_dist['field_rmae']:.4f}, sensor rMAE "
              f"{in_dist['sensor_rmae']:.4f}")
        stage_s["in_dist"] = clock(device) - t

    print("      control: unconditional ensemble vs the same truth ...")
    t = clock(device)
    uncond_fields, timing["unconditional_step_ms"] = unconditional_control(
        assets, args.n_ens, args.steps)
    stage_s["unconditional"] = clock(device) - t

    # trajectory 0's full-field truth chose the guidance: every pooled
    # metric is over the remaining trajectories (all of them if only the
    # validation one ran)
    print("[5/5] physics metrics + plots ...")
    t = clock(device)
    held_ids = list(range(1, args.n_held)) if args.n_held > 1 else [0]
    uncond_mean = uncond_fields.mean(0)
    uncond_rmae = float(np.mean([np.mean(per_channel_rmae(uncond_mean, held_flat[i]))
                                 for i in held_ids]))
    gen_grid = ens_fields[held_ids].reshape(-1, n_snap, grid, grid, 2)
    true_pool = held[held_ids]
    spec_err = spectra_relative_error(
        np.concatenate([gen_grid[..., 0], gen_grid[..., 1]]).reshape(-1, grid),
        np.concatenate([true_pool[..., 0], true_pool[..., 1]]).reshape(-1, grid), axis=-1)
    tau_true = float(np.mean([integral_timescale(held[i, ..., 0], 1.0) for i in held_ids]))
    tau_cond = float(np.mean([integral_timescale(gen_grid[i, ..., 0], 1.0)
                              for i in range(gen_grid.shape[0])]))
    plot_conditional(out_dir, held, ens_fields, sensor_idx, measures, sensor_sweep,
                     float(np.mean(per_channel_rmae(uncond_mean, held_flat[0]))))

    held_out = [r for r in per_traj if r["role"] == "held_out"] or per_traj
    field_rmae_held_out = float(np.mean([np.mean(r["field_rmae_mean"]) for r in held_out]))
    stage_s["metrics"] = clock(device) - t
    if device.type == "cuda":
        timing["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    report = {
        "run_dir": os.path.relpath(out_dir, REPO_ROOT),
        "protocol": {
            "n_held": args.n_held, "n_sensors": args.n_sensors, "n_ens": args.n_ens,
            "steps": args.steps, "held_seed": args.seed, "grid": grid, "n_snap": n_snap,
            "sensor_fraction": args.n_sensors / (grid * grid),
            "guidance_method": best_method, "guidance_scale": best_scale,
            "tuning_sweep": sweep, "tuning_trajectory": 0,
        },
        "per_trajectory": per_traj,
        "sensor_rmae_pooled": float(np.mean([r["sensor_rmae"] for r in held_out])),
        "sigma3_coverage_pooled": float(np.mean([r["sigma3_coverage"] for r in held_out])),
        "field_rmae_held_out": field_rmae_held_out,
        "field_rmae_per_member_held_out": float(np.mean([r["field_rmae_per_member"]
                                                         for r in held_out])),
        # includes the validation trajectory: a diagnostic only
        "field_rmae_pooled_incl_validation": float(np.mean([np.mean(r["field_rmae_mean"])
                                                            for r in per_traj])),
        "field_rmae_unconditional_control": uncond_rmae,
        "conditioning_gain": uncond_rmae / max(field_rmae_held_out, 1e-9),
        "sensor_sweep": sensor_sweep,
        "prior_coverage": coverage,
        "in_distribution_control": in_dist,
        "spectra_relative_error": float(spec_err),
        "integral_timescale_truth": tau_true,
        "integral_timescale_conditional": tau_cond,
        "timescale_ratio": tau_cond / tau_true,
        "wall_clock_s": round(clock(device) - t0, 1),
        "device": device_entry(device, stage_s=stage_s, guided_step_ms=step_ms, **timing),
    }
    path = os.path.join(out_dir, "demo_conditional.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print(f"report -> {path}")
    return report


if __name__ == "__main__":
    main()
