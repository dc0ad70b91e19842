"""Integral-timescale CLI, the port of ``confild_tpu/cli/
integral_timescale.py`` (reference ``Analysis/calculate_integral_timescale.py``):
spatially-averaged temporal autocorrelation of a velocity component,
integrated (trapezoid) to the 0.05-crossing / first minimum.

    python -m confild_tpu_torch.cli.integral_timescale --output-dir u.npy \
        --output-dt 0.1 [--plot]

Reads Dedalus-style HDF5 (``tasks/<field>``) or a plain .npy of shape
(time, *space) / (time, components, *space).  ``h5py`` is imported only on
the HDF5 route and ``matplotlib`` only under ``--plot``.  Host numpy only:
no device is involved.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from confild_tpu_torch.analysis.metrics import (autocorr_cutoff, integral_timescale,
                                          temporal_autocorrelation)


def load_field(path: str, field: str, u_component: int,
               step_cutoff: int) -> np.ndarray:
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.h5")))
        if not files:
            raise FileNotFoundError(f"no .h5 files in {path}")
        import h5py
        with h5py.File(files[0], "r") as f:
            data = f[f"tasks/{field}"][()]
    elif path.endswith(".h5"):
        import h5py
        with h5py.File(path, "r") as f:
            data = f[f"tasks/{field}"][()]
    else:
        data = np.load(path)

    if data.shape[0] <= step_cutoff:
        raise ValueError(f"need more than {step_cutoff} timesteps, "
                         f"got {data.shape[0]}")
    data = data[data.shape[0] - (data.shape[0] - step_cutoff):]
    if data.ndim == 4:  # (time, components, y, x)
        data = data[:, u_component]
    return data


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output-dir", required=True,
                   help="HDF5 dir / .h5 file / .npy file")
    p.add_argument("--output-dt", type=float, required=True)
    p.add_argument("--field", default="velocity")
    p.add_argument("--step-cutoff", type=int, default=0)
    p.add_argument("--u-component", type=int, default=0)
    p.add_argument("--plot", action="store_true",
                   help="save the two-panel autocorrelation figure "
                        "(reference calculate_integral_timescale.py:140-182)")
    p.add_argument("--plot-dir", default=None,
                   help="directory for the figure (default: alongside input)")
    args = p.parse_args(argv)

    u = load_field(args.output_dir, args.field, args.u_component,
                   args.step_cutoff)
    ac = temporal_autocorrelation(u)
    cutoff = autocorr_cutoff(ac)
    tau = integral_timescale(u, args.output_dt)
    steps = int(tau // args.output_dt + 1)
    print(f"cutoff index: {cutoff}")
    print(f"integral timescale: {tau:.6f} s (~ {steps} steps)")
    if args.plot:
        out_dir = args.plot_dir or (
            args.output_dir if os.path.isdir(args.output_dir)
            else os.path.dirname(os.path.abspath(args.output_dir)))
        save_plot(ac, cutoff, tau, steps, args.output_dt, args.field, out_dir)
    return tau


def save_plot(ac, cutoff, tau, steps, output_dt, field, out_dir):
    """Two-panel autocorrelation figure: full curve with threshold/cutoff
    markers + shaded integration area (reference
    ``calculate_integral_timescale.py:140-182`` layout)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return None
    lags = np.arange(len(ac)) * output_dt
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 8))
    ax1.plot(lags, ac, "b-", label="Spatial Avg Autocorrelation")
    ax1.axhline(y=0.05, color="r", linestyle="--", label="Threshold (0.05)")
    ax1.axvline(x=cutoff * output_dt, color="g", linestyle="-",
                label=f"Cutoff ({cutoff * output_dt:.4f})")
    ax1.axhline(y=0, color="k", linestyle="-", alpha=0.3)
    ax1.set_xlabel("Time lag")
    ax1.set_ylabel("Autocorrelation")
    ax1.set_title(f"Spatially-Averaged {field} Autocorrelation")
    ax1.grid(True)
    ax1.legend()

    t_int = lags[:cutoff]
    ax2.fill_between(t_int, ac[:cutoff], alpha=0.3, color="b")
    ax2.plot(t_int, ac[:cutoff], "b-")
    ax2.axhline(y=0, color="k", linestyle="-", alpha=0.3)
    ax2.set_xlabel("Time lag")
    ax2.set_ylabel("Autocorrelation")
    ax2.set_title(f"Integration Area - Integral Time Scale = {tau:.6f} s "
                  f"(~ {steps} steps)")
    ax2.grid(True)

    fig.tight_layout()
    path = os.path.join(out_dir, f"autocorrelation_detailed_{field}.png")
    fig.savefig(path)
    plt.close(fig)
    print(f"plot -> {path}")
    return path


if __name__ == "__main__":
    main()
