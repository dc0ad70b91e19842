"""CNF evaluation CLI, the port of ``confild_tpu/cli/eval_cnf.py`` (reference
``Analysis/cnf_inference_pub.py`` / ``cnf_inference_mhd.py``): spot-check
predictions vs ground truth and compute per-channel MSE / rMAE over the full
snapshot set.

    python -m confild_tpu_torch.cli.eval_cnf --checkpoint ckpt --config cnf.yml \
        --data data.npy [--coords coords.npy] [--timestep 2 --row 0 --vals 5]

The decode is ``CNF_inference.predict``: on the card the SIREN forward
kernel.  ``--device cpu`` runs it on the CPU; the default is the CUDA card.
"""

from __future__ import annotations

import argparse

import numpy as np

from confild_tpu_torch.analysis.metrics import per_channel_mse, per_channel_rmae
from confild_tpu_torch.inference import CNF_inference


def spot_check(args):
    """Print data-vs-prediction at a chosen (timestep, row, columns)
    (reference ``cnf_inference_pub.py:100-143`` output format)."""
    # validate cheap argument constraints BEFORE the (expensive) checkpoint
    # and data load
    latent_indices = args.latent_indices or [args.timestep]
    nt, row, vals = args.timestep, args.row, args.vals
    if nt not in latent_indices:
        raise ValueError(f"Timestep {nt} not found in latent indices "
                         f"{latent_indices}")
    nt_idx = latent_indices.index(nt)
    if row < 0:
        raise ValueError(f"--row must be >= 0, got {row}")

    inf = CNF_inference(args.checkpoint, args.config, args.data,
                        is_pub=args.is_pub, device=args.device)
    if inf.data.ndim == 3 and row != 0:
        raise ValueError(
            f"--row {row} is out of range: flat (t, N, c) data has a "
            "single-row grid view — only --row 0 is valid (choose columns "
            "via --vals)")
    if inf.data.ndim == 4 and row >= inf.data.shape[1]:
        raise ValueError(f"--row {row} out of range for grid with "
                         f"{inf.data.shape[1]} rows")

    if args.coords:
        coords = np.load(args.coords)
    else:
        coords = inf.create_coordinates_grid()
    flat_coords = coords.reshape(-1, coords.shape[-1])

    print(f"Generating predictions for latent indices {latent_indices}...")
    pred = inf.predict(flat_coords, latent_indices, args.batch_size)
    data = inf.data
    pred = np.asarray(pred).reshape(len(latent_indices), *data.shape[1:])
    if data.ndim == 3:  # flat (t, N, c) data: single-row grid view
        data = data[:, None]
        pred = pred[:, None]
    n_channels = pred.shape[-1]

    print(f"\n{'=' * 50}")
    print(f"COMPARISON AT TIMESTEP {nt}, ROW {row}, FIRST {vals} COLUMNS")
    print(f"{'=' * 50}")
    mses, rmaes = [], []
    for c in range(n_channels):
        d = data[nt, row, :vals, c]
        pr = pred[nt_idx, row, :vals, c]
        err = np.abs(d - pr)
        print(f"\n{'-' * 50}\nChannel {c}\n{'-' * 50}")
        print(f"DATA:       {d}")
        print(f"PREDICTION: {pr}")
        print(f"ABS ERROR:  {err}")
        print(f"MEAN ERROR: {np.mean(err):.3e}")
        mse = float(np.mean((d - pr) ** 2))
        rmae = float(np.mean(err / (np.abs(d) + 1e-8)))
        print(f"MSE:        {mse:.3e}")
        print(f"RMAE:       {rmae:.3e}")
        mses.append(mse)
        rmaes.append(rmae)
    print(f"\nTOTAL MSE:  {np.mean(mses):.3e}")
    print(f"TOTAL RMAE: {np.mean(rmaes):.3e}")
    return np.asarray(mses), np.asarray(rmaes)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--coords", default=None,
                   help=".npy coordinate file; unit grid inferred otherwise")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-snapshots", type=int, default=None)
    p.add_argument("--is-pub", action="store_true")
    # spot-check mode (reference cnf_inference_pub.py:100-143): print chosen
    # (timestep, row, first-N-column) data-vs-prediction comparisons
    p.add_argument("--timestep", type=int, default=None,
                   help="spot-check: timestep to compare (enables the mode)")
    p.add_argument("--row", type=int, default=0,
                   help="spot-check: row within the snapshot")
    p.add_argument("--vals", type=int, default=5,
                   help="spot-check: number of leading columns to print")
    p.add_argument("--latent-indices", type=int, nargs="+", default=None,
                   help="spot-check: latent indices to decode "
                        "(must contain --timestep; defaults to [--timestep])")
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)

    if args.timestep is not None:
        return spot_check(args)

    inf = CNF_inference(args.checkpoint, args.config, args.data,
                        is_pub=args.is_pub, device=args.device)
    data = inf.data
    n = args.num_snapshots or data.shape[0]
    data = data[:n]

    if args.coords:
        coords = np.load(args.coords)
    else:
        coords = inf.create_coordinates_grid()
    flat_coords = coords.reshape(-1, coords.shape[-1])

    pred = inf.predict(flat_coords, list(range(n)), args.batch_size)
    pred = pred.reshape(n, *data.shape[1:])

    mse = per_channel_mse(pred, data)
    rmae = per_channel_rmae(pred.reshape(n, -1, data.shape[-1]),
                            data.reshape(n, -1, data.shape[-1]))
    for k in range(data.shape[-1]):
        print(f"channel {k}: MSE {mse[k]:.6e}  rMAE {rmae[k]:.6e}")
    return mse, rmae


if __name__ == "__main__":
    main()
