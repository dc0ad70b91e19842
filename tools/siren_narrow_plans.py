#!/usr/bin/env python3
"""The SIREN-FiLM cluster kernels with blocks of 64 columns against zero
padding, on one card.

    python3 tools/siren_narrow_plans.py [--rows 4] [--points 262144] [--out DIR]

Up to H = 512 the cluster plan (``csrc/siren_cluster.cuh::CONFIGS``) pads a
hidden width to 128, 192, 256, 384 or 512: 320 runs as 384 (two blocks of
192 columns) and 448 as 512 (two of 256), which is exact (a padded unit has
zero weights).  An instantiation of 64 columns a block would pad only to the
next multiple of 64 (320 as five blocks, 448 as seven).  This builds the
cluster forward and chain with that instantiation added (patched copies of
the sources, as ``tools/siren_bwd_ablation.py`` builds them, into ``DIR``,
default a temporary directory), plans with it on the wrapper's side too, and
times both routes of the float32 forward and of the training backward
(``ops.siren_decode``'s launches on operands padded by ``pad_hidden``) on a
decoder of six modulated layers, 3 -> H -> 3, at ``--rows`` x ``--points``,
in turns (plan, padded, padded, plan), each a median of 5
(``chip_smoke.cuda_median``), with the two routes' largest difference.
Prints one JSON line last.  Needs an H100 and the CUDA toolkit; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import siren_bwd_ablation as ab  # noqa: E402
from confild_tpu_torch.ops import siren_decode as sd  # noqa: E402

# a width that blocks of 64 columns run unpadded, and the width it pads to
WIDTHS = ((320, 384), (448, 512))
# the instantiation of 64 columns a block over 128 pairs, in the plan and
# in the dispatch to the kernels' templates
S64 = (("siren_cluster.cuh",
        "constexpr int CONFIGS[][2] = {{128, 2},",
        "constexpr int CONFIGS[][2] = {{64, 2}, {128, 2},", 1),
       ("siren_cluster.cuh",
        "  if (p.share == 128 && p.mt == 2)",
        "  if (p.share == 64 && p.mt == 2) return f(std::integral_constant<int, 64>(), "
        "std::integral_constant<int, 2>());\n  if (p.share == 128 && p.mt == 2)", 1))


def with_64_column_blocks(out_dir: str) -> None:
    """The cluster libraries built with ``S64`` and the wrapper planning
    with it."""
    fwd = ab.build(out_dir, "siren_fwd_cluster.cu", {"fwd_s64": (S64, True)},
                   sd._cluster_library)["fwd_s64"]
    chain = ab.build(out_dir, "siren_chain_cluster.cu", {"chain_s64": (S64, True)},
                     sd._chain_cluster_library)["chain_s64"]
    sd._cluster_library = lambda: fwd
    sd._chain_cluster_library = lambda: chain
    sd.CLUSTER_CONFIGS = ((64, 2),) + sd.CLUSTER_CONFIGS


def routes(model, device, rows, points, padded_width):
    """``{route: (forward, backward)}``: the calls on the plan's width and
    on operands padded to ``padded_width``."""
    coords, _, z, ops = cs.forward_case(model, device, rows, points, seed=5)
    g = torch.randn((rows, points, ops[2].shape[1]), device=device,
                    generator=torch.Generator(device=device).manual_seed(6))
    h = z.shape[2]
    fwd32 = functools.partial(sd._launch_forward, compute_dtype=torch.float32)
    out = {}
    for route, width in (("plan", h), ("padded", padded_width)):
        out[route] = (
            lambda w=width: sd.padded_forward(fwd32, coords, z, *ops, w),
            lambda w=width: sd.padded_bwd(sd._launch_bwd, coords, z, g, *ops[:3], w))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--points", type=int, default=262144)
    ap.add_argument("--out", help="build directory (default: a temporary one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("siren_narrow_plans: no CUDA device", file=sys.stderr)
        return 1
    device = cs.resolve_device("cuda")
    _, _, smi = cs.phase_device()
    summary = {"device": smi, "shape": f"{args.rows}x{args.points}"}
    with tempfile.TemporaryDirectory(prefix="siren_narrow_plans_") as tmp:
        with_64_column_blocks(args.out or tmp)
        for h, padded in WIDTHS:
            plan, pad = sd.cluster_plan(h), sd.cluster_plan(padded)
            assert plan.width == h and plan.share == 64 and pad.width == padded
            model, label = cs.check_decoder(device, 3, 3, 5, h)
            fns = routes(model, device, args.rows, args.points, padded)
            with torch.no_grad():
                fwd = (fns["plan"][0](), fns["padded"][0]())
                bwd = (fns["plan"][1](), fns["padded"][1]())
                diff = {"forward": (fwd[0] - fwd[1]).abs().max().item(),
                        "dW_mid": (bwd[0][2] - bwd[1][2]).abs().max().item()}
                del fwd, bwd
                times = {f"{r}_{k}": [] for r in fns for k in ("forward", "bwd")}
                for route in ("plan", "padded", "padded", "plan"):
                    for k, fn in zip(("forward", "bwd"), fns[route]):
                        times[f"{route}_{k}"].append(cs.cuda_median(fn, 1, repeats=5)[0])
            cs.log(f"[plans] {label}: {plan.blocks} blocks of {plan.share} columns against "
                   f"{pad.blocks} of {pad.share} (padded to {padded}) at {summary['shape']}: "
                   + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f} ms" for k, v in times.items())
                   + f"; largest difference {diff}; SM clock {cs.sm_clocks()}")
            summary[f"H{h}"] = {"times_ms": times, "max_abs_diff": diff, "padded_to": padded}
            del model, fns
            torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
