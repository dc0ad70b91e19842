#!/usr/bin/env python3
"""The float32 SIREN-FiLM forward of two checkouts of the port on one card,
in turns: the other tree, this one, this one, the other.

    python3 tools/siren_fwd_compare.py OTHER_TREE [--hidden 1024] [--rows 4]
        [--points 262144]

Each turn is a process of its own that imports the tree it times (its
``chip_smoke.py`` and ``confild_tpu_torch``), builds the libraries its
float32 forward needs at that width (``siren_fwd_cluster`` above H = 512
where the tree has it; else ``siren_decode`` and, for the timing's stream
reckoning, ``siren_decode_bwd``), and times
``chip_smoke.forward_time`` on ``recipes/cnf/case4.yml`` at ``--hidden``
units and 5 outputs (``chip_smoke.WIDE_CNF``'s decoder, seed 19) at
``--rows`` x ``--points``: a median of 3 with the SM clocks, the plain
version's time and the bound.  Prints each turn's ``[forward]`` line and
last one JSON object with each tree's medians.  Needs an H100 and the CUDA
toolkit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

TURN = r"""
import json, sys, torch
import chip_smoke as cs
from confild_tpu_torch.models.cnf import SirenFilm
from confild_tpu_torch.ops import cuda_build, siren_decode as sd
h, rows, points = map(int, sys.argv[1:4])
# a tree without the cluster kernel reckons its stream from the backward
# library's block size (chip_smoke.block_pairs): build both at once
names = (["siren_fwd_cluster"] if h > getattr(sd, "NARROW_HIDDEN", 10 ** 9)
         else ["siren_decode", "siren_decode_bwd"])
cuda_build.build_all(names)
device = cs.resolve_device("cuda")
model = SirenFilm(**dict(cs.WIDE_CNF, hidden_features=h),
                  generator=torch.Generator().manual_seed(19)).to(device).requires_grad_(False)
r = cs.forward_time(model, device, rows, points, 38, repeats=3)
print("TURN " + json.dumps({"ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"]}))
"""


def turn(tree: Path, args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", TURN, str(args.hidden), str(args.rows),
                           str(args.points)], cwd=tree, env=env, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith(("[forward", "[profile] forward")):
            print(f"[{tree.name}] {line}", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: the turn failed\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.rsplit("TURN ", 1)[1].splitlines()[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--points", type=int, default=262144)
    args = ap.parse_args()
    other = args.other.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {"other": [], "this": []}
    for label, tree in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        runs[label].append(turn(tree, args))
    print(json.dumps({"device": smi, "hidden": args.hidden, "shape": f"{args.rows}x{args.points}",
                      "other_tree": str(other),
                      **{f"{k}_ms": [r["ms"] for r in v] for k, v in runs.items()},
                      "plain_ms": runs["this"][0]["plain_ms"],
                      "bound_ms": runs["this"][0]["bound_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
