#!/usr/bin/env python3
"""The SIREN-FiLM kernels of two checkouts of the port on one card, in
turns: the other tree, this one, this one, the other.

    python3 tools/siren_compare.py OTHER_TREE [--kernels forward|chain]
        [--hidden 1024] [--rows 4] [--points 262144]

Each turn is a process of its own that imports the tree it times (its
``chip_smoke.py`` and ``confild_tpu_torch``) and builds the libraries the
timed kernels need at that width, on ``recipes/cnf/case4.yml`` at
``--hidden`` units and 5 outputs (``chip_smoke.WIDE_CNF``'s decoder, seed
19).  ``--kernels forward`` times the float32 forward
(``chip_smoke.forward_time``; ``siren_fwd_cluster`` above H = 512 where
the tree has it, else ``siren_decode`` and, for the timing's stream
reckoning, ``siren_decode_bwd``) at ``--rows`` x ``--points``.
``--kernels chain`` times dz (``chip_smoke.dz_time``) at 384 x 1000, the
guided step's operator at 1000 sensors, and the training backward
(``chip_smoke.bwd_time``) at 4 x 65536, the CNF batch step of
``chip_smoke.py`` phase 19, and at 4 x 262144 (``siren_decode_bwd``, and
``siren_chain_cluster`` where the tree has it); then one more process a
tree holds the narrow chain (H <= 512, which the cluster chain leaves
alone) to the other tree's: dz and the training backward against float64
at Case4 (``chip_smoke.py`` phases 4 and 7's shapes) and at H = 448 and 512
(phase 16a's), every returned error compared exactly.  Each timing is a
median of 3 with the SM clocks, each kernel's device time, the plain
version's time and the bound.  Prints each turn's lines and last one JSON
object with each tree's medians.  Needs an H100 and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

HEAD = r"""
import json, sys, torch
import chip_smoke as cs
from confild_tpu_torch.models.cnf import SirenFilm
from confild_tpu_torch.ops import cuda_build, siren_decode as sd
h, rows, points = map(int, sys.argv[1:4])
"""

MODEL = r"""
device = cs.resolve_device("cuda")
model = SirenFilm(**dict(cs.WIDE_CNF, hidden_features=h),
                  generator=torch.Generator().manual_seed(19)).to(device).requires_grad_(False)
"""

TURNS = {
    "forward": HEAD + r"""
# a tree without the cluster kernel reckons its stream from the backward
# library's block size (chip_smoke.block_pairs): build both at once
cuda_build.build_all(["siren_fwd_cluster"] if h > getattr(sd, "NARROW_HIDDEN", 10 ** 9)
                     else ["siren_decode", "siren_decode_bwd"])
""" + MODEL + r"""
out = {f"forward@{rows}x{points}": cs.forward_time(model, device, rows, points, 38, repeats=3)}
""",
    "chain": HEAD + r"""
cuda_build.build_all([n for n in ("siren_decode_bwd", "siren_chain_cluster")
                      if (cuda_build.CSRC_DIR / f"{n}.cu").exists()])
""" + MODEL + r"""
with torch.no_grad():
    out = {"dz@384x1000": cs.dz_time(model, device, 384, 1000, 40, repeats=3)}
    for r, p in ((4, 65536), (4, 262144)):
        out[f"bwd@{r}x{p}"] = cs.bwd_time(model, device, r, p, seed=39, repeats=3)
""",
}
TAIL = r"""
print("TURN " + json.dumps({k: {n: v[n] for n in ("ms", "plain_ms", "bound_ms")}
                            for k, v in out.items()}))
"""

NARROW = r"""
import json, torch
import chip_smoke as cs
from confild_tpu_torch.models.cnf import SirenFilm
from confild_tpu_torch.ops import cuda_build
cuda_build.build_all(["siren_decode", "siren_decode_bwd"])
device = cs.resolve_device("cuda")
model = cs.case4_decoder(device)
errs = {f"dz case4 {r}x{p}": cs.dz_check(model, device, r, p, 5, "case4", against_bwd=p == 1024)
        for r, p in ((384, 10), (384, 1024), (100, 3000))}
errs["bwd case4 4x262144"] = cs.bwd_check(model, device, 4, 262144, seed=14)
errs["bwd case4 4x16384"] = cs.bwd_check(model, device, 4, 16384, seed=13)
for h, cfg in cs.WIDE_CNFS.items():
    m = SirenFilm(**cfg, generator=torch.Generator().manual_seed(h)).to(device).requires_grad_(False)
    errs[f"dz H={h} 64x1024"] = cs.dz_check(m, device, 64, 1024, 24, f"H={h}", against_bwd=True)
    errs[f"dz H={h} 100x3000"] = cs.dz_check(m, device, 100, 3000, 25, f"H={h}")
    errs[f"bwd H={h} 4x16384"] = cs.bwd_check(m, device, 4, 16384, seed=26)
print("TURN " + json.dumps(errs))
"""


def turn(tree: Path, script: str, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", script, *map(str, args)], cwd=tree, env=env,
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith(("[forward", "[dz", "[bwd", "[profile]")):
            print(f"[{tree.name}] {line}", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: the turn failed\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.rsplit("TURN ", 1)[1].splitlines()[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--kernels", choices=sorted(TURNS), default="chain")
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--points", type=int, default=262144)
    args = ap.parse_args()
    other = args.other.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    script = TURNS[args.kernels] + TAIL
    runs = {"other": [], "this": []}
    for label, tree in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        runs[label].append(turn(tree, script, args.hidden, args.rows, args.points))
    first = runs["this"][0]
    summary = {"device": smi, "kernels": args.kernels, "hidden": args.hidden,
               "other_tree": str(other),
               **{f"{key}_{label}_ms": [r[key]["ms"] for r in rs]
                  for key in first for label, rs in runs.items()},
               **{f"{key}_plain_ms": first[key]["plain_ms"] for key in first},
               **{f"{key}_bound_ms": first[key]["bound_ms"] for key in first}}
    if args.kernels == "chain":
        errors = {label: turn(tree, NARROW) for label, tree in (("other", other), ("this", HERE))}
        summary.update(narrow_errors=errors,
                       narrow_errors_equal=errors["other"] == errors["this"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
