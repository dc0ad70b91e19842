#!/usr/bin/env python3
"""The SIREN-FiLM kernels of two checkouts of the port on one card, in
turns: the other tree, this one, this one, the other.

    python3 tools/siren_compare.py OTHER_TREE [--kernels forward|chain|bwd|steps]
        [--decoder wide|case4] [--hidden 1024[,384,...]] [--rows 4[,16]]
        [--points 262144] [--sensors 1000]

Each turn is a process of its own that imports the tree it times (its
``chip_smoke.py`` and ``confild_tpu_torch``) and builds the libraries the
timed kernels need (the tree's narrow SIREN libraries where it routes the
width there, else its cluster ones), on ``recipes/cnf/case4.yml`` at each
``--hidden`` width: with ``--decoder wide`` its 5 outputs
(``chip_smoke.WIDE_CNF``'s decoder, seed 19), with ``case4`` Case4's own 3
(``chip_smoke.CASE4_CNF``, 16 modulated layers).  ``--kernels forward``
times the float32 forward (``chip_smoke.forward_time``) at each ``--rows``
x ``--points``.  ``--kernels chain`` times dz (``chip_smoke.dz_time``) at 384
x ``--sensors``, the guided step's operator, and the training backward
(``chip_smoke.bwd_time``) at 4 x 65536 (the CNF batch step of
``chip_smoke.py`` phase 19) and at each ``--rows`` x ``--points``; then one
more process a tree holds the float32 kernels at the narrow widths against
float64 (``chip_smoke.py`` phases 3, 4 and 7's Case4 shapes and phase 16a's
H = 448 and 512 decoders) and prints both trees' errors side by side.
``--kernels bwd`` times the training backward alone (``chip_smoke.bwd_time``)
on fixed shapes, with its chain's, reduction's and sums' device times:
Case4's decoder at H = 384, 128, 256 and 512 and the wide recipe's 3 ->
1024 x 16 -> 5 at 4 x 262144, and six modulated layers of 3072 (3 -> 5) at
4 x 65536.  ``--kernels steps`` times what the Case4 users wait on (one process a tree
in turns, as above): phase 9's CNF batch step (``CNFTrainer._run_epoch`` on
one batch of 4 x 262144 with its decoder step, median of 5) and phase 6's
guided step at 1024 sensors with the operator on the kernels (median of 3
steps), each with its device time from ``torch.profiler``.  Each kernel
timing is a median of 3 with the SM clocks, each kernel's device time, the
plain version's time and the bound.  Prints each turn's lines and last one
JSON object with each tree's medians.  Needs an H100 and the CUDA toolkit.
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
decoder, hidden = sys.argv[1], [int(h) for h in sys.argv[2].split(",")]
rows, points, sensors = [int(r) for r in sys.argv[3].split(",")], int(sys.argv[4]), int(sys.argv[5])
# a tree that routes a width to its narrow kernels (H <= its NARROW_HIDDEN)
# builds them (and, for the timing's stream reckoning, the backward
# library); a width on the cluster kernels builds those
narrow = any(h <= getattr(sd, "NARROW_HIDDEN", 0) for h in hidden)
cuda_build.build_all([n for n in FAMILY_LIBS + (("siren_decode", "siren_decode_bwd") if narrow
                                                 else ())
                      if (cuda_build.CSRC_DIR / f"{n}.cu").exists()])
device = cs.resolve_device("cuda")


def decoder_at(h):
    cfg = dict(cs.WIDE_CNF if decoder == "wide" else cs.CASE4_CNF, hidden_features=h)
    seed = 19 if decoder == "wide" else 1
    return SirenFilm(**cfg, generator=torch.Generator().manual_seed(seed)).to(
        device).requires_grad_(False)
"""

TURNS = {
    "forward": "FAMILY_LIBS = ('siren_fwd_cluster',)\n" + HEAD + r"""
out = {}
for h in hidden:
    model = decoder_at(h)
    for r in rows:
        out[f"forward@H{h}@{r}x{points}"] = cs.forward_time(model, device, r, points, 38,
                                                            repeats=3)
""",
    "chain": "FAMILY_LIBS = ('siren_decode_bwd', 'siren_chain_cluster')\n" + HEAD + r"""
out = {}
with torch.no_grad():
    for h in hidden:
        model = decoder_at(h)
        out[f"dz@H{h}@384x{sensors}"] = cs.dz_time(model, device, 384, sensors, 40, repeats=3)
        for r, p in sorted({(4, 65536)} | {(r, points) for r in rows}):
            out[f"bwd@H{h}@{r}x{p}"] = cs.bwd_time(model, device, r, p, seed=39, repeats=3)
""",
    "bwd": "FAMILY_LIBS = ('siren_decode_bwd', 'siren_chain_cluster')\n" + HEAD + r"""
import re
lines, log = [], cs.log
cs.log = lambda msg: (lines.append(msg), log(msg))
# Case4's decoder at 384 and at the narrow plans, the wide recipe's 1024 x
# 16 -> 5 (4 x 262144), and six layers of 3072 (4 x 65536, phase 19's)
shapes = [(f"case4@H{h}", lambda h=h: SirenFilm(**dict(cs.CASE4_CNF, hidden_features=h),
                                                generator=torch.Generator().manual_seed(1)),
           262144) for h in (384, 128, 256, 512)]
shapes += [("wide@H1024", lambda: SirenFilm(**dict(cs.WIDE_CNF, hidden_features=1024),
                                            generator=torch.Generator().manual_seed(19)),
            262144),
           ("six@H3072", lambda: cs.check_decoder(device, 3, 5, 5, 3072)[0], 65536)]
out = {}
with torch.no_grad():
    for key, make, p in shapes:
        model = make().to(device).requires_grad_(False)
        del lines[:]
        out[f"bwd@{key}@4x{p}"] = r = cs.bwd_time(model, device, 4, p, seed=39, repeats=3)
        for part in ("chain", "reduce", "sums"):
            found = [float(m.group(1)) for m in (
                re.match(rf"\[bwd-time\] {part}: ([0-9.]+) ms device", x) for x in lines) if m]
            r[f"{part}_device_ms"] = found[0]
        del model
        torch.cuda.empty_cache()
""",
    "steps": "FAMILY_LIBS = ('siren_fwd_cluster', 'siren_decode_bwd', 'siren_chain_cluster')\n"
    + HEAD + r"""
import os, tempfile
import numpy as np
from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.cli import sample_conditional
from confild_tpu_torch.guidance import (create_sampler, get_conditioning_method, get_noise,
                                        get_operator)
from confild_tpu_torch.train.cnf_trainer import CNFTrainer
root = tempfile.mkdtemp()
out = {}


def timed(label, fn, calls):
    ms = cs.cuda_median(fn, calls, repeats=5 if calls == 1 else 1)[0]
    dev = sum(v[0] for v in cs.device_profile(label, fn, top=4).values())
    cs.log(f"[steps] {label}: {ms:.1f} ms a step, {dev:.1f} ms device under the profiler")
    return {"ms": ms, "device_ms": dev}


# phase 9's CNF batch step: one batch of 4 x 262144 and the decoder step
tr = CNFTrainer(cfgmod.basic_input(cs.write_training_case(
    os.path.join(root, "train"), n_snapshots=4, points=262144, epochs=1)))
tr.init_state(seed=0)
tr._schedules_cache = tr._schedules()
out["cnf_batch_step"] = timed("CNF batch step, Case4 4x262144",
                              lambda: tr._run_epoch(np.arange(4)[None], 1, False), 1)
del tr
torch.cuda.empty_cache()
# phase 6's guided step at 1024 sensors, the operator on the kernels
T, L = cs.CASE4_RECIPE["time_length"], cs.CASE4_RECIPE["latent_size"]
assets = cs.write_assets(root, 1024)
hp = cfgmod.basic_input(assets)
model, _ = sample_conditional.build_model_and_diffusion(hp)
model = sample_conditional.load_unet(hp.ema_path, model).to(device).eval().requires_grad_(False)
sampler = create_sampler(steps=hp.steps, noise_schedule=hp.noise_schedule,
                         timestep_respacing=hp.timestep_respacing)
gen = torch.Generator(device=device).manual_seed(11)
x_prev = 0.5 * torch.randn((1, 1, T, L), generator=gen, device=device)
noise = torch.randn((1, 1, T, L), generator=gen, device=device)
t = torch.full((1,), 1, dtype=torch.long)
y = torch.as_tensor(np.load(assets["sensor_measures"]), device=device)
op = get_operator("case4", coords_path=assets["sensor_coords"], max_val_path=hp.data_max,
                  min_val_path=hp.data_min, normalizer_params_path=hp.cnf_normalizer,
                  ckpt_path=hp.cnf_checkpoint, device=device)
op.use_pallas = True
method = get_conditioning_method("ps", op, get_noise("gaussian", sigma=0.0), scale=1.0)
out["guided_step_1024"] = timed(
    "guided step, Case4, 1024 sensors, forward + dz kernels",
    lambda: sampler._one_step(model, x_prev, t, y, method, noise=noise,
                              measurement_noise=torch.zeros_like(y)), 3)
""",
}
TAIL = r"""
print("TURN " + json.dumps({k: {n: v[n] for n in ("ms", "plain_ms", "bound_ms", "device_ms",
                                                   "chain_device_ms", "reduce_device_ms",
                                                   "sums_device_ms")
                                if n in v} for k, v in out.items()}))
"""

ERRORS = "FAMILY_LIBS = ('siren_fwd_cluster', 'siren_decode_bwd', 'siren_chain_cluster')\n" + \
    HEAD + r"""
model = cs.case4_decoder(device)
errs = {f"forward case4 {r}x{p}": cs.forward_check(model, device, r, p, s, "case4")
        for r, p, s in ((16, 262144, 3), (4, 262144, 4))}
errs.update({f"dz case4 {r}x{p}": cs.dz_check(model, device, r, p, 5, "case4",
                                              against_bwd=p == 1024)
             for r, p in ((384, 10), (384, 1024), (100, 3000))})
errs["bwd case4 4x262144"] = cs.bwd_check(model, device, 4, 262144, seed=14)
errs["bwd case4 4x16384"] = cs.bwd_check(model, device, 4, 16384, seed=13)
for h, cfg in cs.WIDE_CNFS.items():
    m = SirenFilm(**cfg, generator=torch.Generator().manual_seed(h)).to(device).requires_grad_(False)
    errs[f"forward H={h} 4x16384"] = cs.forward_check(m, device, 4, 16384, 21, f"H={h}")
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
        if line.startswith(("[forward", "[dz", "[bwd", "[profile]", "[steps]")):
            print(f"[{tree.name}] {line}", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: the turn failed\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.rsplit("TURN ", 1)[1].splitlines()[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--kernels", choices=sorted(TURNS), default="chain")
    ap.add_argument("--decoder", choices=("wide", "case4"), default="wide")
    ap.add_argument("--hidden", default="1024")
    ap.add_argument("--rows", default="4")
    ap.add_argument("--points", type=int, default=262144)
    ap.add_argument("--sensors", type=int, default=1000)
    args = ap.parse_args()
    other = args.other.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    argv = (args.decoder, args.hidden, args.rows, args.points, args.sensors)
    script = TURNS[args.kernels] + TAIL
    runs = {"other": [], "this": []}
    for label, tree in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        runs[label].append(turn(tree, script, *argv))
    first = runs["this"][0]
    summary = {"device": smi, "kernels": args.kernels, "decoder": args.decoder,
               "hidden": args.hidden, "other_tree": str(other),
               **{f"{key}_{label}_ms": [r[key]["ms"] for r in rs]
                  for key in first for label, rs in runs.items()},
               **{f"{key}_{label}_{n}": [r[key][n] for r in rs]
                  for key in first for n in ("device_ms", "chain_device_ms", "reduce_device_ms",
                                             "sums_device_ms")
                  if n in first[key] for label, rs in runs.items()},
               **{f"{key}_{n}": first[key][n] for key in first for n in ("plain_ms", "bound_ms")
                  if n in first[key]}}
    if args.kernels == "chain":
        errors = {label: turn(tree, ERRORS, *argv) for label, tree in (("other", other),
                                                                      ("this", HERE))}
        summary.update(errors=errors, errors_equal=errors["other"] == errors["this"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
