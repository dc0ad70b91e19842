#!/usr/bin/env python3
"""Where the bf16 SIREN-FiLM cluster forward spends its time, on one H100.

    python3 tools/siren_bf16_ablation.py [--out DIR] [--variants a,b,...]
        [--hidden 384,1024] [--rows 4] [--points 262144]

Builds ``confild_tpu_torch/csrc/siren_fwd_cluster.cu`` (with the shared
``siren_cluster.cuh``) as committed and patched copies of it, each changing
one thing in the bf16 forward's product (``Consumer::product16``), into
``DIR`` (default a temporary directory), then times
``ops.siren_decode.decode_forward(..., compute_dtype=torch.bfloat16)`` on a
decoder 3 -> H x 16 -> 3 (Case4's at 384, seed 1) at ``--rows`` x
``--points`` with each build in turns (forward order, then backward), as
the median of 5 calls with the least and largest and the bf16 forward's
device time from ``torch.profiler``:

* ``committed``: the source as it is;
* ``noaload``: A loaded for the first batch of K-slices only, not again;
* ``nomma``: no ``wgmma`` (the loads, the ring and the barriers alone);
* ``n64``: a K-slice's product as m64n64k16 ``wgmma`` on each 64 columns
  of the warpgroup's, not one m64nNk16 on all N;
* ``nofill``: the ring filled once at the start and never refilled (the
  stages' mbarriers waited for only then): no weight stream from L2;
* ``bare``: ``noaload`` and ``nofill`` together: the products and the
  epilogue alone;
* ``nofirst``: no first layer (the shares start as they are);
* ``nohead``: no head partials (block 0 sums what the table holds);
* ``noepi``: the epilogue adds the FiLM row but applies no ``sin2pi``;
* ``nobar``: no cluster barrier between the layers (the last ones, which
  keep a block's shared memory alive while others read it, stay);
* ``ns8``: a ring of eight stages, the fewest that hold two batches of
  K-slices, not up to 16 (fewer would deadlock: a batch's stages are
  released only after the next batch is issued).

Only ``committed``, ``n64`` and ``ns8`` compute the forward; the others are wrong on
purpose and only timed.  Every variant waits for the same barriers in every
thread, so none can hang the card.  ``--variants`` picks some (``committed`` always
runs).  The build prints any ``wgmma`` warning.  Needs a CUDA card and
``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import siren_bwd_ablation as ab  # noqa: E402
from confild_tpu_torch.models.cnf import SirenFilm  # noqa: E402
from confild_tpu_torch.ops import siren_decode as sd  # noqa: E402

HDR = "siren_cluster.cuh"
LOAD_NEXT = "    if (b + 1 < nb) load_batch(a[B ^ 1], b + 1, src);"
MMA = """      wgmma_bf16_wide<N_WG>(*reinterpret_cast<float(*)[NSUB * 32]>(&acc[0][0]), f,
                            b_desc(sb + n_off * 32), b > 0 || k > 0);"""
N64 = """#pragma unroll
      for (int j = 0; j < NSUB; ++j)
        wgmma_bf16(acc[j], f, b_desc(sb + (n_off + 64 * j) * 32), b > 0 || k > 0);"""
REFILL = "    if (v + NS < u_total) fill(second, v + NS);"
WAIT = "      mbar_wait(full0 + 8 * s, (v / NS) & 1);"
WAIT_FIRST = "      if (v < NS) mbar_wait(full0 + 8 * s, (v / NS) & 1);"
NOFILL = ((HDR, REFILL, "    (void)second;", 1), (HDR, WAIT, WAIT_FIRST, 1))
NOALOAD = ((HDR, LOAD_NEXT, "", 1),)
FWD = "siren_fwd_cluster.cu"
FIRST = "    first_layer16<S, P, LDS>(share, cs, zrow, w_first, z, rank, H, C_in);"
HEAD = """  for (int i = threadIdx.x; i < P * C_out; i += THREADS) {
    const int p = i / C_out, o = i % C_out;"""
EPI = """        a[j][i] = sin2pi(a[j][i] + zz.x);
        a[j][i + 1] = sin2pi(a[j][i + 1] + zz.y);"""
BARS = ((FWD, "      cluster_sync();   // every block's buffer of layer l written", "", 1),)
# name: (patches (file, old, new, count), computes the forward)
VARIANTS = {
    "committed": ((), True),
    "noaload": (NOALOAD, False),
    "nomma": (((HDR, MMA, "", 1),), False),
    "n64": (((HDR, MMA, N64, 1),), True),
    "nofill": (NOFILL, False),
    "bare": (NOALOAD + NOFILL, False),
    "nofirst": (((FWD, FIRST, "    (void)0;", 1),), False),
    "nohead": (((FWD, HEAD, HEAD.replace("P * C_out", "0"), 1),), False),
    "noepi": (((FWD, EPI, EPI.replace("sin2pi(a[j][i] + zz.x)", "a[j][i] + zz.x")
                .replace("sin2pi(a[j][i + 1] + zz.y)", "a[j][i + 1] + zz.y"), 1),), False),
    "nobar": (BARS, False),
    "ns8": (((HDR, "  int ns = bf16 ? 16 : 4;", "  int ns = bf16 ? 8 : 4;", 1),), True),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="build directory (default: a temporary one)")
    parser.add_argument("--hidden", default="384,1024", help="comma list of hidden widths")
    parser.add_argument("--rows", type=int, default=4)
    parser.add_argument("--points", type=int, default=262144)
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma list of variants (committed always runs)")
    args = parser.parse_args()
    picked = ["committed"] + [v for v in args.variants.split(",") if v and v != "committed"]
    unknown = [v for v in picked if v not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    if not torch.cuda.is_available():
        print("siren_bf16_ablation: no CUDA device", file=sys.stderr)
        return 1
    device = cs.resolve_device("cuda")
    cs.phase_device()
    with tempfile.TemporaryDirectory(prefix="siren_bf16_ablation_") as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        libs = ab.build(out_dir, "siren_fwd_cluster.cu", {v: VARIANTS[v] for v in picked},
                        sd._cluster_library)
        for h in (int(x) for x in args.hidden.split(",")):
            model = SirenFilm(**dict(cs.CASE4_CNF, hidden_features=h),
                              generator=torch.Generator().manual_seed(1)).to(
                device).requires_grad_(False)
            coords, _, z, ops = cs.forward_case(model, device, args.rows, args.points, 3)
            fn = lambda: sd.decode_forward(coords, z, *ops, compute_dtype=torch.bfloat16)
            ref = None
            for i, name in enumerate(picked + picked[::-1]):
                sd._cluster_library = lambda _lib=libs[name]: _lib
                with torch.no_grad():
                    if i < len(picked) and VARIANTS[name][1]:
                        out = fn()
                        ref = out if ref is None else ref
                        cs.log(f"[ablation] H={h} {name}: against committed, max abs "
                               f"{(out - ref).abs().max().item():.3e}")
                    ms, least, largest = cs.cuda_median(fn, 1, repeats=5)
                    prof = cs.device_profile(f"H={h} {name}", fn, top=0)
                dev = sum(v[0] for k, v in prof.items() if cs.BF16_FWD_KERNEL in k)
                cs.log(f"[ablation] H={h} {args.rows}x{args.points} {name}: median {ms:.3f} ms "
                       f"[{least:.3f}-{largest:.3f}]; bf16 forward device {dev:.3f} ms; SM clock "
                       f"{cs.sm_clocks()}")
            del model, coords, z, ops
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
