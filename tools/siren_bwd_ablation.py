#!/usr/bin/env python3
"""Where the SIREN training backward's time goes, on one H100.

    python3 tools/siren_bwd_ablation.py [--out DIR]

Builds ``confild_tpu_torch/csrc/siren_decode_bwd.cu`` as committed and
patched copies of it, each changing one thing, into ``DIR`` (default a
temporary directory), then times ``ops.siren_decode.decode_bwd`` at Case4
width on 4 x 262144 pairs with each build in turns (forward order, then
backward), as the median of 7 calls with the least and largest, and the
device time of its chain, reduction and sums kernels from
``torch.profiler``:

* ``committed``: the source as it is;
* ``sums_batch8``: the sums kernel with 8 loads in flight a thread, not 32;
* ``chain_bigbig``, ``reduce_bigbig``: the chain's (the reduction's)
  products as one TF32 product (big * big) instead of three, to time the
  tensor-core work;
* ``chain_unsplit``: the chain's activations taken as TF32 as they are
  (no split into big and small halves when the A fragments load), to time
  the split.

The last three are wrong on purpose and only timed; the first two are held
to ``chip_smoke.py``'s float64 criterion at 4 x 16384 first.  Needs a CUDA
card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from confild_tpu_torch.ops import cuda_build  # noqa: E402
from confild_tpu_torch.ops import siren_decode as sd  # noqa: E402

CHAIN_PRODUCTS = """        mma3_into<false, false>(part, ab[0][mt], as[0][mt], bb[0], bs[0]);
        mma3_into<false, false>(part, ab[1][mt], as[1][mt], bb[1], bs[1]);"""
REDUCE_PRODUCTS = """          mma3_into<false, false>(part, ab[0][mt], as[0][mt], bb[0], bs[0]);
          mma3_into<false, false>(part, ab[1][mt], as[1][mt], bb[1], bs[1]);"""
BIG_BIG = """mma_tf32(part, ab[0][mt], bb[0]);
mma_tf32(part, ab[1][mt], bb[1]);"""
CHAIN_SPLIT = "split<false>(a["

# name: (patches (old, new, count), held to the criterion)
VARIANTS = {
    "committed": ((), True),
    "sums_batch8": ((("constexpr int SBATCH = 32;", "constexpr int SBATCH = 8;", 1),), True),
    "chain_bigbig": (((CHAIN_PRODUCTS, BIG_BIG, 1),), False),
    "reduce_bigbig": (((REDUCE_PRODUCTS, BIG_BIG, 1),), False),
    "chain_unsplit": (((CHAIN_SPLIT, "split<true>(a[", 4),), False),
}


def patched_source(patches) -> str:
    src = (cuda_build.CSRC_DIR / "siren_decode_bwd.cu").read_text()
    for old, new, count in patches:
        if src.count(old) != count:
            raise SystemExit(f"patch does not apply ({src.count(old)} matches): {old!r}")
        src = src.replace(old, new)
    return src


def build(out_dir: str) -> dict:
    """Every variant's library, its C signatures declared, built in
    parallel."""
    procs = {}
    for name, (patches, _) in VARIANTS.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(patched_source(patches))
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-o",
             os.path.join(out_dir, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        load = cuda_build.load
        cuda_build.load = lambda _n, _p=os.path.join(out_dir, f"{name}.so"): ctypes.CDLL(_p)
        try:
            libs[name] = sd._bwd_library.__wrapped__()
        finally:
            cuda_build.load = load
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="build directory (default: a temporary one)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("siren_bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="siren_bwd_ablation_") as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        libs = build(out_dir)
        device = cs.resolve_device("cuda")
        cs.phase_device()
        model = cs.case4_decoder(device)
        coords, _, g, z, ops, _, _ = cs.bwd_case(model, device, 4, 262144, seed=14)
        names = list(VARIANTS)
        for i, name in enumerate(names + names[::-1]):
            sd._bwd_library = lambda _lib=libs[name]: _lib
            if i < len(names) and VARIANTS[name][1]:
                cs.bwd_check(model, device, 4, 16384, seed=13)
            with torch.no_grad():
                ms, least, largest = cs.cuda_median(lambda: sd.decode_bwd(coords, z, g, *ops), 1)
                prof = cs.device_profile(name, lambda: sd.decode_bwd(coords, z, g, *ops), top=0)
            parts = {k: sum(v[0] for n, v in prof.items() if f"siren_bwd_{k}_kernel" in n)
                     for k in ("chain", "reduce", "sums")}
            cs.log(f"[ablation] {name}: median {ms:.3f} ms [{least:.3f}-{largest:.3f}]; device "
                   + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
                   + f" ms; SM clock {cs.sm_clocks()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
