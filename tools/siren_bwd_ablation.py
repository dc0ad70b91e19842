#!/usr/bin/env python3
"""Where the SIREN training backward's time goes, on one H100.

    python3 tools/siren_bwd_ablation.py [--forward] [--out DIR]

Builds ``confild_tpu_torch/csrc/siren_decode_bwd.cu`` as committed and
patched copies of it and of the headers it includes (the chain's product
is ``csrc/siren_tc.cuh``'s), each changing one thing, into ``DIR`` (default
a temporary directory), then times ``ops.siren_decode.decode_bwd`` at Case4
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
to ``chip_smoke.py``'s float64 criterion at 4 x 16384 first.

With ``--forward`` it builds ``csrc/siren_decode.cu`` instead, as committed
and with the two patches of the shared product (``chain_bigbig``,
``chain_unsplit``), and times ``ops.siren_decode.decode_forward`` at Case4
width on 16 x 262144 pairs (a decoder chunk) in the same way, with the
forward kernel's device time; the committed build is held to the
criterion at Case2 width first.  Needs a CUDA card and ``nvcc``; imports
nothing of JAX.
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

BWD, FWD, TC = "siren_decode_bwd.cu", "siren_decode.cu", "siren_tc.cuh"

# name: (patches (file, old, new, count), held to the criterion)
VARIANTS = {
    "committed": ((), True),
    "sums_batch8": (((BWD, "constexpr int SBATCH = 32;", "constexpr int SBATCH = 8;", 1),),
                    True),
    "chain_bigbig": (((TC, CHAIN_PRODUCTS, BIG_BIG, 1),), False),
    "reduce_bigbig": (((BWD, REDUCE_PRODUCTS, BIG_BIG, 1),), False),
    "chain_unsplit": (((TC, CHAIN_SPLIT, "split<true>(a[", 4),), False),
}


def write_sources(src_dir: str, main: str, patches) -> str:
    """The source ``main`` and every header into ``src_dir``, patched;
    returns the source's path."""
    os.makedirs(src_dir, exist_ok=True)
    files = {p.name: p.read_text() for p in cuda_build.CSRC_DIR.glob("*.cuh")}
    files[main] = (cuda_build.CSRC_DIR / main).read_text()
    for name, old, new, count in patches:
        if files[name].count(old) != count:
            raise SystemExit(f"patch does not apply to {name} ({files[name].count(old)} "
                             f"matches): {old!r}")
        files[name] = files[name].replace(old, new)
    for name, text in files.items():
        with open(os.path.join(src_dir, name), "w") as f:
            f.write(text)
    return os.path.join(src_dir, main)


def build(out_dir: str, main: str, variants, declare) -> dict:
    """Every variant's library, its C signatures declared (``declare`` is
    the wrapper's loader), built in parallel."""
    procs = {}
    for name, (patches, _) in variants.items():
        src = write_sources(os.path.join(out_dir, name), main, patches)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
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
            libs[name] = declare.__wrapped__()
        finally:
            cuda_build.load = load
    return libs


def run_backward(out_dir: str) -> None:
    libs = build(out_dir, BWD, VARIANTS, sd._bwd_library)
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


def run_forward(out_dir: str) -> None:
    variants = {k: VARIANTS[k] for k in ("committed", "chain_bigbig", "chain_unsplit")}
    libs = build(out_dir, FWD, variants, sd._library)
    device = cs.resolve_device("cuda")
    cs.phase_device()
    model = cs.case4_decoder(device)
    coords, _, z, ops = cs.forward_case(model, device, 16, 262144, seed=3)
    names = list(variants)
    for i, name in enumerate(names + names[::-1]):
        sd._library = lambda _lib=libs[name]: _lib
        if i < len(names) and variants[name][1]:
            case2 = cs.SirenFilm(**cs.CASE2_CNF, generator=torch.Generator().manual_seed(2))
            cs.forward_check(case2.to(device).requires_grad_(False), device, 3, 3000, 5, name)
        with torch.no_grad():
            ms, least, largest = cs.cuda_median(lambda: sd.decode_forward(coords, z, *ops), 1)
            prof = cs.device_profile(name, lambda: sd.decode_forward(coords, z, *ops), top=0)
        dev = sum(v[0] for n, v in prof.items() if "siren_fwd_kernel" in n)
        cs.log(f"[ablation] forward {name}: median {ms:.3f} ms [{least:.3f}-{largest:.3f}]; "
               f"device {dev:.2f} ms; SM clock {cs.sm_clocks()}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--forward", action="store_true",
                        help="time the decode forward instead of the training backward")
    parser.add_argument("--out", help="build directory (default: a temporary one)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("siren_bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="siren_bwd_ablation_") as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        (run_forward if args.forward else run_backward)(out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
