#!/usr/bin/env python3
"""Where the SIREN training backward's reduction and sums spend their time,
on one H100.

    python3 tools/siren_bwd_ablation.py [--out DIR] [--variants a,b,...]
        [--hidden 384] [--points 262144]

Builds ``confild_tpu_torch/csrc/siren_decode_bwd.cu`` (the reduction, the
sums and the fold) as committed and patched copies of it, each changing one
thing, into ``DIR`` (default a temporary directory), then times
``ops.siren_decode.decode_bwd`` at Case4 width on 4 x 262144 pairs with each
build in turns (forward order, then backward), as the median of 7 calls
with the least and largest, and the device time of its chain (the cluster
chain of ``csrc/siren_chain_cluster.cu``, the same in every build),
reduction and sums kernels from ``torch.profiler``:

* ``committed``: the source as it is;
* ``sums_batch8``: the sums kernel with 8 loads in flight a thread, not 32;
* ``reduce_sub64``: the reduction's products on wgmma subtiles of 64
  columns at tiles of 128 too (two, their partials taking turns), not one
  of 128;
* ``reduce_bigbig``: the reduction's products as one TF32 ``wgmma`` (big *
  big) instead of three a k8 step, to time the tensor-core work;
* ``reduce_nosin``: its A fragments without ``sin2pi``;
* ``reduce_noimage``: its B image written for the first step only, not
  again for every step;
* ``reduce_noaload``: its A fragments loaded for the first K-slice only;
* ``reduce_bare``: no image and no A fragments made in the loop: the
  products, their carries and the barriers alone;
  ``reduce_bare_bigbig`` with one product a k8 step;
* ``reduce_noflush``: the running sum joins the slice's partial once, at
  the end, not every 512 pairs;
* ``reduce_ns2``: a ring of two raw stages, not three or four.

``sums_batch8`` and ``reduce_sub64`` are held to
``chip_smoke.py``'s float64 criterion at 4 x 16384 first; the other
``reduce_*`` variants are wrong on purpose and only timed.  ``--hidden H``
times a decoder 3 -> H x 16 -> 3 instead of Case4's, at ``--points``
points a row (262144 by default); ``--variants`` picks some
(``committed`` always runs).  The build prints the reduction's registers
and spills.  Needs a CUDA card and ``nvcc``; imports nothing of JAX.
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

BWD = "siren_decode_bwd.cu"

REDUCE_PRODUCTS = """    wgmma_n<SUBN>(d, as[kk], big, kk);
    wgmma_n<SUBN>(d, ab[kk], small, 1);
    wgmma_n<SUBN>(d, ab[kk], big, 1);"""
BIG_BIG = "    wgmma_n<SUBN>(d, ab[kk], big, kk);"
REDUCE_SIN = "ar[kk][e] = k < valid ? sin2pi(x) : 0.f;"
REDUCE_IMAGE = """          reduce_image<BN>(reinterpret_cast<const float*>(raw_n + RK * RA_LD * 4),
                           img + (sn & 1) * IMG, hi - q0 - RK);"""
REDUCE_LOAD_A1 = "          reduce_load_a(ar, rawA, arow, t, 1, hi - q0);"
REDUCE_LOAD_A0 = ("          reduce_load_a(ar, reinterpret_cast<const float*>(raw_n), arow, t, 0, "
                  "hi - q0 - RK);")
REDUCE_SUBTILES = "constexpr int SUBN_192 = 64, SUBN_128 = 128;"

REDUCE_FLUSH = "if ((s + 1) % RSEG == 0 || s + 1 == steps) {"
# name: (patches (file, old, new, count), held to the criterion)
VARIANTS = {
    "committed": ((), True),
    "sums_batch8": (((BWD, "constexpr int SBATCH = 32;", "constexpr int SBATCH = 8;", 1),),
                    True),
    "reduce_bigbig": (((BWD, REDUCE_PRODUCTS, BIG_BIG, 1),), False),
    "reduce_nosin": (((BWD, REDUCE_SIN, "ar[kk][e] = k < valid ? x : 0.f;", 1),), False),
    "reduce_noimage": (((BWD, REDUCE_IMAGE, "", 1),), False),
    "reduce_sub64": (((BWD, REDUCE_SUBTILES, "constexpr int SUBN_192 = 64, SUBN_128 = 64;", 1),),
                     True),
    "reduce_noaload": (((BWD, REDUCE_LOAD_A1, "", 1), (BWD, REDUCE_LOAD_A0, "", 1)), False),
    "reduce_bare": (((BWD, REDUCE_IMAGE, "", 1), (BWD, REDUCE_LOAD_A1, "", 1),
                     (BWD, REDUCE_LOAD_A0, "", 1)), False),
    "reduce_bare_bigbig": (((BWD, REDUCE_IMAGE, "", 1), (BWD, REDUCE_LOAD_A1, "", 1),
                            (BWD, REDUCE_LOAD_A0, "", 1), (BWD, REDUCE_PRODUCTS, BIG_BIG, 1)),
                           False),
    "reduce_noflush": (((BWD, REDUCE_FLUSH, "if (s + 1 == steps) {", 1),), False),
    "reduce_ns2": (((BWD, "  int ns = 4;\n  while (ns > 2 && ALIGN + ns * raw_bytes(BN)",
                     "  int ns = 2;\n  while (ns > 2 && ALIGN + ns * raw_bytes(BN)", 1),), False),
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
        reduce = False
        for line in log.splitlines():   # the reduction's registers and spills, wgmma warnings
            if "Function properties" in line or "Compiling entry" in line:
                reduce = "siren_bwd_reduce" in line
            if ("wgmma" in line and "arning" in line) or (reduce and ("spill" in line
                                                                    or "registers" in line)):
                print(f"[ablation] {name}: {line.strip()}", flush=True)
        load = cuda_build.load
        cuda_build.load = lambda _n, _p=os.path.join(out_dir, f"{name}.so"): ctypes.CDLL(_p)
        try:
            libs[name] = declare.__wrapped__()
        finally:
            cuda_build.load = load
    return libs


def run_backward(out_dir: str, variants: dict, hidden: int, points: int) -> None:
    libs = build(out_dir, BWD, variants, sd._bwd_library)
    device = cs.resolve_device("cuda")
    cs.phase_device()
    model = (cs.case4_decoder(device) if hidden == 384
             else cs.check_decoder(device, 3, 3, 15, hidden)[0])
    coords, _, g, z, ops, _, _ = cs.bwd_case(model, device, 4, points, seed=14)
    names = list(variants)
    for i, name in enumerate(names + names[::-1]):
        sd._bwd_library = lambda _lib=libs[name]: _lib
        if i < len(names) and variants[name][1]:
            cs.bwd_check(model, device, 4, 16384, seed=13, chunk=1024)
        with torch.no_grad():
            ms, least, largest = cs.cuda_median(lambda: sd.decode_bwd(coords, z, g, *ops), 1)
            prof = cs.device_profile(name, lambda: sd.decode_bwd(coords, z, g, *ops), top=0)
        parts = {k: sum(v[0] for n, v in prof.items() if kernel in n)
                 for k, kernel in (("chain", cs.CHAIN_KERNEL), ("reduce", "siren_bwd_reduce_kernel"),
                                   ("sums", "siren_bwd_sums_kernel"))}
        cs.log(f"[ablation] {name}: median {ms:.3f} ms [{least:.3f}-{largest:.3f}]; device "
               + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
               + f" ms; SM clock {cs.sm_clocks()}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="build directory (default: a temporary one)")
    parser.add_argument("--hidden", type=int, default=384, help="hidden width (Case4: 384)")
    parser.add_argument("--points", type=int, default=262144, help="points a row (4 rows)")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma list of variants (committed always runs)")
    args = parser.parse_args()
    picked = ["committed"] + [v for v in args.variants.split(",") if v and v != "committed"]
    unknown = [v for v in picked if v not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    if not torch.cuda.is_available():
        print("siren_bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="siren_bwd_ablation_") as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        run_backward(out_dir, {v: VARIANTS[v] for v in picked}, args.hidden, args.points)
    return 0


if __name__ == "__main__":
    sys.exit(main())
