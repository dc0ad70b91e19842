#!/usr/bin/env python3
"""How long the port's CUDA sources take to build and to scan, on a
machine with the CUDA toolkit (an H100 host).

    python3 tools/nvcc_build_time.py

Builds every ``confild_tpu_torch/csrc/*.cu`` into a temporary directory,
one ``nvcc`` per source, all started together, twice: with
``cuda_build.NVCC_FLAGS`` (each nvcc optimising its kernels on every core,
``--split-compile=0``) and with the same flags without ``--split-compile``.
Prints each source's seconds and the wall of each build.  Then counts the
``HMMA`` instructions of every kernel of the first build's libraries
twice, one ``cuobjdump -sass`` a library and one a kernel on every core
(``chip_smoke.hmma_counts``), and prints both times and whether the counts
agree.  The last line is one JSON object with every figure.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from confild_tpu_torch.ops import cuda_build  # noqa: E402

SPLIT = "--split-compile=0"


def build(out: Path, flags) -> dict:
    """Every source built into ``out`` with ``flags``, all at once: each
    source's seconds and the wall."""
    names = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [cuda_build._nvcc(), *flags, "-o", str(out / f"{name}.so"),
         str(cuda_build.CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT) for name in names}
    seconds = {}
    while len(seconds) < len(procs):
        for name, proc in procs.items():
            if name not in seconds and proc.poll() is not None:
                if proc.returncode != 0:
                    raise SystemExit(f"nvcc failed for {name}.cu")
                seconds[name] = round(time.perf_counter() - t0, 1)
        time.sleep(0.1)
    return {"wall_s": round(time.perf_counter() - t0, 1), "per_source_s": seconds}


def main() -> int:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, flags in (("split", cuda_build.NVCC_FLAGS),
                             ("no_split", [f for f in cuda_build.NVCC_FLAGS if f != SPLIT])):
            out = Path(tmp) / label
            out.mkdir()
            report[label] = build(out, flags)
            print(f"build, {label}: {report[label]}", flush=True)
        libs = sorted((Path(tmp) / "split").glob("*.so"))
        t0 = time.perf_counter()
        whole = {}
        for lib in libs:
            whole.update(chip_smoke.hmma_in(subprocess.run(
                [tool, "-sass", str(lib)], capture_output=True, text=True,
                check=True).stdout))
        report["scan_whole_s"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        per_kernel = chip_smoke.hmma_counts(libs)
        report["scan_per_kernel_s"] = round(time.perf_counter() - t0, 1)
        report["scan_counts_agree"] = whole == per_kernel
        report["kernels"] = len(whole)
    print(f"HMMA scan of {report['kernels']} kernels: one cuobjdump a library "
          f"{report['scan_whole_s']} s in turn, one a kernel on every core "
          f"{report['scan_per_kernel_s']} s; counts agree: {report['scan_counts_agree']}")
    print(json.dumps(report))
    return 0 if report["scan_counts_agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
