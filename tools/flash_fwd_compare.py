#!/usr/bin/env python3
"""The flash-attention kernels against another build of them, on one H100.

    python3 tools/flash_fwd_compare.py [--backward] [--parent DIR] [--variants a,b]
        [--no-checks] [--trap] [--wide-only] [--out DIR]

Builds ``confild_tpu_torch/csrc/flash_attention.cu`` as it stands and, with
``--parent``, the same file of another checkout (``DIR`` is its root, for
example a ``git archive`` of the parent commit), each with ``nvcc`` into
``--out`` (default a temporary directory; all builds at once, one nvcc
each), and prints each build's ptxas
report and ``cuobjdump -sass`` tensor-core instruction counts
(``HMMA``, ``HGMMA``) of every flash kernel instantiation, and this build's
plans (the library's beside the wrapper's mirror).  Then:

* unless ``--no-checks``: ``chip_smoke.py`` phase 10's checks of the
  kernels against their plain versions and float64 at every
  ``FLASH_CHECKS`` shape (forward and backward, bitwise repeats, O(N)
  memory);
* the forward (default) or, with ``--backward``, the two backward kernels
  (dq, dk/dv) at (64, 144, 64), (16, 9216, 64), (4, 16384, 64) in float32
  and bf16 and at phase 18 (d)'s classifier shapes in float32 (the forward
  also above 128, ``WIDE_SHAPES``: (8, 144, 512), (8, 9216, 256) and (4,
  9216, 512) in both types, where up to 512 bf16 is the TMA forward and
  float32 the forward with Q resident): each build's
  library called directly on the same tensors (its C entry points), in
  turns (parent and variants, this, this, then variants and parent again),
  median of 7 separately timed runs of back-to-back calls (20 below 1000
  tokens), with ``scaled_dot_product_attention``'s (its forward, or its
  backward alone) on both layouts and the bound beside; for the backward
  below 1000 tokens also each build's device time of the pair a call
  (torch.profiler), where the events time the host;
* for the forward, the wrapper's host time a call at (64, 144, 64)
  (``chip_smoke.py``'s ``forward_host_us``), and where ``DIR`` holds the
  other checkout's ``ops/flash_attention.py``, its wrapper's beside this
  one's in turns, each launching its own build: host microseconds a call
  and the event median of 20 back-to-back calls, beside SDPA's.

``--variants`` adds ablations of this tree's source, each timed beside it
(never checked: their results are wrong on purpose): for the forward
``noexp`` multiplies where the softmax exponentiates (in every forward),
``noimage`` has the producer write no operand images (it still waits and
signals), ``nosoftmax`` sends S to P.V as it is, and for the bf16 TMA
forward ``tma_nos`` skips S = Q K^T (S is zero) and ``tma_nopv`` skips
O += P V (its copies still land and are waited for); for the backward
``bwd_noimage`` has both passes' producers write no images (nor lse and
delta).  The ``--parent`` build of the commit before the TMA forward is
its thread-pass ablation: the column-group kernel, whose producer's
threads load and write every operand image.

``--wide-only`` checks and times only above 128 (``FLASH_WIDE_CHECKS``,
then ``WIDE_SHAPES``: the forward in both types, or with ``--backward``
the backward pair in both types, the bf16 TMA pair and the float32 pair
with the resident rows at 256 and 512, with its device time at 144
tokens); ``tmab_nos`` skips the TMA backward's S and S^T,
``tmab_noout`` its products into dQ, dV and dK (their copies still land),
and ``tmab_serial`` waits for a tile's product into the output before the
next tile's S and dP are issued (right results); ``wq_noproducer`` and
``wq_nopv`` ablate the float32 forward with Q resident (its producer's
items, or the products of its P V_g), and ``wq_ahead2`` / ``wq_ahead3``
keep its producer's loads 2 or 3 items ahead in place of 1.  The float32
backward with the resident rows (D = 256, 384, 512): ``wqb_noproducer``
writes no item (nor loads one: neither the S warpgroup its own chunks nor
the producer the output warpgroup's), ``wqb_noout`` skips the products
into dQ_g, dV_g and dK_g (their items still taken and released),
``wqb_outahead`` issues each sub-group's output product before the one
before it is waited for (``OUT_AHEAD`` on), ``wqb_onetile`` holds the S
warpgroup's next tile until the output warpgroup has taken this tile's P
(the next tile's S no longer runs under this tile's dP, only under its
products into the output), ``wqb_ahead2`` keeps its
producer's loads two items ahead in place of one, and ``wqb_aglobal``
loads the A fragments of dP's second operand at 384 and 512 (dq's dO,
dk/dv's V) from global memory each k16 step in place of the producer's
raw items (the last four right results).

``--trap`` builds this tree's source with every mbarrier wait bounded: a
wait that spins past about 2^26 polls gives up and sets a flag, every
wait after it gives up within 1024 polls, and the tool fails the call
when a build's flag is set, so a wrong barrier phase fails the call
instead of hanging the card (a trap instruction in the wait made ptxas
hold the float32 backward's setmaxnreg regions to 168 registers, and
spill).  Before
any launch the tool refuses a build whose forward, or a backward
instantiation with two consumer warpgroups, does not start at 168
registers a thread (the block's 384 threads' share, which the warpgroups'
``setmaxnreg`` moves between them; the float32 pair above 128 too).  Needs a CUDA card and ``nvcc``;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from confild_tpu_torch.ops import cuda_build  # noqa: E402
from confild_tpu_torch.ops import flash_attention as fa  # noqa: E402

TRAP_WAIT = '''__device__ unsigned int mbar_wait_gave_up = 0;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\\n.reg .pred p;\\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
        "selp.u32 %0, 1, 0, p;\\n}\\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (++polls & 1023u) == 0) {
      if (polls > (1u << 26)) atomicExch(&mbar_wait_gave_up, 1u);
      if (*(volatile unsigned int*)&mbar_wait_gave_up) return;
    }
  } while (!done);
}
extern "C" int mbar_wait_gave_up_flag() {
  unsigned int x = 0;
  cudaMemcpyFromSymbol(&x, mbar_wait_gave_up, sizeof x);
  return (int)x;
}'''


# Ablations: each cuts one cost of the forward out of a copy of this tree's
# source (wrong results on purpose; timed, never checked).  Every variant
# waits on the same barriers in every thread, so none can hang the card.
VARIANTS = {
    # exponentials: the softmax multiplies where it exponentiates
    "noexp": [(r"s\[i\] = ex2\(fmaf\(s\[i\], scale2, neg\[\(i >> 1\) & 1\]\)\);",
               "s[i] = fmaf(s[i], scale2, neg[(i >> 1) & 1]) * 0.5f;")],
    # the producer's images: it waits and signals, writing nothing
    "noimage": [(r"build_images<D, T>\(rk, rv, stage, valid, ptid\);", "")],
    # the backward's producers: they wait and signal, writing nothing
    "bwd_noimage": [(r"dq_images<P, D, T>\(rk, rv, stage, valid, ptid\);", ""),
                    (r"dkv_images<P, D, T>\(rq, ro, stage, valid, ptid\);", ""),
                    (r"if \(ptid < ST\) \{", "if (ptid < 0) {")],
    # the softmax: S goes to P.V as it is
    "nosoftmax": [(r"softmax_tile<KT>\((\w+), m, l, alpha, it \* KT, n, t, scale2\);",
                   "alpha[0] = alpha[1] = 1.f;")],
    # the TMA forward's products: S = Q K^T skipped (S zero), or O += P V
    "tma_nos": [(r"s_product<D, KT>\(sc, qa, kb\);",
                 "for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;")],
    "tma_nopv": [(r"pv_product<GW, KT>\(acc, sc, vb\);", "")],
    # the bf16 TMA backward: S and S^T skipped (each tile takes the values
    # the registers hold), or the products into the outputs (dQ_g, dV_g,
    # dK_g) skipped, every copy still landing and waited for; or each tile's
    # product into the output waited for before the next tile's S and dP
    # are issued (right results)
    "tmab_nos": [(r"tma::issue_s<D, ST, P::ROWS>\(s, [qk]a, [kq]b\);", ";")],
    "tmab_noout": [(r"tma::issue_pv<GW, ST>\(acc, pa, [^;]*\);", ";")],
    "tmab_serial": [(r"constexpr bool AHEAD = true;", "constexpr bool AHEAD = false;")],
    # the float32 forward with Q resident (D <= 512): its producer writes no
    # item (nor loads one), or its consumer skips the products of O += P V_g
    # (still taking and releasing V's items)
    "wq_noproducer": [(r"k_store\(stage, w, ptid\);", ";"),
                      (r"v_store\(stage, w, ptid\);", ";")],
    "wq_nopv": [(r"rs_tf32<SUB, KT, SUB>\(part, big, sm, vb, 0\);", "")],
    # its producer's loads 2 or 3 items ahead, not 1 (right results)
    "wq_ahead2": [(r"constexpr int LOAD_AHEAD = 1;", "constexpr int LOAD_AHEAD = 2;")],
    "wq_ahead3": [(r"constexpr int LOAD_AHEAD = 1;", "constexpr int LOAD_AHEAD = 3;")],
    # the float32 backward with the resident rows: no item written (the
    # loads, unused, go too); its output products skipped; dP's second
    # operand's A fragments from global memory (no raw items)
    "wqb_noproducer": [(r"wq::k_store\(stage, w, ptid\);", ";"),
                       (r"wq::v_store\(stage, w, ptid\);", ";"),
                       (r"a_copy<D>\(stage, [^;]*\);", ";")],
    "wqb_noout": [(r"rs_tf32<SUB, KT, SUB>\(part\[y\], big, sm, b, 0\);", "")],
    "wqb_aglobal": [(r"constexpr bool A_GLOBAL = false;", "constexpr bool A_GLOBAL = true;")],
    # its producer's loads 2 items ahead, not 1, and its output's products
    # two sub-groups in flight (right results)
    "wqb_ahead2": [(r"constexpr int LOAD_AHEAD = 1;   // items a producer keeps",
                    "constexpr int LOAD_AHEAD = 2;   // items a producer keeps")],
    "wqb_outahead": [(r"constexpr bool OUT_AHEAD = false;", "constexpr bool OUT_AHEAD = true;")],
    # the S warpgroup's next tile waits until the output warpgroup has taken
    # this tile's P (one slot in use: the next S no longer under this dP)
    "wqb_onetile": [(r"if \(tile >= 2\) mbar_wait\(sm\.p_empty \+ 8 \* slot, \(\(tile >> 1\) \+ 1\) & 1\);",
                     "if (tile >= 1) mbar_wait(sm.p_empty + 8 * (slot ^ 1), ((tile - 1) >> 1) & 1);")],
}

# the forward's shapes above 128: the one-head Case4 middle block at batch
# 8, the xl recipe's ds-8 block under num_heads 1 at batch 8, and four heads
# of 512 channels at 9216 tokens
WIDE_SHAPES = ((8, 144, 512), (8, 9216, 256), (4, 9216, 512))


def build(csrc: str, out_dir: str, tag: str, trap: bool = False,
          patches=()) -> tuple[str, str]:
    """``csrc/flash_attention.cu`` (with the headers beside it, ``patches``
    applied) into ``out_dir/tag.so``; returns the library path and nvcc's
    report."""
    src = os.path.join(out_dir, f"src_{tag}")
    shutil.copytree(csrc, src, dirs_exist_ok=True)
    if patches:
        path = os.path.join(src, "flash_attention.cu")
        text = open(path).read()
        for pattern, repl in patches:
            text, hits = re.subn(pattern, lambda _: repl, text)
            if hits == 0:
                raise SystemExit(f"{tag}: no match for {pattern}")
        open(path, "w").write(text)
    if trap:
        hdr = os.path.join(src, "hopper.cuh")
        text = open(hdr).read()
        text, hits = re.subn(r"__device__ __forceinline__ void mbar_wait\(.*?\n\}", lambda _: TRAP_WAIT,
                             text, flags=re.S)
        if hits != 1:
            raise SystemExit("could not bound mbar_wait in hopper.cuh")
        open(hdr, "w").write(text)
    lib = os.path.join(out_dir, f"{tag}.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(src, "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {tag}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def report(tag: str, lib: str, log: str) -> dict:
    """Registers and spills (ptxas) and HMMA / HGMMA counts of each flash
    kernel instantiation; returns ``{label: registers}``."""
    regs, kernel, spill = {}, None, ""
    for line in log.splitlines():
        if "wgmma" in line:   # ptxas serialising a kernel's wgmma, and why
            print(f"[{tag}] ptxas: {line.strip()}", flush=True)
        if "Function properties" in line:
            kernel = cs.kernel_label(line)
        elif "spill stores" in line:
            spill = re.sub(r"\s+", " ", line.strip())
        elif "registers" in line and kernel:
            if kernel.startswith("flash_"):
                regs[kernel] = int(re.search(r"Used (\d+) registers", line).group(1))
                print(f"[{tag}] {kernel}: {regs[kernel]} registers, {spill}", flush=True)
            kernel = None
    counts = cs.hmma_counts([lib])
    for k, v in sorted(counts.items()):
        if k.startswith("flash_"):
            print(f"[{tag}] {k}: {cs.tc_label(v)}", flush=True)
    return regs


def waits_gave_up(libs: dict) -> None:
    """Fails the call if a bounded mbarrier wait of a ``--trap`` build (the
    only ones with the flag) gave up."""
    for tag, lib in libs.items():
        flag = getattr(lib, "mbar_wait_gave_up_flag", None)
        if flag is not None and flag():
            raise SystemExit(f"{tag}: an mbarrier wait gave up (a wrong barrier phase)")


def setmaxnreg_ready(regs: dict, lib) -> None:
    """Refuses to go on unless all 18 flash instantiations at D <= 128 and
    the six float32 backward ones above exist and every forward one, every
    backward one at D <= 128 whose plan in ``lib`` (a build of this tree's
    source, declared) has two consumer warpgroups, and every float32
    backward one above 128 starts at 168 registers (its setmaxnreg moves
    them between the warpgroups)."""
    want = {}
    for d, dtype in cs.FLASH_FWD_INSTANCES:
        want[cs.flash_fwd_label(d, dtype)] = 168
        out = (ctypes.c_int * 12)()
        if lib.flash_backward_plan(d, 0 if dtype == torch.float32 else 1, out):
            raise SystemExit("flash_backward_plan failed")
        for i, kernel in enumerate(fa.BWD_KERNELS):
            want[cs.flash_bwd_label(kernel, d, dtype)] = 168 if out[6 * i + 1] == 2 else None
    for d in fa.TMA_WIDTHS:   # the float32 pair above 128: three warpgroups, setmaxnreg
        for kernel in fa.BWD_KERNELS:
            want[cs.flash_wide_bwd_label(d, kernel, torch.float32)] = 168
    wrong = {k: regs.get(k) for k, r in want.items()
             if k not in regs or (r is not None and regs[k] != r)}
    if wrong:
        raise SystemExit(f"refusing to launch: instantiations {wrong} (the forward's and the "
                         f"two-consumer backward's must start at 168 registers)")


def forward_call(lib, q, k, v):
    """A call of the library's forward on ready outputs (the device's work
    alone, the wrapper's host time apart)."""
    bh, n, d = q.shape
    out, lse = torch.empty_like(q), torch.empty((bh, n), device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, n, d,
            0 if q.dtype == torch.float32 else 1, 1.0 / d ** 0.5, fa._stream(q.get_device()))

    def call():
        err = lib.flash_forward(*args)
        if err:
            raise SystemExit(f"flash_forward failed with CUDA error {err}")
    return call


def compare(libs: dict, device, wide_only: bool = False) -> None:
    shapes = [] if wide_only else ([(s, torch.float32) for s in cs.FLASH_TIMES]
                                   + [(s, torch.bfloat16) for s in cs.FLASH_TIMES]
                                   + [(s, torch.float32) for s in cs.FLASH_CLASSIFIER_SHAPES])
    shapes += [(s, dtype) for s in WIDE_SHAPES for dtype in (torch.bfloat16, torch.float32)]
    others = [t for t in libs if t != "this"]
    order = others + ["this", "this"] + others[::-1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for (bh, n, d), dtype in shapes:
        q, k, v, _ = cs.flash_case(device, bh, n, d, dtype, seed=11)
        calls = 20 if n < 1000 else 1
        got = {}
        for tag in order:
            med, lo, hi = cs.cuda_median(forward_call(libs[tag], q, k, v), calls)
            got.setdefault(tag, []).append(f"{med:.4f} [{lo:.4f}-{hi:.4f}]")
        q4, k4, v4 = (t.reshape(1, bh, n, d) for t in (q, k, v))
        s3 = cs.cuda_median(lambda: sdpa(q, k, v), calls)[0]
        s4 = cs.cuda_median(lambda: sdpa(q4, k4, v4), calls)[0]
        b_ms, b_by = cs.forward_bound(bh, n, d, dtype)
        print(f"[compare] ({bh}, {n}, {d}) {str(dtype)[6:]} ms a call, median [least-largest] "
              f"of 7: " + "; ".join(f"{t} {', '.join(x)}" for t, x in got.items())
              + f"; sdpa {s3:.4f}, view {s4:.4f}; bound {b_ms:.4f} ({b_by})", flush=True)
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()


def backward_calls(lib, q, k, v, g, lse, delta):
    """Calls of the library's two backward kernels on ready outputs."""
    bh, n, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
              delta.data_ptr())
    tail = (bh, n, d, 0 if q.dtype == torch.float32 else 1, 1.0 / d ** 0.5,
            fa._stream(q.get_device()))

    def dq_call():
        err = lib.flash_bwd_dq(*common, dq.data_ptr(), *tail)
        if err:
            raise SystemExit(f"flash_bwd_dq failed with CUDA error {err}")

    def dkv_call():
        err = lib.flash_bwd_dkv(*common, dk.data_ptr(), dv.data_ptr(), *tail)
        if err:
            raise SystemExit(f"flash_bwd_dkv failed with CUDA error {err}")
    return dq_call, dkv_call


def compare_backward(libs: dict, device, wide_only: bool = False) -> None:
    shapes = [(s, dtype) for s in WIDE_SHAPES
              for dtype in (torch.bfloat16, torch.float32)] if wide_only else (
        [(s, torch.float32) for s in cs.FLASH_TIMES]
        + [(s, torch.bfloat16) for s in cs.FLASH_TIMES]
        + [(s, torch.float32) for s in cs.FLASH_CLASSIFIER_SHAPES])
    others = [t for t in libs if t != "this"]
    order = others + ["this", "this"] + others[::-1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for (bh, n, d), dtype in shapes:
        q, k, v, g = cs.flash_case(device, bh, n, d, dtype, seed=13)
        out, lse = fa.flash_forward(q, k, v)
        delta = fa._delta(out, g)
        calls = 20 if n < 1000 else 1
        got = {}
        for tag in order:
            dq_call, dkv_call = backward_calls(libs[tag], q, k, v, g, lse, delta)
            a = cs.cuda_median(dq_call, calls)
            b = cs.cuda_median(dkv_call, calls)
            text = (f"dq {a[0]:.4f} [{a[1]:.4f}-{a[2]:.4f}], dkv {b[0]:.4f} "
                    f"[{b[1]:.4f}-{b[2]:.4f}], pair {a[0] + b[0]:.4f}")
            if calls > 1:
                kernels = cs.device_profile(f"{tag} backward pair ({bh}, {n}, {d}) "
                                            f"{str(dtype)[6:]}, {calls} calls",
                                            lambda: [(dq_call(), dkv_call())
                                                     for _ in range(calls)], top=2)
                dev = sum(ms for name, (ms, _) in kernels.items() if "flash_bwd" in name)
                text += f", pair device {dev / calls:.4f}"
            got.setdefault(tag, []).append(text)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        leaves4 = [t.detach().reshape(1, bh, n, d).requires_grad_(True) for t in leaves]
        graph, graph4 = sdpa(*leaves), sdpa(*leaves4)
        s3 = cs.cuda_median(lambda: torch.autograd.grad(graph, leaves, g, retain_graph=True),
                            calls)[0]
        s4 = cs.cuda_median(lambda: torch.autograd.grad(
            graph4, leaves4, g.reshape(1, bh, n, d), retain_graph=True), calls)[0]
        b = cs.flash_bounds(bh, n, d, dtype)
        print(f"[compare-bwd] ({bh}, {n}, {d}) {str(dtype)[6:]} ms a call, median "
              f"[least-largest] of 7: " + "; ".join(f"{t} {' / '.join(x)}" for t, x in got.items())
              + f"; sdpa backward {s3:.4f}, view {s4:.4f}; bound dq "
              f"{b['flash_bwd_dq'][0]:.4f}, dkv {b['flash_bwd_dkv'][0]:.4f}, pair "
              f"{b['bwd_pair'][0]:.4f} ({b['bwd_pair'][1]})", flush=True)
        del q, k, v, g, out, lse, delta, leaves, leaves4, graph, graph4
        torch.cuda.empty_cache()


def parent_wrapper(root: str, lib):
    """The other checkout's ``ops/flash_attention.py`` as a module of its own
    whose wrappers launch that checkout's build ``lib``."""
    path = os.path.join(root, "confild_tpu_torch", "ops", "flash_attention.py")
    spec = importlib.util.spec_from_file_location("parent_flash_attention", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._library = lambda: lib
    return mod


def host_compare(wrappers: dict, device, calls: int = 200) -> None:
    """Each wrapper's ``flash_forward`` at (64, 144, 64) f32 on the same
    tensors, in turns: host microseconds a call (perf_counter over ``calls``
    unsynchronised calls, median of 5) and the event median of 20
    back-to-back calls (as phase 10 times it), beside SDPA's on the (1, BH,
    N, D) view."""
    q, k, v, _ = cs.flash_case(device, 64, 144, 64, torch.float32, seed=12)
    order = ["parent", "this", "this", "parent"] if "parent" in wrappers else ["this", "this"]
    got = {}
    for tag in order:
        fn = lambda: wrappers[tag].flash_forward(q, k, v)   # noqa: E731
        runs = []
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            runs.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        event = cs.cuda_median(fn, 20)[0]
        got.setdefault(tag, []).append(f"host {sorted(runs)[2]:.2f} us, event {event:.4f} ms")
    q4, k4, v4 = (t.reshape(1, 64, 144, 64) for t in (q, k, v))
    sdpa = cs.cuda_median(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4),
                          20)[0]
    print("[host] (64, 144, 64) f32 flash_forward as called: " + "; ".join(
        f"{t} {', '.join(x)}" for t, x in got.items()) + f"; sdpa view event {sdpa:.4f} ms",
        flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernels (default: the forward)")
    ap.add_argument("--parent", help="root of another checkout to build and compare")
    ap.add_argument("--no-checks", action="store_true", help="skip phase 10's checks")
    ap.add_argument("--trap", action="store_true", help="bound every mbarrier wait")
    ap.add_argument("--wide-only", action="store_true",
                    help="check and time only above 128 (FLASH_WIDE_CHECKS, WIDE_SHAPES)")
    ap.add_argument("--out", help="build directory (default: a temporary one)")
    ap.add_argument("--variants", default="",
                    help=f"ablations to time beside this build: {', '.join(VARIANTS)}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_compare: no CUDA device", file=sys.stderr)
        return 1
    device = cs.resolve_device("cuda")
    cs.phase_device()
    out = args.out or tempfile.mkdtemp(prefix="flash_fwd_")
    os.makedirs(out, exist_ok=True)
    # every build at once (one nvcc each): this tree, the parent, the variants
    jobs = {"this": (str(cuda_build.CSRC_DIR), args.trap, ())}
    if args.parent:
        jobs["parent"] = (os.path.join(args.parent, "confild_tpu_torch", "csrc"), False, ())
    for name in filter(None, args.variants.split(",")):
        jobs[name] = (str(cuda_build.CSRC_DIR), args.trap, VARIANTS[name])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda job: build(job[1][0], out, job[0], trap=job[1][1], patches=job[1][2]),
            jobs.items())))
    print(f"[build] {len(jobs)} builds at once in {time.perf_counter() - t0:.1f} s", flush=True)
    path, log = built["this"]
    libs = {"this": fa.declare(ctypes.CDLL(path))}
    setmaxnreg_ready(report("this", path, log), libs["this"])
    entry = ("flash_bwd_dq", "flash_bwd_dkv") if args.backward else ("flash_forward",)

    def same_signatures(lib):   # the C entry points timed here: this build's signatures
        for name in entry:
            getattr(lib, name).argtypes = getattr(libs["this"], name).argtypes
            getattr(lib, name).restype = getattr(libs["this"], name).restype
        return lib
    if args.parent:
        report("parent", *built["parent"])
        libs["parent"] = same_signatures(ctypes.CDLL(built["parent"][0]))
    for name in jobs:
        if name not in ("this", "parent"):
            libs[name] = fa.declare(ctypes.CDLL(built[name][0]))
            setmaxnreg_ready(report(name, *built[name]), libs[name])
    this = libs["this"]
    fa._library = lambda: this   # the wrappers launch this build
    for d in fa.TMA_WIDTHS:
        print(f"[plan] {cs.flash_tma_label(d)}: {fa.library_forward_plan(d, torch.bfloat16)} "
              f"(wrapper: {fa.forward_plan(d, torch.bfloat16)})", flush=True)
        for dtype in (torch.bfloat16, torch.float32):
            for kernel, plan in fa.library_backward_plan(d, dtype).items():
                print(f"[plan] {cs.flash_wide_bwd_label(d, kernel, dtype)}: {plan} (wrapper: "
                      f"{fa.backward_plan(d, dtype, kernel)})", flush=True)
    for d, dtype in cs.FLASH_FWD_INSTANCES:
        print(f"[plan] {cs.flash_fwd_label(d, dtype)}: {fa.library_forward_plan(d, dtype)} "
              f"(wrapper: {fa.forward_plan(d, dtype)})", flush=True)
        for kernel, plan in fa.library_backward_plan(d, dtype).items():
            print(f"[plan] {cs.flash_bwd_label(kernel, d, dtype)}: {plan} (wrapper: "
                  f"{fa.backward_plan(d, dtype, kernel)})", flush=True)
    if not args.no_checks:
        for bh, n, d, dtype in cs.FLASH_WIDE_CHECKS if args.wide_only else cs.FLASH_CHECKS:
            cs.flash_check(device, bh, n, d, dtype)
        if not args.wide_only:
            cs.flash_memory(device)
        waits_gave_up(libs)
    print(f"[compare] SM clock, max SM clock: {cs.sm_clocks()}", flush=True)
    if args.backward:
        compare_backward(libs, device, args.wide_only)
    else:
        compare(libs, device, args.wide_only)
        if args.wide_only:   # no host timings at 144 tokens
            print(f"[compare] SM clock, max SM clock: {cs.sm_clocks()}", flush=True)
            waits_gave_up(libs)
            return 0
        cs.forward_host_us(device)
        wrappers = {"this": fa}
        if args.parent and os.path.exists(os.path.join(args.parent, "confild_tpu_torch", "ops",
                                                       "flash_attention.py")):
            wrappers["parent"] = parent_wrapper(args.parent, libs["parent"])
        host_compare(wrappers, device)
    print(f"[compare] SM clock, max SM clock: {cs.sm_clocks()}", flush=True)
    waits_gave_up(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
