#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``confild_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` compiles every ``confild_tpu_torch/csrc/*.cu``, one
   process per source, all started together (timed; ptxas registers and
   spills, and for the flash and SIREN-backward kernels the count of
   tensor-core ``HMMA`` instructions in ``cuobjdump -sass``: every flash
   forward and backward instantiation and every instantiation of the
   SIREN backward's chain and reduction kernels must have some);
3. forward decode kernel against its plain version at Case4 widths
   (SIREN-FiLM 3 -> 384 x 16 modulated layers -> 3, w0 30), 16 rows x 262144
   points, both held to a float64 run under the JAX tests' criterion
   ``err_kernel <= 2 * err_plain_f32 + 1e-6``; times and the roofline bound
   (the SIREN rows' bound: matrix products at the tensor cores' 3xTF32 rate,
   sines at the CUDA-core float32 rate, bytes at the HBM rate, the largest;
   the CUDA-core figure of all the flops is logged beside it);
4. dz kernel against its plain version (same criterion on ``dL/dlatents``)
   at 384 rows x 10 sensors and 384 rows x 1024 points, and the time of the
   whole operator gradient (plain autograd decode vs forward + dz kernels)
   over a sweep of sensor counts, which places the crossover of the
   operator's ``rows x points > 65536`` rule;
5. main path: ``confild_tpu_torch.cli.sample_conditional.main`` at full Case4
   widths (U-Net 384^2, 128 ch, mult 1,1,2,2,4,4, 2 res blocks, 64-channel
   heads; CNF 16 x 384) on synthetic assets written from a seed in the
   reference ``.pt`` layout, 1000 steps respaced to 10, one sample, a
   4096-point mesh.  It runs twice: with Case4's 10 sensors (the operator
   takes the plain decode, the full-field decode takes the forward kernel)
   and with 1024 sensors (393216 pairs > 65536: the guidance gradient takes
   the forward and dz kernels).  Launch counts are zeroed before and read
   after each run; every kernel must have launched;
6. fused path inside DPS: one guided step's gradient with respect to
   ``x_prev`` through the full-width U-Net with the operator forced onto the
   kernels and forced onto the plain decode; they must agree to a relative
   L2 error of 1e-3;
7. training-backward kernel against its plain version at Case4 widths,
   4 rows x 262144 points (a training batch: each row spans 4 chunks of
   the kernel) and 4 rows x 16384 points (one chunk holds every row):
   every cotangent (dz, dW_first, dW_mid, dW_head, and after the
   autograd chain dlatents, dW2, db1) held to a chunked float64 autograd
   run of the reference decode under the same criterion with a
   ``1e-6 * max|f64|`` floor; two launches bitwise equal; at 4 x 262144
   the kernel's time (median of 7 separately timed calls with the least
   and largest, the SM clocks before and after), each of its kernels'
   device time from ``torch.profiler`` (the chain and the reduction with
   their rate of products), the plain version's time, and the bound;
8. the general op's gradient on the card (latents, decoder and coordinates
   all requiring grad) against plain autograd at 4 x 4096, and one training
   batch's gradients with ``use_fused_decode`` true and false at 4 x 16384:
   relative L2 of 1e-3 per leaf;
9. main path, training: ``confild_tpu_torch.cli.train_cnf.main`` at full
   Case4 width (``recipes/cnf/case4.yml``: 16 x 384 SIREN-FiLM, batch 4)
   on 8 seeded snapshots x 262144 points: 3 epochs (6 batch steps, 2
   decoder steps, 2 evals, 2 checkpoints), then a resume for 1 epoch that
   must continue the epoch count; launch counts zeroed before and read
   after each run; the newest checkpoint must load through
   ``CNF_inference``.

10. flash-attention kernels (forward, dq, dk/dv) against their plain
    versions and a float64 run at the path's shape (64, 144, 64), a ragged
    (2, 200, 32), the xl recipe's (16, 9216, 64), the auto threshold's
    (4, 16384, 64) and bf16 (2, 256, 64), under the same criterion (each
    error's share of its limit is printed); two launches bitwise equal;
    forward + backward at (4, 16384, 64) within 64 MB above inputs and
    outputs (O(N) memory); times of the kernels, the plain versions and
    ``scaled_dot_product_attention`` (a yardstick only: its forward, its
    backward alone on a retained graph, on the (BH, N, D) tensors and on
    their (1, BH, N, D) view, which takes another backend, and the CUDA
    kernels each launches) at (64, 144, 64), (16, 9216, 64) and
    (4, 16384, 64), each the median of 7 separately timed repeats with
    their least and largest (at 144 tokens, where the host's launch rate
    bounds those, also the forwards' device time from ``torch.profiler``),
    the SM clock and its maximum logged before and after, beside two
    bounds (the tensor cores' 3xTF32 rate, and CUDA-core float32);
11. the full-width Case4 U-Net (384^2, 128 ch, mult 1,1,2,2,4,4, heads of
    64), batch 8: one ``training_losses`` forward and backward with
    ``use_flash_attention`` true and false on the same weights and draws;
    loss and every parameter gradient agree to a relative L2 of 1e-3;
12. main path, diffusion training: ``confild_tpu_torch.cli.train_diffusion
    .main`` on ``recipes/diffusion/case4.yml``, which leaves
    ``use_flash_attention`` on auto (null: dense at Case4's 144 tokens),
    forced to ``true``, on 32 + 8 seeded synthetic 384 x 384
    latent images: 3 steps (``save_interval`` 2, ``log_interval`` 1), then a
    resume from ``model000003.pt`` to step 4 that must read back the step
    count and the EMA; ms per step, peak memory, a device profile of one
    step;
13. train -> sample: ``cli.sample_conditional.main`` once more with the EMA
    just written and flash attention on (the DPS gradient runs the flash
    forward and backward).

The script imports nothing of JAX or of ``confild_tpu``.  With no CUDA
device it exits non-zero and prints no result.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists every kernel.
"""

from __future__ import annotations

import copy
import csv
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.cli import sample_conditional, train_cnf, train_diffusion
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.guidance import (create_sampler, get_conditioning_method,
                                        get_noise, get_operator)
from confild_tpu_torch.guidance.operators import FUSED_MIN_PAIRS
from confild_tpu_torch.inference import CNF_inference
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.models.cnf import SirenFilm, siren_film_apply
from confild_tpu_torch.train.cnf_trainer import CNFTrainer
from confild_tpu_torch.ops import cuda_build
from confild_tpu_torch.ops import flash_attention as fa
from confild_tpu_torch.ops import siren_decode as sd

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3,
# dense TF32 on the tensor cores (a 3xTF32 product takes three), and the
# special-function units' exponentials (132 SMs x 16 a clock x 1.98 GHz)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
TF32_SPLIT_PRODUCTS = 3
PEAK_EXP_PER_S = 132 * 16 * 1.98e9

CASE4_CNF = dict(in_coord_features=3, in_latent_features=384, out_features=3,
                 num_hidden_layers=15, hidden_features=384, w0=30.0)
# recipes/conditional/case4_random_sensor.yml, cut to 10 respaced steps and
# one sample; no use_bf16 (the f32 torso of cli/train_diffusion.py:41)
CASE4_RECIPE = dict(
    image_size=384, num_channels=128, num_res_blocks=2, num_heads=4,
    num_head_channels=64, attention_resolutions="32,16,8",
    channel_mult="1,1,2,2,4,4", steps=1000, timestep_respacing="10",
    noise_schedule="cosine", operator="case4", operator_batch_size=384,
    sampler="ddpm", conditioning="ps", scale=1.0, noise="gaussian",
    noise_sigma=0.0, clip_denoised=True, no_of_samples=1, time_length=384,
    latent_size=384, decode_batch_size=16, seed=0)
MESH_POINTS = 4096
GRAD_REL_TOL = 1e-3
RECIPE_CNF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recipes", "cnf",
                          "case4.yml")
RECIPE_DIFFUSION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recipes",
                                "diffusion", "case4.yml")
# (BH, N, D, dtype) of the flash checks: the Case4 middle block at batch 8,
# a ragged edge, the xl recipe's level-8 block at batch 4, the auto
# threshold, bf16
FLASH_CHECKS = ((64, 144, 64, torch.float32), (2, 200, 32, torch.float32),
                (16, 9216, 64, torch.float32), (4, 16384, 64, torch.float32),
                (2, 256, 64, torch.bfloat16))
FLASH_TIMES = ((64, 144, 64), (16, 9216, 64), (4, 16384, 64))
FLASH_PATH_SHAPE = "64x144x64"
# flops of one sin2pi activation in the kernels: round-reduce (2), square (1),
# five FMAs (10), final multiply (1), FiLM add (1)
ACT_FLOPS = 15


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_median(fn, calls: int, repeats: int = 7) -> tuple[float, float, float]:
    """Milliseconds per call as ``(median, least, largest)`` over
    ``repeats`` separately timed runs of ``calls`` calls each (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def sm_clocks() -> str:
    """The SM clock and its maximum, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time with every flop on the CUDA cores (float32)."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def tc_bound(flops: float, nbytes: float, other_s: float = 0.0) -> tuple[float, str]:
    """Least time with the matrix products (``flops``) on the tensor cores
    at the 3xTF32 rate, the rest of the arithmetic taking ``other_s``
    seconds on its own units, and the bytes at the HBM rate: the largest of
    the three (ms, what bounds it)."""
    t_ops = max(flops * TF32_SPLIT_PRODUCTS / PEAK_TF32_FLOPS, other_s)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def device_profile(label: str, fn, top: int = 6) -> dict:
    """Device time by kernel name (torch.profiler) of one call of ``fn``
    after a warm-up call, and the device's busy share of its wall time;
    returns ``{kernel name: (ms, launches)}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    busy = sum(ms for ms, _ in kernels.values())
    log(f"[profile] {label}: wall {wall_ms:.1f} ms under the profiler, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), {sum(n for _, n in kernels.values())} "
        f"kernel launches")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[profile]   {ms:9.2f} ms  x{n:<5d} {name[:100]}")
    return kernels


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi[0]}")
    return name, count, smi[0]


def kernel_label(line: str) -> str | None:
    """``flash_bwd_dq_kernel<64, f32>`` or ``siren_bwd_chain_kernel<6>``
    from a line holding a kernel's mangled name, or None."""
    found = re.search(r"((?:siren|flash)_[a-z_]+_kernel)(?:ILi(\d+)E(\w*?)E)?", line)
    if not found:
        return None
    if not found.group(2):
        return found.group(1)
    if found.group(1).startswith("siren"):
        return f"{found.group(1)}<{found.group(2)}>"
    return (f"{found.group(1)}<{found.group(2)}, "
            f"{'bf16' if 'bfloat16' in found.group(3) else 'f32'}>")


def hmma_counts(path) -> dict:
    """Tensor-core instructions (``HMMA``) per kernel in the SASS of a built
    library, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = kernel_label(line)
            if kernel:
                counts[kernel] = 0
        elif kernel and "HMMA" in line:
            counts[kernel] += 1
    return counts


# kernels whose every instantiation must run its products on the tensor cores
TENSOR_CORE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "siren_bwd_chain",
                       "siren_bwd_reduce")


def phase_build():
    names = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    paths = cuda_build.build_all(names)
    dt = time.perf_counter() - t0
    log(f"[build] {', '.join(p.name for p in paths)} in {dt:.2f} s")
    # one line per kernel instantiation: registers and spills (ptxas -v),
    # and for the tensor-core libraries the HMMA count of each kernel
    hmma = {}
    for lib in ("flash_attention", "siren_decode_bwd"):
        hmma.update(hmma_counts(cuda_build.library_path(lib)))
    for name in names:
        kernel, spill = None, ""
        for line in cuda_build.build_logs.get(name, "").splitlines():
            if "Function properties" in line and kernel_label(line):
                kernel = kernel_label(line)
            elif "spill stores" in line:
                spill = re.sub(r"\s+", " ", line.strip())
            elif "registers" in line and kernel:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                tc = f", {hmma[kernel]} HMMA" if kernel in hmma else ""
                log(f"[build] {name}: {kernel}: {regs} registers, {spill}{tc}")
                kernel = None
    required = {k: v for k, v in hmma.items() if k.startswith(TENSOR_CORE_KERNELS)}
    no_tc = [k for k, v in required.items() if v == 0]
    if no_tc or not all(any(k.startswith(p) for k in required) for p in TENSOR_CORE_KERNELS):
        raise SystemExit(f"kernels without tensor-core instructions: {no_tc} "
                         f"(found {sorted(required)})")


def case4_decoder(device):
    gen = torch.Generator().manual_seed(1)
    return SirenFilm(**CASE4_CNF, generator=gen).to(device).requires_grad_(False)


def f64_decode(model, coords, latents, chunk: int):
    """Float64 reference decode (torch.sin layer loop), chunked over points."""
    m64 = _double(model)
    with torch.no_grad():
        return torch.cat([sd.siren_decode(m64, coords[i:i + chunk].double(), latents.double(),
                                       m64.w0, use_pallas=False)
                          for i in range(0, coords.shape[0], chunk)], dim=1)


def f64_dlatents(model, coords, latents, g, chunk: int):
    """Float64 autograd dL/dlatents of sum(decode * g), chunked over points."""
    m64 = _double(model)
    total = torch.zeros_like(latents, dtype=torch.float64)
    for i in range(0, coords.shape[0], chunk):
        lat = latents.double().requires_grad_(True)
        out = sd.siren_decode(m64, coords[i:i + chunk].double(), lat, m64.w0, use_pallas=False)
        (grad,) = torch.autograd.grad((out * g[:, i:i + chunk].double()).sum(), lat)
        total += grad
    return total


def _double(model):
    return copy.deepcopy(model).double()


def phase_forward(device, results):
    """Forward kernel vs plain at one decoder chunk of a 262144-point mesh."""
    model = case4_decoder(device)
    gen = torch.Generator(device=device).manual_seed(3)
    rows, points = 16, 262144
    coords = torch.rand((points, 3), generator=gen, device=device) * 2 - 1
    latents = torch.randn((rows, 384), generator=gen, device=device) * 0.1
    w_first, w_mid, w_head, b_head, w2, b1, scale = sd.stack_weights(model, model.w0)
    ops = [w_first, w_mid, w_head, b_head]
    z = sd.film_table(latents, w2, b1, scale)

    with torch.no_grad():
        kern = sd.decode_forward(coords, z, *ops)
        plain = sd.decode_forward_plain(coords, z, *ops)
        truth = f64_decode(model, coords, latents, chunk=32768)
    torch.cuda.synchronize()
    err_k = (kern.double() - truth).abs().max().item()
    err_p = (plain.double() - truth).abs().max().item()
    diff = (kern - plain).abs().max().item()
    ok = err_k <= 2 * err_p + 1e-6 and torch.isfinite(kern).all().item()
    log(f"[forward] {rows}x{points}: |kernel-f64| {err_k:.3e}, |plain-f64| {err_p:.3e}, "
        f"|kernel-plain| {diff:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("forward kernel fails the f64-relative criterion")

    del plain, truth
    torch.cuda.empty_cache()
    with torch.no_grad():
        ms = cuda_median(lambda: sd.decode_forward(coords, z, *ops), 3, repeats=1)[0]
        plain_ms = cuda_median(lambda: sd.decode_forward_plain(coords, z, *ops), 3, repeats=1)[0]
    n_mod, h, c_in, c_out = z.shape[0], 384, 3, 3
    pairs = rows * points
    mat = pairs * 2 * h * (c_in + (n_mod - 1) * h + c_out)
    act = pairs * ACT_FLOPS * h * n_mod
    flops = mat + act
    nbytes = 4 * (points * c_in + n_mod * rows * h + c_in * h + (n_mod - 1) * h * h
                  + h * c_out + c_out + pairs * c_out)
    bound_ms, bound_by = tc_bound(mat, nbytes, act / PEAK_F32_FLOPS)
    log(f"[forward] kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by}; every flop on the CUDA cores: {bound(flops, nbytes)[0]:.3f} ms); "
        f"kernel {flops / ms / 1e9:.2f} TFLOP/s")
    results["siren_decode_forward"] = dict(
        max_abs_err=err_k, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        shape=f"{rows}x{points}")


def dz_case(model, device, rows, points, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    coords = torch.rand((points, 3), generator=gen, device=device) * 2 - 1
    latents = torch.rand((rows, 384), generator=gen, device=device) * 2 - 1
    g = torch.randn((rows, points, 3), generator=gen, device=device)
    w_first, w_mid, w_head, _, w2, b1, scale = sd.stack_weights(model, model.w0)
    ops = [w_first, w_mid, w_head]
    z = sd.film_table(latents, w2, b1, scale)
    return coords, latents, g, z, ops, w2, scale


def phase_dz(device, results):
    """dz kernel vs plain at Case4's 10 sensors and at 1024 points."""
    model = case4_decoder(device)
    for rows, points in ((384, 10), (384, 1024)):
        coords, latents, g, z, ops, w2, scale = dz_case(model, device, rows, points, seed=5)
        with torch.no_grad():
            dz_k = sd.decode_dz(coords, z, g, *ops)
            dz_p = sd.decode_dz_plain(coords, z, g, *ops)
            dl_k = torch.einsum("nth,nlh->tl", dz_k * scale, w2)
            dl_p = torch.einsum("nth,nlh->tl", dz_p * scale, w2)
        truth = f64_dlatents(model, coords, latents, g, chunk=128)
        err_k = (dl_k.double() - truth).abs().max().item()
        err_p = (dl_p.double() - truth).abs().max().item()
        ok = err_k <= 2 * err_p + 1e-6 and torch.isfinite(dl_k).all().item()
        log(f"[dz] {rows}x{points}: |dlatents kernel-f64| {err_k:.3e}, "
            f"|plain-f64| {err_p:.3e} (max |truth| {truth.abs().max().item():.3e}) "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("dz kernel fails the f64-relative criterion")
        del dz_p, truth
        torch.cuda.empty_cache()
        with torch.no_grad():
            ms = cuda_median(lambda: sd.decode_dz(coords, z, g, *ops), 5, repeats=1)[0]
            plain_ms = cuda_median(lambda: sd.decode_dz_plain(coords, z, g, *ops), 3, repeats=1)[0]
        n_mod, h, c_in, c_out = z.shape[0], 384, 3, 3
        pairs = rows * points
        mat = pairs * 2 * h * (c_in + 2 * (n_mod - 1) * h + c_out)
        act = pairs * (2 * ACT_FLOPS + 2) * h * n_mod
        nbytes = 4 * (points * c_in + n_mod * rows * h + pairs * c_out + c_in * h
                      + (n_mod - 1) * h * h + h * c_out + n_mod * rows * h)
        bound_ms, bound_by = tc_bound(mat, nbytes, act / PEAK_F32_FLOPS)
        log(f"[dz] {rows}x{points}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}; every flop on the CUDA cores: "
            f"{bound(mat + act, nbytes)[0]:.3f} ms)")
        results[f"siren_decode_dz@{rows}x{points}"] = dict(
            max_abs_err=err_k, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, shape=f"{rows}x{points}")


def phase_crossover(device):
    """Operator gradient cost, plain autograd decode vs forward + dz kernels,
    over sensor counts at 384 rows: where the operator's 65536 rule sits."""
    model = case4_decoder(device)
    rows = []
    for points in (10, 64, 128, 170, 256, 512, 1024):
        coords, latents, g, *_ = dz_case(model, device, 384, points, seed=7)

        def plain():
            lat = latents.clone().requires_grad_(True)
            out = sd.siren_decode(model, coords, lat, model.w0, use_pallas=False)
            torch.autograd.grad((out * g).sum(), lat)

        def fused():
            lat = latents.clone().requires_grad_(True)
            out = sd.fused_siren_decode_frozen(model, coords, lat, model.w0)
            torch.autograd.grad((out * g).sum(), lat)

        t_plain = cuda_median(plain, 5, repeats=1)[0]
        t_fused = cuda_median(fused, 5, repeats=1)[0]
        rows.append({"points": points, "pairs": 384 * points,
                     "plain_autograd_ms": t_plain, "fused_ms": t_fused})
        log(f"[crossover] 384x{points} ({384 * points} pairs): plain autograd "
            f"{t_plain:.3f} ms, forward+dz kernels {t_fused:.3f} ms")
    log("[crossover] " + json.dumps(rows))


def write_assets(root, n_sensors: int) -> dict:
    """Case4 assets from a seed: U-Net and CNF weights in the reference .pt
    layout, the hierarchical normalizer file, mesh, sensors and measures."""
    T, L = CASE4_RECIPE["time_length"], CASE4_RECIPE["latent_size"]
    unet_pt = os.path.join(root, "ema.pt")
    if not os.path.exists(unet_pt):
        torch.manual_seed(0)
        unet = tunet.create_model(**{k: CASE4_RECIPE[k] for k in (
            "image_size", "num_channels", "num_res_blocks", "num_heads", "num_head_channels",
            "attention_resolutions", "channel_mult")})
        torch.save(unet.state_dict(), unet_pt)
        model = case4_decoder("cpu")
        rng = np.random.default_rng(0)
        torch.save({"model_state_dict": model.state_dict(),
                    "hidden_states": {"latents": torch.zeros(1, L)}},
                   os.path.join(root, "cnf.pt"))
        torch.save({"x_normalizer_params": (torch.ones(3), torch.zeros(3)),
                    "y_normalizer0u_params": torch.ones(1, 3),
                    "y_normalizer0l_params": -torch.ones(1, 3)},
                   os.path.join(root, "normalizer.pt"))
        np.save(os.path.join(root, "coords.npy"),
                rng.uniform(size=(MESH_POINTS, 3)).astype(np.float32))
        np.save(os.path.join(root, "data_max.npy"), np.float32(1.0))
        np.save(os.path.join(root, "data_min.npy"), np.float32(-1.0))
    rng = np.random.default_rng(n_sensors)
    sensors = os.path.join(root, f"sensors_{n_sensors}.npy")
    measures = os.path.join(root, f"measures_{n_sensors}.npy")
    np.save(sensors, rng.uniform(size=(n_sensors, 3)).astype(np.float32))
    np.save(measures, (0.1 * rng.standard_normal((T, n_sensors, 3))).astype(np.float32))
    return dict(CASE4_RECIPE, ema_path=unet_pt, cnf_checkpoint=os.path.join(root, "cnf.pt"),
                cnf_normalizer=os.path.join(root, "normalizer.pt"),
                cnf_coords=os.path.join(root, "coords.npy"),
                data_max=os.path.join(root, "data_max.npy"),
                data_min=os.path.join(root, "data_min.npy"),
                sensor_coords=sensors, sensor_measures=measures,
                save_path=os.path.join(root, f"samples_{n_sensors}.npy"))


def phase_main_path(root):
    """The CLI at full width, at 10 and at 1024 sensors; returns the summed
    launch counts of the two runs."""
    T = CASE4_RECIPE["time_length"]
    launches = {k: 0 for k in sd.LAUNCHES}
    for n_sensors in (10, 1024):
        recipe = write_assets(root, n_sensors)
        path = os.path.join(root, f"case4_{n_sensors}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(recipe, f)
        torch.cuda.reset_peak_memory_stats()
        sd.reset_launch_counts()
        t0 = time.perf_counter()
        timings = sample_conditional.main([path])
        wall = time.perf_counter() - t0
        counts = dict(sd.LAUNCHES)
        fields = np.load(recipe["save_path"])
        expected = (1, T, MESH_POINTS, 3)
        ok = fields.shape == expected and np.isfinite(fields).all()
        log(f"[main] {n_sensors} sensors: fields {fields.shape}, finite "
            f"{bool(np.isfinite(fields).all())}; {timings['steps']} guided steps "
            f"{timings['sample_s'] * 1e3 / timings['steps']:.1f} ms/step, decode "
            f"{timings['decode_s'] * 1e3:.1f} ms ({T} rows x {MESH_POINTS} points), CLI wall "
            f"{wall:.1f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {counts}")
        if not ok:
            raise SystemExit(f"main path output wrong: {fields.shape}, expected {expected}")
        need = ["siren_decode_forward"] + (["siren_decode_dz"] if n_sensors * T > FUSED_MIN_PAIRS else [])
        missing = [k for k in need if counts[k] == 0]
        if missing:
            raise SystemExit(f"main path ran without launching {missing}")
        for k, v in counts.items():
            launches[k] += v
    return launches


def profile_step(step) -> None:
    """Device time of one guided step by kernel and the convolutions' share."""
    kernels = device_profile("one guided step (plain decode)", step, top=8)
    busy = sum(ms for ms, _ in kernels.values())
    conv = sum(ms for k, (ms, _) in kernels.items()
               if "conv" in k.lower() or "cudnn" in k.lower() or "implicit" in k.lower())
    log(f"[profile]   convolution kernels {conv:.1f} ms ({conv / max(busy, 1e-9):.1%} of busy)")


def phase_fused_dps(root, device):
    """One guided step's gradient through the full-width U-Net, with the
    operator forced onto the kernels and onto the plain decode."""
    T, L = CASE4_RECIPE["time_length"], CASE4_RECIPE["latent_size"]
    hp = cfgmod.basic_input(write_assets(root, 10))
    model, _ = sample_conditional.build_model_and_diffusion(hp)
    model = sample_conditional.load_unet(hp.ema_path, model).to(device).eval().requires_grad_(False)
    sampler = create_sampler(steps=hp.steps, noise_schedule=hp.noise_schedule,
                             timestep_respacing=hp.timestep_respacing)
    y = torch.as_tensor(np.load(hp.sensor_measures), device=device)
    gen = torch.Generator(device=device).manual_seed(11)
    # a late step (internal index 1): at the first steps x0_hat is clamped
    # to [-1, 1] nearly everywhere and the gradient is almost all zero
    x_prev = 0.5 * torch.randn((1, 1, T, L), generator=gen, device=device)
    noise = torch.randn((1, 1, T, L), generator=gen, device=device)
    t = torch.full((1,), 1, dtype=torch.long)
    grads, step_ms = {}, {}
    for use_pallas in (False, True):
        op = get_operator("case4", coords_path=hp.sensor_coords, max_val_path=hp.data_max,
                          min_val_path=hp.data_min, normalizer_params_path=hp.cnf_normalizer,
                          ckpt_path=hp.cnf_checkpoint, device=device)
        op.use_pallas = use_pallas
        method = get_conditioning_method("ps", op, get_noise("gaussian", sigma=0.0), scale=1.0)

        def grad():
            x = x_prev.clone().requires_grad_(True)
            out = sampler.diffusion.p_sample(model, x, t, noise=noise)
            norm = method.misfit(out["pred_xstart"], y)
            return torch.autograd.grad(norm.sum(), x)[0]
        sd.reset_launch_counts()
        grads[use_pallas] = grad()
        torch.cuda.synchronize()
        counts = dict(sd.LAUNCHES)
        if use_pallas and (counts["siren_decode_forward"] == 0 or counts["siren_decode_dz"] == 0):
            raise SystemExit(f"forced fused DPS step launched {counts}")
        step_ms[use_pallas] = cuda_median(
            lambda: sampler._one_step(model, x_prev, t, y, method, noise=noise,
                                      measurement_noise=torch.zeros_like(y)), 3, repeats=1)[0]
        log(f"[dps] use_pallas={use_pallas}: launches {counts}, guided step "
            f"{step_ms[use_pallas]:.1f} ms")
        if not use_pallas:      # the path Case4's 10 sensors take
            profile_step(lambda: sampler._one_step(
                model, x_prev, t, y, method, noise=noise,
                measurement_noise=torch.zeros_like(y)))
    a, b = grads[True], grads[False]
    rel = ((a - b).norm() / b.norm()).item()
    ok = rel <= GRAD_REL_TOL and torch.isfinite(a).all().item() and b.norm().item() > 0
    log(f"[dps] grad wrt x_prev, kernels vs plain decode: rel L2 {rel:.3e} "
        f"(tol {GRAD_REL_TOL}), max abs {(a - b).abs().max().item():.3e}, "
        f"|grad| {b.norm().item():.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("fused DPS gradient disagrees with the plain decode")


# ---------------------------------------------------------------------------
# training: the training-backward kernel, the ops' gradients, the CLI
# ---------------------------------------------------------------------------

def f64_train_grads(model, coords, latents, g, chunk: int):
    """Float64 autograd of ``sum(decode * g)`` through the reference layer
    loop (``siren_film_apply``'s ``torch.sin`` arithmetic), chunked over
    points: the decoder's parameter gradients, ``dL/dlatents`` and
    ``dL/dz_l`` per row (the gradient of each layer's FiLM term)."""
    m64 = _double(model).requires_grad_(True)
    lat = latents.double().requires_grad_(True)
    dz = torch.zeros((m64.n_modulated, latents.shape[0], m64.net1[0].out_features),
                     dtype=torch.float64, device=latents.device)
    for i in range(0, coords.shape[0], chunk):
        x, films = coords[i:i + chunk].double()[None], []
        for lin1, lin2 in zip(m64.net1[:-1], m64.net2):
            films.append(lin2(lat[:, None, :]))
            films[-1].retain_grad()
            x = torch.sin(m64.w0 * (lin1(x) + films[-1]))
        (m64.net1[-1](x) * g[:, i:i + chunk].double()).sum().backward()
        for l, f in enumerate(films):
            dz[l] += f.grad[:, 0, :]
    grads = {n: p.grad for n, p in m64.named_parameters()}
    n_mod = m64.n_modulated
    return {
        "dz": dz, "dW_first": grads["net1.0.weight"].t(),
        "dW_mid": torch.stack([grads[f"net1.{l}.weight"].t() for l in range(1, n_mod)]),
        "dW_head": grads[f"net1.{n_mod}.weight"].t(), "dlatents": lat.grad,
        "dW2": torch.stack([grads[f"net2.{l}.weight"].t() for l in range(n_mod)]),
        "db1": torch.stack([grads[f"net1.{l}.bias"] for l in range(n_mod)])}


def bwd_case(model, device, rows, points, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    coords = torch.rand((points, 3), generator=gen, device=device) * 2 - 1
    latents = torch.randn((rows, 384), generator=gen, device=device) * 0.1
    g = torch.randn((rows, points, 3), generator=gen, device=device)
    w_first, w_mid, w_head, _, w2, b1, scale = sd.stack_weights(model, model.w0)
    z = sd.film_table(latents, w2, b1, scale)
    return coords, latents, g, z, (w_first, w_mid, w_head), w2, scale


def bwd_check(model, device, rows, points, seed) -> float:
    """Training-backward kernel vs plain vs float64 at ``rows x points``,
    every cotangent, and two launches bitwise equal; returns the kernel's
    largest error against float64."""
    coords, latents, g, z, ops, w2, scale = bwd_case(model, device, rows, points, seed)
    with torch.no_grad():
        kern = sd.decode_bwd(coords, z, g, *ops)
        again = sd.decode_bwd(coords, z, g, *ops)
        plain = sd.decode_bwd_plain(coords, z, g, *ops)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(kern, again))
    kern_u = sd.unfold_bwd(kern, latents, w2, scale)
    plain_u = sd.unfold_bwd(plain, latents, w2, scale)
    del plain
    # the chained cotangents as training takes them: autograd through the
    # train op (backward = the kernel) to the latents, net2 and the biases
    m = copy.deepcopy(model).requires_grad_(True)
    lat = latents.clone().requires_grad_(True)
    out = sd.fused_siren_decode_train(m, coords, lat, m.w0)
    out.backward(g)
    n_mod = m.n_modulated
    kern_u["dlatents"] = lat.grad
    kern_u["dW2"] = torch.stack([m.net2[l].weight.grad.t() for l in range(n_mod)])
    kern_u["db1"] = torch.stack([m.net1[l].bias.grad for l in range(n_mod)])
    truth = f64_train_grads(model, coords, latents, g, chunk=4096)
    ok = same
    for name, want in truth.items():
        err_k = (kern_u[name].double() - want).abs().max().item()
        err_p = (plain_u[name].double() - want).abs().max().item()
        top = want.abs().max().item()
        good = err_k <= 2 * err_p + 1e-6 * top and torch.isfinite(kern_u[name]).all().item()
        ok &= good
        log(f"[bwd] {rows}x{points} {name}: |kernel-f64| {err_k:.3e}, |plain-f64| "
            f"{err_p:.3e}, max |f64| {top:.3e} -> {'ok' if good else 'FAIL'}")
    log(f"[bwd] {rows}x{points} two launches bitwise equal: {same}")
    if not ok:
        raise SystemExit("training-backward kernel fails the f64-relative criterion "
                         "or is not deterministic")
    max_abs_err = max((kern_u[k].double() - truth[k]).abs().max().item() for k in truth)
    del plain_u, kern_u, truth, m, out
    torch.cuda.empty_cache()
    return max_abs_err


def phase_bwd(device, results):
    """The training-backward kernel checked at 4 x 262144, the shape the
    training path gives it (every row spans 4 chunks of ``BWD_PAIRS``
    pairs, so a row's dz sums across chunk launches), and at 4 x 16384
    (one chunk holds all four rows); kernel and plain timed at 4 x 262144,
    the kernel as the median of 7 separately timed calls, and the device
    time of each of its kernels from one profiled call."""
    model = case4_decoder(device)
    rows, points = 4, 262144
    max_abs_err = bwd_check(model, device, rows, points, seed=14)
    bwd_check(model, device, 4, 16384, seed=13)
    coords, latents, g, z, ops, w2, scale = bwd_case(model, device, rows, points, seed=14)
    n_mod = z.shape[0]
    with torch.no_grad():
        log(f"[bwd-time] SM clock, max before: {sm_clocks()}")
        ms, least, largest = cuda_median(lambda: sd.decode_bwd(coords, z, g, *ops), 1)
        log(f"[bwd-time] SM clock, max after: {sm_clocks()}")
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_median(lambda: sd.decode_bwd_plain(coords, z, g, *ops), 2, repeats=1)[0]
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    h, c_in, c_out = 384, 3, 3
    pairs = rows * points
    # forward recompute, dx chain and dW products (section 3 of the port's
    # plan: 3 x 4.43 MFLOP a pair at Case4), the sine and its derivative
    mat = pairs * (2 * h * (c_in + 3 * (n_mod - 1) * h + 2 * c_out) + 2 * c_in * h)
    act = pairs * (2 * ACT_FLOPS + 3) * h * n_mod
    flops = mat + act
    nbytes = 4 * (points * c_in + 2 * n_mod * rows * h + pairs * c_out + 2 * c_in * h
                  + 2 * (n_mod - 1) * h * h + 2 * h * c_out)
    bound_ms, bound_by = tc_bound(mat, nbytes, act / PEAK_F32_FLOPS)
    with torch.no_grad():
        prof = device_profile(f"training backward {rows}x{points}",
                              lambda: sd.decode_bwd(coords, z, g, *ops), top=6)
    # the products each kernel computes (the chain: forward and dx chain)
    products = {"chain": pairs * 4 * (n_mod - 1) * h * h, "reduce": pairs * 2 * (n_mod - 1) * h * h}
    for part in ("chain", "reduce", "sums", "split", "fold"):
        hits = [v for k, v in prof.items() if f"siren_bwd_{part}_kernel" in k]
        dev_ms = sum(ms for ms, _ in hits)
        rate = (f", {products[part] / dev_ms / 1e9:.2f} TFLOP/s of products"
                if part in products and dev_ms else "")
        log(f"[bwd-time] {part}: {dev_ms:.3f} ms device, {sum(n for _, n in hits)} "
            f"launches{rate}")
    log(f"[bwd] {rows}x{points}: kernel {ms:.3f} ms [{least:.3f}-{largest:.3f}] median of 7 "
        f"({flops / ms / 1e9:.2f} TFLOP/s), bound {bound_ms:.3f} ms ({bound_by}, "
        f"{flops / 1e12:.2f} TFLOP; every flop on the CUDA cores: "
        f"{bound(flops, nbytes)[0]:.3f} ms); plain {plain_ms:.3f} ms (peak memory "
        f"{plain_peak:.2f} GiB); library: none (no single PyTorch call computes it)")
    results["siren_decode_bwd"] = dict(
        max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, shape=f"{rows}x{points}")


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def phase_op_grads(device, root):
    """The general op's gradient on the card, and one training batch's
    gradients with the fused decode and with the plain decode."""
    model = case4_decoder(device)
    coords, latents, g, *_ = bwd_case(model, device, 4, 4096, seed=15)
    leaves = {}
    for fused in (True, False):
        m = copy.deepcopy(model).requires_grad_(True)
        lat = latents.clone().requires_grad_(True)
        c = coords.clone().requires_grad_(True)
        out = (sd.fused_siren_decode(m, c, lat, m.w0) if fused
               else siren_film_apply(m, c[None], lat[:, None], m.w0))
        out.backward(g)
        leaves[fused] = {"latents": lat.grad, "coords": c.grad,
                         **{n: p.grad for n, p in m.named_parameters()}}
    worst = max(rel_l2(leaves[True][k], leaves[False][k]) for k in leaves[False])
    log(f"[op-grad] general op 4x4096, kernels vs plain autograd: worst leaf rel L2 "
        f"{worst:.3e} over {len(leaves[False])} leaves (tol {GRAD_REL_TOL})")
    if not worst <= GRAD_REL_TOL:
        raise SystemExit("general op gradient disagrees with plain autograd")

    recipe = write_training_case(os.path.join(root, "step"), n_snapshots=8, points=16384)
    grads = {}
    for fused in (True, False):
        hp = cfgmod.basic_input(recipe, use_fused_decode=fused)
        tr = CNFTrainer(hp)
        tr.init_state(seed=0)
        with torch.no_grad():   # a non-zero table, so every latent leaf is live
            tr.state.latents.copy_(0.1 * torch.randn(
                tr.state.latents.shape, generator=torch.Generator().manual_seed(1)))
        sd.reset_launch_counts()
        loss = tr._batch_loss(torch.arange(4, device=device), 0, 0)
        loss.backward()
        torch.cuda.synchronize()
        counts = dict(sd.LAUNCHES)
        if fused and (counts["siren_decode_forward"] == 0 or counts["siren_decode_bwd"] == 0):
            raise SystemExit(f"fused training step launched {counts}")
        grads[fused] = {"latents": tr.state.latents.grad,
                        **{n: p.grad for n, p in tr.model.named_parameters()}}
    worst = max(rel_l2(grads[True][k], grads[False][k]) for k in grads[False])
    log(f"[step-grad] one training batch 4x16384, use_fused_decode true vs false: worst "
        f"leaf rel L2 {worst:.3e} over {len(grads[False])} leaves (tol {GRAD_REL_TOL})")
    if not worst <= GRAD_REL_TOL:
        raise SystemExit("fused training step disagrees with the plain decode")


def write_training_case(root, n_snapshots: int, points: int, epochs: int = 3) -> str:
    """``recipes/cnf/case4.yml`` at full width on seeded synthetic flow
    snapshots (smooth travelling waves on random 3-D points)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(points)
    coords = rng.uniform(size=(points, 3)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=(n_snapshots, 1, 3))
    k = rng.normal(size=(3, 3)) * 4
    fois = np.sin(coords @ k + phase) + 0.1 * rng.standard_normal((n_snapshots, points, 3))
    np.save(os.path.join(root, "output.npy"), fois.astype(np.float32))
    np.save(os.path.join(root, "coords.npy"), coords)
    with open(RECIPE_CNF) as f:
        recipe = yaml.safe_load(f)
    recipe.update(data_path=os.path.join(root, "output.npy"),
                  coor_path=os.path.join(root, "coords.npy"),
                  save_path=os.path.join(root, "run"), epochs=epochs, save_every=2,
                  multiGPU=1)
    path = os.path.join(root, "case4.yml")
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    return path


def phase_train(root):
    """The training CLI at full Case4 width; then a 1-epoch resume."""
    recipe = write_training_case(os.path.join(root, "train"), n_snapshots=8, points=262144)
    hp = cfgmod.basic_input(recipe)
    torch.cuda.reset_peak_memory_stats()
    sd.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train_cnf.main([recipe])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(sd.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(hp.save_path, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    epoch_s = [float(r["wait_train_chunk"]) for r in rows if r.get("wait_train_chunk")]
    eval_s = [float(r["wait_eval"]) for r in rows if r.get("wait_eval")]
    n_batches = trainer.N_samples // hp.batch_size
    t1 = time.perf_counter()
    trainer.save(999)
    save_ms = (time.perf_counter() - t1) * 1e3
    os.remove(os.path.join(hp.save_path, "checkpoint_999.pt"))
    log(f"[train] Case4 {trainer.N_samples} snapshots x {trainer.flat_coords.shape[0]} points, "
        f"batch {hp.batch_size}: {len(losses)} epochs, losses {[round(x, 6) for x in losses]}, "
        f"CLI wall {wall:.1f} s, peak memory {peak:.2f} GiB; launches {counts}")
    log(f"[train] ms per batch step {np.mean(epoch_s[1:]) * 1e3 / n_batches:.1f} (first "
        f"epoch {epoch_s[0] * 1e3 / n_batches:.1f}), eval {np.mean(eval_s) * 1e3:.1f} ms "
        f"({trainer.N_samples} rows), checkpoint {save_ms:.1f} ms")
    if not (losses and all(np.isfinite(losses))):
        raise SystemExit(f"training losses not finite: {losses}")
    # one more batch step of the real epoch loop (with the decoder step of
    # an epoch > 0), in memory only: the checkpoints on disk stay as written
    device_profile("one training batch step (Case4, 4 x 262144)",
                   lambda: trainer._run_epoch(np.arange(hp.batch_size)[None], 1, False))
    missing = [k for k in ("siren_decode_forward", "siren_decode_bwd") if counts[k] == 0]
    if missing:
        raise SystemExit(f"training ran without launching {missing}")

    hp_resume = cfgmod.basic_input(recipe, epochs=1)
    with open(recipe, "w") as f:
        yaml.safe_dump(hp_resume.to_dict(), f)
    sd.reset_launch_counts()
    resumed = train_cnf.main([recipe])
    torch.cuda.synchronize()
    for k, v in sd.LAUNCHES.items():
        counts[k] += v
    with open(os.path.join(hp.save_path, "progress.csv")) as f:
        first_epoch = int(next(csv.DictReader(f))["epoch"])
    log(f"[train] resume: first epoch {first_epoch}, final epoch {resumed.state.epoch}, "
        f"launches {dict(sd.LAUNCHES)}")
    if first_epoch != trainer.state.epoch or resumed.state.epoch != trainer.state.epoch:
        raise SystemExit("the resumed run did not continue the epoch count")

    newest = os.path.join(hp.save_path, f"checkpoint_{resumed.state.epoch}.pt")
    cnf_yml = os.path.join(root, "train", "cnf.yml")
    with open(cnf_yml, "w") as f:
        yaml.safe_dump({k: hp.to_dict()[k] for k in ("dims", "hidden_size", "NF")}, f)
    inf = CNF_inference(newest, cnf_yml)
    # Case4's lumped normalizer is per mesh point: decode the whole mesh
    pred = inf.predict(resumed.train_coord, [0, 1], batch_size=2)
    want = resumed.infer(resumed.train_coord, resumed.state.latents[:2]).cpu().numpy()
    rel = float(np.linalg.norm(pred - want) / np.linalg.norm(want))
    log(f"[train] {os.path.basename(newest)} through CNF_inference: {pred.shape}, rel L2 "
        f"vs the trainer's own decode {rel:.3e}")
    if not (np.isfinite(pred).all() and rel <= GRAD_REL_TOL):
        raise SystemExit("the trainer's checkpoint does not load through CNF_inference")
    return counts


# ---------------------------------------------------------------------------
# flash attention: the kernels, the U-Net route, diffusion training
# ---------------------------------------------------------------------------

def f64_attention(q, k, v, g):
    """Float64 forward and backward of softmax attention, one head at a
    time: ``{"out", "lse", "dq", "dk", "dv"}``."""
    scale = 1.0 / q.shape[-1] ** 0.5
    res = {n: [] for n in ("out", "lse", "dq", "dk", "dv")}
    for b in range(q.shape[0]):
        qb, kb, vb, gb = (t[b].double() for t in (q, k, v, g))
        s = qb @ kb.t() * scale
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[:, None])
        out = p @ vb
        ds = p * (gb @ vb.t() - (gb * out).sum(-1, keepdim=True))
        for name, val in (("out", out), ("lse", lse), ("dq", ds @ kb * scale),
                          ("dk", ds.t() @ qb * scale), ("dv", p.t() @ gb)):
            res[name].append(val)
        del s, p, ds
    return {n: torch.stack(v) for n, v in res.items()}


def flash_case(device, bh, n, d, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=device).to(dtype) for _ in range(4)]


def flash_check(device, bh, n, d, dtype) -> dict:
    """Kernels vs plain vs float64 on every output, two launches bitwise
    equal; returns the kernels' largest errors against float64."""
    q, k, v, g = flash_case(device, bh, n, d, dtype, seed=bh + n)
    out, lse = fa.flash_forward(q, k, v)
    kern = dict(zip(("dq", "dk", "dv"), fa.flash_backward(q, k, v, out, lse, g)),
                out=out, lse=lse)
    out2, lse2 = fa.flash_forward(q, k, v)
    again = (out2, lse2, *fa.flash_backward(q, k, v, out2, lse2, g))
    same = all(torch.equal(a, kern[n]) for a, n in zip(again, ("out", "lse", "dq", "dk", "dv")))
    del again, out2, lse2
    p_out, p_lse = fa.flash_forward_plain(q, k, v)
    plain = dict(zip(("dq", "dk", "dv"), fa.flash_backward_plain(q, k, v, p_out, p_lse, g)),
                 out=p_out, lse=p_lse)
    truth = f64_attention(q, k, v, g)
    torch.cuda.synchronize()
    ok, errs = same, {}
    for name, want in truth.items():
        err_k = (kern[name].double() - want).abs().max().item()
        err_p = (plain[name].double() - want).abs().max().item()
        top = want.abs().max().item()
        limit = 2 * err_p + 1e-6 * top
        good = err_k <= limit and torch.isfinite(kern[name]).all().item()
        ok &= good
        errs[name] = err_k
        log(f"[flash] ({bh}, {n}, {d}) {str(dtype)[6:]} {name}: |kernel-f64| {err_k:.3e}, "
            f"|plain-f64| {err_p:.3e}, max |f64| {top:.3e}, error / limit "
            f"{err_k / limit:.3f} -> {'ok' if good else 'FAIL'}")
    log(f"[flash] ({bh}, {n}, {d}) {str(dtype)[6:]} two launches bitwise equal: {same}")
    if not ok:
        raise SystemExit("flash kernels fail the f64-relative criterion or are not "
                         "deterministic")
    del kern, plain, truth
    torch.cuda.empty_cache()
    return errs


def flash_memory(device) -> None:
    """Forward + backward through the kernels at (4, 16384, 64): the peak
    above inputs and outputs is O(N), not the (BH, N, N) weights."""
    q, k, v, g = flash_case(device, 4, 16384, 64, torch.float32, seed=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, lse = fa.flash_forward(q, k, v)
    grads = fa.flash_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in (out, lse, *grads))
    extra = (torch.cuda.max_memory_allocated() - base - outputs) / 2**20
    dense = 4 * 16384 * 16384 * 4 / 2**30
    log(f"[flash] (4, 16384, 64) forward + backward: {extra:.2f} MiB above inputs and "
        f"outputs (limit 64 MiB; one dense (BH, N, N) f32 tensor is {dense:.2f} GiB)")
    if not extra < 64:
        raise SystemExit("flash forward + backward is not O(N) in memory")


def flash_bounds(bh, n, d) -> dict:
    """Per function ``(tensor-core ms, bound_by, CUDA-core f32 ms)`` from its
    flops, its exponentials and the bytes of its inputs and outputs (f32);
    on the CUDA cores an exponential counts as one operation."""
    mat, rows, exps = bh * n * n * d, bh * n, bh * n * n
    io = 4 * bh * n * d
    work = {"flash_forward": (4 * mat, 3 * io + io + 4 * rows),
            "flash_bwd_dq": (6 * mat, 4 * io + 8 * rows + io),
            "flash_bwd_dkv": (8 * mat, 4 * io + 8 * rows + 2 * io),
            "backward": (10 * mat, 5 * io + 4 * rows + 3 * io)}
    return {name: (*tc_bound(flops, nbytes, exps / PEAK_EXP_PER_S),
                   bound(flops + exps, nbytes)[0])
            for name, (flops, nbytes) in work.items()}


def sdpa_kernels(device, bh, n, d) -> None:
    """The CUDA kernels that scaled_dot_product_attention's float32 forward
    and backward launch (which backend, which precision), by name, on the
    kernels' (BH, N, D) layout and on its (1, BH, N, D) view."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in ((bh, n, d), (1, bh, n, d)):
        leaves = [t.reshape(shape).requires_grad_(True)
                  for t in flash_case(device, bh, n, d, torch.float32, 7)[:3]]
        out = sdpa(*leaves)
        torch.autograd.grad(out, leaves, torch.ones_like(out), retain_graph=True)   # warm-up
        torch.cuda.synchronize()
        for label, fn in (("forward", lambda: sdpa(*leaves)),
                          ("backward", lambda: torch.autograd.grad(
                              out, leaves, torch.ones_like(out), retain_graph=True))):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
            log(f"[flash-sdpa] {shape} f32 {label} kernels: {names}")
        del leaves, out


def flash_times(device, bh, n, d) -> dict:
    """Kernels, plain versions and scaled_dot_product_attention at one shape,
    each the median of 7 separately timed repeats (CUDA events, after a
    warm-up); every time in ms, and under ``spread`` each one's least and
    largest repeat."""
    q, k, v, g = flash_case(device, bh, n, d, torch.float32, seed=7)
    out, lse = fa.flash_forward(q, k, v)
    delta = (g * out).sum(-1).contiguous()
    calls = 20 if n < 1000 else 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(*leaves), leaves, g)
    graph = sdpa(*leaves)   # retained: its backward alone is timed
    # the same call on the (1, BH, N, D) view, which takes another backend
    leaves4 = [t.detach().reshape(1, bh, n, d).requires_grad_(True) for t in leaves]
    graph4 = sdpa(*leaves4)
    fns = {
        "flash_forward": lambda: fa.flash_forward(q, k, v),
        "flash_bwd_dq": lambda: fa.bwd_dq(q, k, v, g, lse, delta),
        "flash_bwd_dkv": lambda: fa.bwd_dkv(q, k, v, g, lse, delta),
        "fwd_bwd": lambda: fa.flash_backward(q, k, v, *fa.flash_forward(q, k, v), g),
        "plain_forward": lambda: fa.flash_forward_plain(q, k, v),
        "plain_fwd_bwd": lambda: fa.flash_backward_plain(
            q, k, v, *fa.flash_forward_plain(q, k, v), g),
        "sdpa_forward": lambda: sdpa(q, k, v),
        "sdpa_fwd_bwd": sdpa_fwd_bwd,
        "sdpa_backward": lambda: torch.autograd.grad(graph, leaves, g, retain_graph=True),
        "sdpa_4d_forward": lambda: sdpa(*leaves4),
        "sdpa_4d_backward": lambda: torch.autograd.grad(
            graph4, leaves4, g.reshape(1, bh, n, d), retain_graph=True)}
    t, spread = {}, {}
    for name, fn in fns.items():
        t[name], *spread[name] = cuda_median(fn, calls)
    t["plain_backward"] = t["plain_fwd_bwd"] - t["plain_forward"]
    t["bwd_pair"] = t["flash_bwd_dq"] + t["flash_bwd_dkv"]
    if calls > 1:   # the host's launch rate bounds the events here: device time too
        for name in ("flash_forward", "sdpa_4d_forward"):
            kernels = device_profile(f"{name} ({bh}, {n}, {d}), {calls} calls",
                                     lambda: [fns[name]() for _ in range(calls)], top=3)
            t[f"{name}_device"] = sum(ms for ms, _ in kernels.values()) / calls

    def ms(name):
        return f"{t[name]:.3f} [{spread[name][0]:.3f}-{spread[name][1]:.3f}]"
    b = flash_bounds(bh, n, d)
    log(f"[flash-time] ({bh}, {n}, {d}) f32, ms as median [least-largest] of 7: forward "
        f"kernel {ms('flash_forward')} (bound {b['flash_forward'][0]:.3f} tensor cores, "
        f"{b['flash_forward'][2]:.3f} f32; "
        f"{4 * bh * n * n * d / t['flash_forward'] / 1e9:.2f} TFLOP/s), plain "
        f"{ms('plain_forward')}, sdpa {ms('sdpa_forward')} ((1, BH, N, D) view "
        f"{ms('sdpa_4d_forward')})" + (
            f"; device time a call (torch.profiler): forward kernel "
            f"{t['flash_forward_device']:.4f}, sdpa view {t['sdpa_4d_forward_device']:.4f}"
            if calls > 1 else ""))
    log(f"[flash-time] ({bh}, {n}, {d}) f32: dq kernel {ms('flash_bwd_dq')} (bound "
        f"{b['flash_bwd_dq'][0]:.3f} tensor cores, {b['flash_bwd_dq'][2]:.3f} f32), dk/dv "
        f"kernel {ms('flash_bwd_dkv')} (bound {b['flash_bwd_dkv'][0]:.3f}, "
        f"{b['flash_bwd_dkv'][2]:.3f}); pair {t['bwd_pair']:.3f} ms "
        f"({14 * bh * n * n * d / t['bwd_pair'] / 1e9:.2f} TFLOP/s), sdpa backward alone "
        f"{ms('sdpa_backward')} ((1, BH, N, D) view {ms('sdpa_4d_backward')})")
    log(f"[flash-time] ({bh}, {n}, {d}) f32: forward + backward: kernels {ms('fwd_bwd')} "
        f"(bound {b['flash_forward'][0] + b['backward'][0]:.3f}), plain "
        f"{ms('plain_fwd_bwd')}, sdpa {ms('sdpa_fwd_bwd')}")
    del leaves, graph, leaves4, graph4
    torch.cuda.empty_cache()
    return dict(t, bounds=b, spread=spread)


def phase_flash(device, results) -> None:
    errs = {}
    for bh, n, d, dtype in FLASH_CHECKS:
        errs[(bh, n, d, dtype)] = flash_check(device, bh, n, d, dtype)
    flash_memory(device)
    sdpa_kernels(device, *FLASH_TIMES[1])
    path = errs[(64, 144, 64, torch.float32)]
    log(f"[flash-time] SM clock, max SM clock before the timings: {sm_clocks()}")
    times = {f"{bh}x{n}x{d}": flash_times(device, bh, n, d) for bh, n, d in FLASH_TIMES}
    log(f"[flash-time] SM clock, max SM clock after the timings: {sm_clocks()}")
    log("[flash-time] " + json.dumps({s: {k: v for k, v in t.items() if k != "bounds"}
                                      for s, t in times.items()}))
    t = times[FLASH_PATH_SHAPE]
    pair = "flash_bwd_dq + flash_bwd_dkv"
    for name, err, plain, step, covers in (
            ("flash_forward", max(path["out"], path["lse"]), t["plain_forward"], "forward",
             "flash_forward"),
            ("flash_bwd_dq", path["dq"], t["plain_backward"], "backward", pair),
            ("flash_bwd_dkv", max(path["dk"], path["dv"]), t["plain_backward"], "backward",
             pair)):
        # the faster of SDPA's two layouts, which take different backends
        lib, layout = min((t[f"sdpa_{step}"], "(BH, N, D)"),
                          (t[f"sdpa_4d_{step}"], "(1, BH, N, D)"))
        results[name] = dict(max_abs_err=err, ms=t[name], plain_ms=plain,
                             bound_ms=t["bounds"][name][0], bound_by=t["bounds"][name][1],
                             library_ms=lib, library_call=f"scaled_dot_product_attention "
                             f"{step} on {layout}", library_covers=covers,
                             shape=FLASH_PATH_SHAPE)


CASE4_UNET = {k: CASE4_RECIPE[k] for k in (
    "image_size", "num_channels", "num_res_blocks", "num_heads", "num_head_channels",
    "attention_resolutions", "channel_mult")}


def phase_unet_flash(root, device) -> None:
    """One training_losses forward and backward of the full-width Case4
    U-Net at batch 8 with flash attention on and off: same weights, t and
    noise."""
    state = torch.load(write_assets(root, 10)["ema_path"], weights_only=True)
    diffusion = create_gaussian_diffusion(steps=1000, noise_schedule="cosine")
    gen = torch.Generator(device=device).manual_seed(21)
    x0 = torch.rand((8, 1, 384, 384), generator=gen, device=device) * 2 - 1
    noise = torch.randn(x0.shape, generator=gen, device=device)
    t = torch.tensor([3, 120, 250, 400, 555, 700, 850, 999])
    res = {}
    for flash in (True, False):
        model = tunet.create_model(**CASE4_UNET, use_flash_attention=flash)
        model.load_state_dict(state)
        model.to(device)
        fa.reset_launch_counts()
        loss = diffusion.training_losses(model, x0, t, noise=noise)["loss"]
        loss.mean().backward()
        torch.cuda.synchronize()
        counts = dict(fa.LAUNCHES)
        res[flash] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()})
        log(f"[unet-flash] use_flash_attention={flash}: loss mean {loss.mean().item():.6f}, "
            f"launches {counts}")
        if not (all(v > 0 for v in counts.values()) if flash else not any(counts.values())):
            raise SystemExit(f"flash route launches wrong for use_flash_attention={flash}")
        del model, loss
    loss_rel = rel_l2(res[True][0], res[False][0])
    worst = max((rel_l2(res[True][1][n], res[False][1][n]), n) for n in res[False][1])
    log(f"[unet-flash] Case4 U-Net batch 8, flash vs dense: loss rel L2 {loss_rel:.3e}, worst "
        f"gradient rel L2 {worst[0]:.3e} ({worst[1]}) over {len(res[False][1])} parameters "
        f"(tol {GRAD_REL_TOL})")
    if not (loss_rel <= GRAD_REL_TOL and worst[0] <= GRAD_REL_TOL):
        raise SystemExit("the U-Net's flash route disagrees with the dense route")
    del res
    torch.cuda.empty_cache()


def write_diffusion_case(root, n_train=32, n_valid=8) -> dict:
    """``recipes/diffusion/case4.yml`` as published, with flash attention on,
    on seeded synthetic 384 x 384 latent images; cut to 3 steps, a save
    every 2, a log line every step."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(384)
    for name, n in (("train", n_train), ("valid", n_valid)):
        base = np.sin(np.linspace(0, 8 * np.pi, 384))[None, :, None] * rng.uniform(
            0.5, 1.5, size=(n, 1, 1))
        np.save(os.path.join(root, f"{name}.npy"),
                (base + 0.1 * rng.standard_normal((n, 384, 384))).astype(np.float32))
    with open(RECIPE_DIFFUSION) as f:
        recipe = yaml.safe_load(f)
    recipe.update(use_flash_attention=True, lr_anneal_steps=3, save_interval=2, log_interval=1,
                  log_path=os.path.join(root, "logs"),
                  train_data_path=os.path.join(root, "train.npy"),
                  valid_data_path=os.path.join(root, "valid.npy"))
    return recipe


def _write_yaml(path, recipe) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    return path


def phase_train_diffusion(root) -> tuple[dict, str]:
    """The diffusion training CLI at full Case4 width, then a resume; returns
    the launch counts and the newest EMA file."""
    recipe = write_diffusion_case(os.path.join(root, "diffusion"))
    logs = recipe["log_path"]
    path = _write_yaml(os.path.join(root, "diffusion", "case4.yml"), recipe)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    loop = train_diffusion.main([path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(logs, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    valid = [float(r["valid_mse"]) for r in rows]
    files = sorted(os.listdir(logs))
    log(f"[train-diffusion] Case4 U-Net, batch {loop.batch_size}, 384^2: {loop.step} steps, "
        f"losses {[round(x, 6) for x in losses]}, valid_mse {[round(x, 6) for x in valid]}, "
        f"CLI wall {wall:.1f} s, peak memory {peak:.2f} GiB; launches {counts}; files {files}")
    want = [f"{p}{s:06d}.pt" for s in (2, 3) for p in ("model", "opt", "ema_0.9999_")]
    if not (loop.step == 3 and len(losses) == 3 and all(np.isfinite(losses + valid))
            and set(want) <= set(files)):
        raise SystemExit("diffusion training: wrong step count, non-finite losses or "
                         "missing checkpoints")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise SystemExit(f"diffusion training ran without launching {missing}")

    # ms per step: three more steps of the same loop, in memory only (the
    # files on disk stay as written), each synchronized; then a profile
    data = [next(loop.data)[0] for _ in range(4)]
    step_ms = []
    for batch in data[:3]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loop.run_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"[train-diffusion] ms per training step (train + validation forward, synchronized "
        f"wall, after the CLI's 3): {[round(x, 1) for x in step_ms]}; CLI wall per step "
        f"{wall * 1e3 / 3:.1f} (first step, build and data set-up included)")
    kernels = device_profile("one diffusion training step (Case4, batch 8, flash on)",
                             lambda: loop.run_step(data[3]), top=10)
    busy = sum(ms for ms, _ in kernels.values())
    shares = {"convolutions and matmuls (cuDNN, cuBLAS)": (
                  "conv", "cudnn", "implicit", "winograd", "fft", "gemm", "xmma", "cutlass"),
              "flash kernels": ("flash_",), "optimizer": ("adam", "multi_tensor", "foreach")}
    parts = []
    for label, keys in shares.items():
        ms = sum(m for k, (m, _) in kernels.items()
                 if any(key in k.lower() for key in keys)
                 and (label.startswith("flash") or "flash_" not in k.lower()))
        parts.append(f"{label} {ms:.1f} ms ({ms / max(busy, 1e-9):.1%})")
    log("[profile]   " + ", ".join(parts) + " of busy")
    del loop
    torch.cuda.empty_cache()

    ema3 = torch.load(os.path.join(logs, "ema_0.9999_000003.pt"), weights_only=True)
    resume = dict(recipe, lr_anneal_steps=4,
                  resume_checkpoint=os.path.join(logs, "model000003.pt"))
    fa.reset_launch_counts()
    again = train_diffusion.main([_write_yaml(path, resume)])
    torch.cuda.synchronize()
    for k, v in fa.LAUNCHES.items():
        counts[k] += v
    params4 = torch.load(os.path.join(logs, "model000004.pt"), weights_only=True)
    ema4 = torch.load(os.path.join(logs, "ema_0.9999_000004.pt"), weights_only=True)
    ema_err = max((ema4[k] - (0.9999 * ema3[k] + 0.0001 * params4[k])).abs().max().item()
                  for k in ema4)
    log(f"[train-diffusion] resume: resume step {again.resume_step}, final step {again.step}, "
        f"max |ema4 - (r ema3 + (1 - r) params4)| {ema_err:.3e}; launches {dict(fa.LAUNCHES)}")
    if not (again.resume_step == 3 and again.step == 4 and ema_err <= 1e-6):
        raise SystemExit("the resumed diffusion run did not read back the step or the EMA")
    del again
    torch.cuda.empty_cache()
    return counts, os.path.join(logs, "ema_0.9999_000004.pt")


def phase_train_to_sample(root, ema_path) -> dict:
    """The DPS CLI with the EMA just trained and flash attention on."""
    recipe = dict(write_assets(root, 10), ema_path=ema_path, use_flash_attention=True,
                  save_path=os.path.join(root, "samples_trained.npy"))
    path = _write_yaml(os.path.join(root, "case4_trained.yml"), recipe)
    fa.reset_launch_counts()
    sd.reset_launch_counts()
    timings = sample_conditional.main([path])
    torch.cuda.synchronize()
    counts = {**fa.LAUNCHES, **sd.LAUNCHES}
    fields = np.load(recipe["save_path"])
    T = CASE4_RECIPE["time_length"]
    log(f"[train-sample] fields {fields.shape} from {os.path.basename(ema_path)}, finite "
        f"{bool(np.isfinite(fields).all())}; {timings['steps']} guided steps "
        f"{timings['sample_s'] * 1e3 / timings['steps']:.1f} ms/step; launches {counts}")
    if fields.shape != (1, T, MESH_POINTS, 3) or not np.isfinite(fields).all():
        raise SystemExit("sampling from the trained EMA gave a wrong field")
    missing = [k for k in fa.LAUNCHES if fa.LAUNCHES[k] == 0]
    if missing:
        raise SystemExit(f"sampling with flash on ran without launching {missing}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    device = resolve_device("cuda")
    name, count, smi = phase_device()
    phase_build()
    results = {}
    phase_forward(device, results)
    phase_dz(device, results)
    phase_crossover(device)
    phase_bwd(device, results)
    phase_flash(device, results)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        launches = phase_main_path(root)
        phase_fused_dps(root, device)
        phase_op_grads(device, root)
        for k, v in phase_train(root).items():
            launches[k] += v
        phase_unet_flash(root, device)
        flash_launches, ema_path = phase_train_diffusion(root)
        for k, v in phase_train_to_sample(root, ema_path).items():
            if k in flash_launches:
                flash_launches[k] += v
            else:
                launches[k] += v
    launches.update(flash_launches)

    kernels = []
    for kname, key, src, replaces in (
            ("siren_decode_forward", "siren_decode_forward", "siren_decode.cu",
             "siren_decode.py:96"),
            ("siren_decode_dz", "siren_decode_dz@384x1024", "siren_decode.cu",
             "siren_decode.py:315"),
            ("siren_decode_bwd", "siren_decode_bwd", "siren_decode_bwd.cu",
             "siren_decode.py:434"),
            ("flash_forward", "flash_forward", "flash_attention.cu", "flash_attention.py:56"),
            ("flash_bwd_dq", "flash_bwd_dq", "flash_attention.cu", "flash_attention.py:158"),
            ("flash_bwd_dkv", "flash_bwd_dkv", "flash_attention.cu", "flash_attention.py:188")):
        r = results[key]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"confild_tpu_torch/csrc/{src}",
            "replaces": f"confild_tpu/ops/{replaces}",
            "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"],
            **{k: r[k] for k in ("library_call", "library_covers") if k in r}})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
