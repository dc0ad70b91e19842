#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``confild_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` compiles ``confild_tpu_torch/csrc/*.cu`` (timed);
3. forward decode kernel against its plain version at Case4 widths
   (SIREN-FiLM 3 -> 384 x 16 modulated layers -> 3, w0 30), 16 rows x 262144
   points, both held to a float64 run under the JAX tests' criterion
   ``err_kernel <= 2 * err_plain_f32 + 1e-6``; times and the roofline bound;
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
   L2 error of 1e-3.

The script imports nothing of JAX or of ``confild_tpu``.  With no CUDA
device it exits non-zero and prints no result.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists every kernel.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.cli import sample_conditional
from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.guidance import (create_sampler, get_conditioning_method,
                                        get_noise, get_operator)
from confild_tpu_torch.guidance.operators import FUSED_MIN_PAIRS
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.models.cnf import SirenFilm
from confild_tpu_torch.ops import cuda_build
from confild_tpu_torch.ops import siren_decode as sd

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

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
# flops of one sin2pi activation in the kernels: round-reduce (2), square (1),
# five FMAs (10), final multiply (1), FiLM add (1)
ACT_FLOPS = 15


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi[0]}")
    return name, count, smi[0]


def phase_build():
    t0 = time.perf_counter()
    path = cuda_build.build("siren_decode")
    dt = time.perf_counter() - t0
    log(f"[build] {path.name} in {dt:.2f} s")
    for line in cuda_build.build_logs.get("siren_decode", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] {line.strip()}")


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
        ms = cuda_ms(lambda: sd.decode_forward(coords, z, *ops), reps=3)
        plain_ms = cuda_ms(lambda: sd.decode_forward_plain(coords, z, *ops), reps=3)
    n_mod, h, c_in, c_out = z.shape[0], 384, 3, 3
    pairs = rows * points
    flops = pairs * (2 * h * (c_in + (n_mod - 1) * h + c_out) + ACT_FLOPS * h * n_mod)
    nbytes = 4 * (points * c_in + n_mod * rows * h + c_in * h + (n_mod - 1) * h * h
                  + h * c_out + c_out + pairs * c_out)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[forward] kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by}); kernel {flops / ms / 1e9:.2f} TFLOP/s")
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
            ms = cuda_ms(lambda: sd.decode_dz(coords, z, g, *ops), reps=5)
            plain_ms = cuda_ms(lambda: sd.decode_dz_plain(coords, z, g, *ops), reps=3)
        n_mod, h, c_in, c_out = z.shape[0], 384, 3, 3
        pairs = rows * points
        flops = pairs * (2 * h * (c_in + 2 * (n_mod - 1) * h + c_out)
                         + (2 * ACT_FLOPS + 2) * h * n_mod)
        nbytes = 4 * (points * c_in + n_mod * rows * h + pairs * c_out + c_in * h
                      + (n_mod - 1) * h * h + h * c_out + n_mod * rows * h)
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"[dz] {rows}x{points}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by})")
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

        t_plain = cuda_ms(plain, reps=5)
        t_fused = cuda_ms(fused, reps=5)
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
    """Device time of one guided step by kernel (torch.profiler) and the
    device's busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    busy = sum(ms for ms, _ in kernels.values())
    conv = sum(ms for k, (ms, _) in kernels.items()
               if "conv" in k.lower() or "cudnn" in k.lower() or "implicit" in k.lower())
    log(f"[profile] one guided step (plain decode): wall {wall_ms:.1f} ms under the "
        f"profiler, device busy {busy:.1f} ms ({busy / wall_ms:.1%}), convolution "
        f"kernels {conv:.1f} ms ({conv / max(busy, 1e-9):.1%} of busy), "
        f"{sum(n for _, n in kernels.values())} kernel launches")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile]   {ms:9.2f} ms  x{n:<5d} {name[:100]}")


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
        step_ms[use_pallas] = cuda_ms(
            lambda: sampler._one_step(model, x_prev, t, y, method, noise=noise,
                                      measurement_noise=torch.zeros_like(y)), reps=3)
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        launches = phase_main_path(root)
        phase_fused_dps(root, device)

    kernels = []
    for kname, key, line in (("siren_decode_forward", "siren_decode_forward", 96),
                             ("siren_decode_dz", "siren_decode_dz@384x1024", 315)):
        r = results[key]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "confild_tpu_torch/csrc/siren_decode.cu",
            "replaces": f"confild_tpu/ops/siren_decode.py:{line}",
            "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
