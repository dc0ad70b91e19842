"""Tracing and profiling helpers, the port of ``confild_tpu/utils/
profiling.py`` (SURVEY §5.1).

The reference's observability is the KV logger's ``profile_kv`` timers plus
grad/param norms (``src/logger.py:318-348``, ``fp16_util.py:217-225``); the
device-level counterparts here:

* :func:`trace` — ``torch.profiler`` over a scope, the trace written to a
  log directory in TensorBoard's format (CPU and, where there is one, CUDA
  activity),
* :func:`annotate` — a named ``record_function`` scope that shows in the
  trace,
* :func:`device_memory_stats` — the card's allocator statistics (empty on
  the CPU),
* :class:`StepTimer` — a host-side step-time EMA reported into the KV logger,
  synchronizing the device it is given so that each tick times the work.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any

import torch

from confild_tpu_torch.device import synchronize
from confild_tpu_torch.utils import logger as tlog


@contextmanager
def trace(logdir: str):
    """Profile the scope and write the trace under ``logdir`` for
    TensorBoard's profile plugin."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def annotate(name: str):
    """Named scope that shows up in the trace."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict[str, Any]:
    """Memory of every CUDA device (bytes in use, peak, the device's total);
    an empty dict without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def log_memory(prefix: str = "mem") -> None:
    for stats in device_memory_stats().values():
        if stats.get("bytes_in_use") is not None:
            tlog.logkv(f"{prefix}_gb", stats["bytes_in_use"] / 2**30)
            break


class StepTimer:
    """EMA step timer; call ``tick()`` once per step.  With a CUDA
    ``device`` each tick first waits for the device's queued work."""

    def __init__(self, decay: float = 0.9, device: torch.device | str = "cpu"):
        self.decay = decay
        self.device = torch.device(device)
        self.last = None
        self.ema = None

    def tick(self) -> float | None:
        synchronize(self.device)
        now = time.perf_counter()
        if self.last is not None:
            dt = now - self.last
            self.ema = dt if self.ema is None else (
                self.decay * self.ema + (1 - self.decay) * dt)
            tlog.logkv("step_time_s", self.ema)
        self.last = now
        return self.ema
