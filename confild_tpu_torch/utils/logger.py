"""Key-value logger, the port of ``confild_tpu/utils/logger.py`` (the
OpenAI baselines logger the reference vendors at ``src/logger.py``).

Formats: ``stdout`` (aligned table), ``log`` (the same to ``log.txt``),
``json`` (one object per dump in ``progress.json``), ``csv``
(``progress.csv``, the header rewritten when new keys appear) and
``tensorboard`` (scalars under ``tb/``; a writer that writes nothing when
``torch.utils.tensorboard`` does not import).  ``logkv_mean`` keeps a
running mean between dumps; ``profile_kv`` adds a scope's wall seconds to
the ``wait_<name>`` key; ``log`` writes a line to the sequence writers
(``stdout`` and ``log``) at or above the logger's level.
"""

from __future__ import annotations

import csv as _csv
import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Any

DEBUG, INFO, WARN, ERROR, DISABLED = 10, 20, 30, 40, 50


class KVWriter:
    def writekvs(self, kvs: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SeqWriter:
    def writeseq(self, seq) -> None:
        raise NotImplementedError


class HumanOutputFormat(KVWriter, SeqWriter):
    def __init__(self, filename_or_file):
        self.own_file = isinstance(filename_or_file, str)
        self.file = open(filename_or_file, "at") if self.own_file else filename_or_file

    def writekvs(self, kvs: dict) -> None:
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[_truncate(key)] = _truncate(valstr)
        if not key2str:
            return
        keywidth = max(map(len, key2str))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in sorted(key2str.items()):
            lines.append(f"| {key}{' ' * (keywidth - len(key))} | "
                         f"{val}{' ' * (valwidth - len(val))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    def writeseq(self, seq) -> None:
        self.file.write(" ".join(map(str, seq)) + "\n")
        self.file.flush()

    def close(self) -> None:
        if self.own_file:
            self.file.close()


def _truncate(s: str, maxlen: int = 30) -> str:
    return s[: maxlen - 3] + "..." if len(s) > maxlen else s


class JSONOutputFormat(KVWriter):
    def __init__(self, filename: str):
        self.file = open(filename, "at")

    def writekvs(self, kvs: dict) -> None:
        out = {k: float(v) if hasattr(v, "__float__") else v for k, v in kvs.items()}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class CSVOutputFormat(KVWriter):
    def __init__(self, filename: str):
        self.filename = filename
        self.keys: list[str] = []
        self.rows: list[dict] = []

    def writekvs(self, kvs: dict) -> None:
        self.keys.extend(sorted(k for k in kvs if k not in self.keys))
        self.rows.append(dict(kvs))
        with open(self.filename, "wt", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=self.keys, restval="")
            w.writeheader()
            for row in self.rows:
                w.writerow({k: row.get(k, "") for k in self.keys})


class TensorBoardOutputFormat(KVWriter):
    """Scalars to a ``SummaryWriter`` at the dump's ``step`` (or the dump
    count); nothing at all when ``torch.utils.tensorboard`` (which needs the
    ``tensorboard`` package) does not import."""

    def __init__(self, logdir: str):
        self.step = 0
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(logdir)
        except ImportError:
            self.writer = None

    def writekvs(self, kvs: dict) -> None:
        if self.writer is None:
            return
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            if hasattr(v, "__float__"):
                self.writer.add_scalar(k, float(v), step)
        self.writer.flush()
        self.step += 1

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def make_output_format(fmt: str, ev_dir: str, log_suffix: str = "") -> KVWriter:
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "log":
        return HumanOutputFormat(os.path.join(ev_dir, f"log{log_suffix}.txt"))
    if fmt == "json":
        return JSONOutputFormat(os.path.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(os.path.join(ev_dir, f"progress{log_suffix}.csv"))
    if fmt in ("tensorboard", "tensorboard_new"):
        return TensorBoardOutputFormat(os.path.join(ev_dir, f"tb{log_suffix}"))
    raise ValueError(f"Unknown format specified: {fmt}")


class Logger:
    CURRENT: "Logger | None" = None

    def __init__(self, dir: str | None, output_formats: list):
        self.name2val: dict[str, Any] = {}
        self.name2cnt: dict[str, int] = {}
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val) -> None:
        self.name2val[key] = val

    def logkv_mean(self, key, val) -> None:
        oldval, cnt = self.name2val.get(key, 0), self.name2cnt.get(key, 0)
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self) -> dict:
        out = self.name2val.copy()
        for fmt in self.output_formats:
            fmt.writekvs(out)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args, level: int = INFO) -> None:
        if self.level <= level:
            for fmt in self.output_formats:
                if isinstance(fmt, SeqWriter):
                    fmt.writeseq(map(str, args))

    def set_level(self, level: int) -> None:
        self.level = level

    def close(self) -> None:
        for fmt in self.output_formats:
            fmt.close()

    @contextmanager
    def profile_kv(self, scopename: str):
        key = f"wait_{scopename}"
        start = time.time()
        try:
            yield
        finally:
            self.name2val[key] = self.name2val.get(key, 0) + time.time() - start


def _process_index() -> int:
    """This process's rank: ``torch.distributed``'s when it is initialized,
    else 0."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def configure(dir: str | None = None, format_strs: list[str] | None = None,
              log_suffix: str = "") -> Logger:
    """Configure the global logger (``OPENAI_LOGDIR`` / ``OPENAI_LOG_FORMAT``
    honored, as in the reference; without either directory, ``logs`` under
    the working directory).  A process of rank > 0 gets a ``-rank{i}`` file
    suffix and the formats of ``OPENAI_LOG_FORMAT_MPI`` (default ``log``),
    as in the reference (``logger.py:481-489``)."""
    if dir is None:
        dir = os.environ.get("OPENAI_LOGDIR") or "logs"
    rank = _process_index()
    if rank > 0:
        log_suffix = f"{log_suffix}-rank{rank:03d}"
        format_strs = os.environ.get("OPENAI_LOG_FORMAT_MPI", "log").split(",")
    elif format_strs is None:
        format_strs = os.environ.get("OPENAI_LOG_FORMAT", "stdout,log,csv").split(",")
    Logger.CURRENT = Logger(dir, [make_output_format(f, dir, log_suffix)
                                  for f in format_strs if f])
    return Logger.CURRENT


def get_current() -> Logger:
    if Logger.CURRENT is None:
        configure(format_strs=["stdout"])
    return Logger.CURRENT


def logkv(key, val) -> None:
    get_current().logkv(key, val)


def logkv_mean(key, val) -> None:
    get_current().logkv_mean(key, val)


def dumpkvs() -> dict:
    return get_current().dumpkvs()


@contextmanager
def profile_kv(scopename: str):
    with get_current().profile_kv(scopename):
        yield


def log(*args, **kwargs) -> None:
    get_current().log(*args, **kwargs)


def set_level(level: int) -> None:
    get_current().set_level(level)


def profile(fn):
    """Time every call of ``fn`` into ``wait_<fn name>``."""
    def wrapped(*args, **kwargs):
        with profile_kv(fn.__name__):
            return fn(*args, **kwargs)
    return wrapped


def get_logger(name: str = "DPS"):
    """Tiny stdlib logger (reference ``src/util/logger.py`` get_logger)."""
    import logging
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s [%(name)s] >> %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger
