"""Key-value logger, the part of ``confild_tpu/utils/logger.py`` the CNF
trainer uses (the OpenAI baselines logger the reference vendors at
``src/logger.py``).

Formats: ``stdout`` (aligned table), ``log`` (the same to ``log.txt``),
``json`` (one object per dump in ``progress.json``) and ``csv``
(``progress.csv``, the header rewritten when new keys appear).
``profile_kv`` adds a scope's wall seconds to the ``wait_<name>`` key.
"""

from __future__ import annotations

import csv as _csv
import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Any


class HumanOutputFormat:
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
        for key, val in key2str.items():
            lines.append(f"| {key}{' ' * (keywidth - len(key))} | "
                         f"{val}{' ' * (valwidth - len(val))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    def close(self) -> None:
        if self.own_file:
            self.file.close()


def _truncate(s: str, maxlen: int = 30) -> str:
    return s[: maxlen - 3] + "..." if len(s) > maxlen else s


class JSONOutputFormat:
    def __init__(self, filename: str):
        self.file = open(filename, "at")

    def writekvs(self, kvs: dict) -> None:
        out = {k: float(v) if hasattr(v, "__float__") else v for k, v in kvs.items()}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class CSVOutputFormat:
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

    def close(self) -> None:
        pass


def make_output_format(fmt: str, ev_dir: str, log_suffix: str = ""):
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
        raise NotImplementedError(
            "TensorBoard logging is not ported yet (ROADMAP.md Queue 1, item 12: "
            "analysis and utils)")
    raise ValueError(f"Unknown format specified: {fmt}")


class Logger:
    CURRENT: "Logger | None" = None

    def __init__(self, dir: str | None, output_formats: list):
        self.name2val: dict[str, Any] = {}
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val) -> None:
        self.name2val[key] = val

    def dumpkvs(self) -> dict:
        out = self.name2val.copy()
        for fmt in self.output_formats:
            fmt.writekvs(out)
        self.name2val.clear()
        return out

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


def configure(dir: str | None = None, format_strs: list[str] | None = None,
              log_suffix: str = "") -> Logger:
    """Configure the global logger (``OPENAI_LOGDIR`` / ``OPENAI_LOG_FORMAT``
    honored, as in the reference; without either directory, ``logs`` under
    the working directory).  The port runs one process, so the per-rank
    suffixes of the JAX logger do not arise."""
    if dir is None:
        dir = os.environ.get("OPENAI_LOGDIR") or "logs"
    if format_strs is None:
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


def dumpkvs() -> dict:
    return get_current().dumpkvs()


@contextmanager
def profile_kv(scopename: str):
    with get_current().profile_kv(scopename):
        yield
