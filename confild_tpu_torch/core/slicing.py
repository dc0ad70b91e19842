"""String slice DSL: ``"3:-1:2"``-style per-axis specs -> tuple of slices.

The port's own copy of ``confild_tpu/core/slicing.py`` (the reference
``basicutility/slicetools.py:4-36`` contract): each element of the spec list
is either a slice string (``"a:b"`` / ``"a:b:c"`` / ``":"``), an int index,
or a list of advanced indices.
"""

from __future__ import annotations

from typing import Any, Sequence


def _parse_part(part: str):
    part = part.strip()
    return None if part == "" else int(part)


def indices2slice(specs: Sequence[Any]) -> tuple:
    out: list[Any] = []
    for spec in specs:
        if isinstance(spec, str):
            parts = spec.split(":")
            if len(parts) == 1:
                out.append(int(parts[0]))
            elif len(parts) <= 3:
                out.append(slice(*[_parse_part(p) for p in parts]))
            else:
                raise ValueError(f"bad slice spec {spec!r}")
        elif isinstance(spec, int):
            out.append(spec)
        elif isinstance(spec, (list, tuple)):
            out.append(list(spec))
        else:
            raise TypeError(f"bad slice spec of type {type(spec)}")
    return tuple(out)
