"""Configuration layer: YAML recipes -> attribute-style configs.

Keeps the reference's recipe contract (see reference
``basicutility/ReadInput.py:19-48``): every YAML key becomes an attribute and
class-level defaults fill in missing keys.  The port's own copy of
``confild_tpu/config.py``'s ``Config`` / ``basic_input``.
"""

from __future__ import annotations

from typing import Any, Mapping

import yaml


class Config:
    """Attribute-style view over a YAML mapping.

    Mirrors the reference ``basic_input`` semantics: keys become attributes,
    ``defaults`` fills in whatever the file does not provide.  Unknown
    attribute access raises ``AttributeError`` so typos fail loudly.
    """

    defaults: dict[str, Any] = {}

    def __init__(self, source: str | Mapping[str, Any], **overrides: Any):
        if isinstance(source, (str,)):
            with open(source) as f:
                data = yaml.safe_load(f) or {}
        else:
            data = dict(source)
        data.update(overrides)
        merged = {**type(self).defaults, **data}
        self._data = merged
        for key, value in merged.items():
            setattr(self, key, value)

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def to_dict(self) -> dict[str, Any]:
        return dict(self._data)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Config({self._data!r})"


def basic_input(path: str | Mapping[str, Any], **overrides: Any) -> Config:
    """Load a recipe file. Name kept for parity with the reference API."""
    return Config(path, **overrides)
