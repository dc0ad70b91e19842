"""Configuration layer: YAML recipes -> attribute-style configs.

Keeps the reference's recipe contract (see reference
``basicutility/ReadInput.py:19-48``): every YAML key becomes an attribute,
class-level defaults fill in missing keys, and nested ``{name:..., kwargs:...}``
blocks are instantiated through an explicit registry (the reference's
``createFn`` contract at ``ReadInput.py:73-139``, made safe: symbols are looked
up in registries rather than by arbitrary module attribute access).  The
port's own copy of ``confild_tpu/config.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

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


def read_yaml(path: str) -> dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def build_component(
    spec: Any,
    registry: Mapping[str, Callable[..., Any]],
    **extra_kwargs: Any,
) -> Any:
    """Instantiate an object from a ``{name:..., kwargs:{...}}`` YAML block.

    This is the reference's ``createFn`` dependency-injection contract
    (``ReadInput.py:73-139``) with a safe explicit registry.  ``spec`` may be:

    * a plain string -> looked up and called with ``extra_kwargs`` only;
    * a mapping with ``name`` and optional ``kwargs`` -> nested ``kwargs``
      values that are themselves ``{name, kwargs}`` blocks are built
      recursively.
    """
    if isinstance(spec, str):
        name, kwargs = spec, {}
    elif isinstance(spec, Mapping):
        name = spec["name"]
        kwargs = dict(spec.get("kwargs", {}))
    else:
        raise TypeError(f"cannot build component from spec of type {type(spec)}")

    if name not in registry:
        raise KeyError(
            f"unknown component {name!r}; known: {sorted(registry)}"
        )

    built_kwargs = {}
    for key, value in kwargs.items():
        if isinstance(value, Mapping) and "name" in value and value["name"] in registry:
            built_kwargs[key] = build_component(value, registry)
        else:
            built_kwargs[key] = value
    built_kwargs.update(extra_kwargs)
    return registry[name](**built_kwargs)
