"""Weights carried across: the JAX package's parameter pytrees -> the port's
state dicts, and the loaders for both checkpoint formats.

* A JAX-package ``.ckpt`` is a pickled pytree of numpy arrays (nested dicts
  and lists, ``confild_tpu/io/checkpoint.py:34-69``).  A CNF checkpoint
  also pickles its optax optimizer states (``cnf_trainer.py:622-631``),
  whose classes live in ``optax`` and import JAX.  :func:`read_ckpt`
  unpickles with :class:`CkptUnpickler`, which maps every ``optax`` class
  to a plain stand-in (:class:`OptaxState`) and refuses any class other
  than numpy's array types, so reading a ``.ckpt`` never imports optax or
  JAX.  Load only checkpoints you trust all the same.
* A reference ``.pt`` is read with ``torch.load(weights_only=True)``.

Layouts: JAX dense kernels are ``(in, out)`` and become torch ``(out, in)``
weights; JAX conv kernels are ``(*k, in, out)`` (HWIO) and become ``(out,
in, *k)`` (OIHW).  Key names are the reference's
(``confild_tpu/io/torch_export.py:21-34,66-130``); the port's own
``build_plan`` drives the U-Net walk.
"""

from __future__ import annotations

import functools
import importlib
import operator
import os
import pickle
from typing import Any

import numpy as np
import torch

from confild_tpu_torch.models.unet import (AttnSpec, ConvSpec, DownSpec,
                                          ResSpec, UNetModel, UpSpec)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a contiguous, writable copy


def _dense(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.moveaxis(np.asarray(p["kernel"]), (-1, -2), (0, 1)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _group_norm(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def cnf_state_dict_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """``{"net1": [...], "net2": [...]}`` -> ``SirenFilm`` state dict."""
    sd: dict[str, torch.Tensor] = {}
    for i, layer in enumerate(params["net1"]):
        _dense(sd, f"net1.{i}", layer)
    for i, layer in enumerate(params["net2"]):
        sd[f"net2.{i}.weight"] = _t(np.asarray(layer["kernel"]).T)
    return sd


def _unet_layer(sd: dict, prefix: str, p: dict, spec) -> None:
    if isinstance(spec, ConvSpec):
        _conv(sd, prefix, p["conv"])
    elif isinstance(spec, ResSpec):
        _group_norm(sd, f"{prefix}.in_layers.0", p["in_norm"])
        _conv(sd, f"{prefix}.in_layers.2", p["in_conv"])
        _dense(sd, f"{prefix}.emb_layers.1", p["emb"])
        _group_norm(sd, f"{prefix}.out_layers.0", p["out_norm"])
        _conv(sd, f"{prefix}.out_layers.3", p["out_conv"])
        if "skip" in p:
            _conv(sd, f"{prefix}.skip_connection", p["skip"])
    elif isinstance(spec, AttnSpec):
        _group_norm(sd, f"{prefix}.norm", p["norm"])
        _conv(sd, f"{prefix}.qkv", p["qkv"])
        _conv(sd, f"{prefix}.proj_out", p["proj"])
    elif isinstance(spec, UpSpec):
        if "conv" in p:
            _conv(sd, f"{prefix}.conv", p["conv"])
    elif isinstance(spec, DownSpec):
        if "conv" in p:
            _conv(sd, f"{prefix}.op", p["conv"])
    else:
        raise TypeError(spec)


def unet_state_dict_from_jax(params: Any, model: UNetModel) -> dict[str, torch.Tensor]:
    """JAX U-Net params -> ``UNetModel`` state dict, walking ``model.plan``."""
    sd: dict[str, torch.Tensor] = {}
    _dense(sd, "time_embed.0", params["time_embed"][0])
    _dense(sd, "time_embed.2", params["time_embed"][1])
    plan = model.plan
    for i, (bp, bs) in enumerate(zip(params["input_blocks"], plan.input_blocks)):
        for j, (p, spec) in enumerate(zip(bp, bs)):
            _unet_layer(sd, f"input_blocks.{i}.{j}", p, spec)
    for j, (p, spec) in enumerate(zip(params["middle_block"], plan.middle_block)):
        _unet_layer(sd, f"middle_block.{j}", p, spec)
    for i, (bp, bs) in enumerate(zip(params["output_blocks"], plan.output_blocks)):
        for j, (p, spec) in enumerate(zip(bp, bs)):
            _unet_layer(sd, f"output_blocks.{i}.{j}", p, spec)
    _group_norm(sd, "out.0", params["out_norm"])
    _conv(sd, "out.2", params["out_conv"])
    return sd


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def read_pt(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


class OptaxState(tuple):
    """Stand-in for a pickled optax state (a NamedTuple): the field values
    in order, and by name where the class is known (``count``, ``mu``,
    ``nu`` of ``ScaleByAdamState``)."""

    def __new__(cls, *values):
        return super().__new__(cls, values)


_OPTAX_FIELDS = {"ScaleByAdamState": ("count", "mu", "nu"),
                 "ScaleByScheduleState": ("count",)}


@functools.cache
def _optax_stand_in(module: str, name: str) -> type:
    ns = {f: property(operator.itemgetter(i))
          for i, f in enumerate(_OPTAX_FIELDS.get(name, ()))}
    return type(name, (OptaxState,), {**ns, "__module__": __name__})


# what numpy pickles arrays, scalars and dtypes with
_NUMPY_NAMES = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}


class CkptUnpickler(pickle.Unpickler):
    """Unpickler for the JAX package's ``.ckpt`` files that needs neither
    JAX nor optax: numpy arrays and Python containers as usual, optax
    states as :class:`OptaxState` stand-ins, any other class refused."""

    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root == "optax":
            return _optax_stand_in(module, name)
        if root == "numpy" and name in _NUMPY_NAMES:
            try:
                mod = importlib.import_module(module)
            except ImportError:     # written by numpy 2 (numpy._core), read by numpy 1
                mod = importlib.import_module(module.replace("numpy._core", "numpy.core"))
            return getattr(mod, name)
        raise pickle.UnpicklingError(
            f"{module}.{name} is not allowed in a .ckpt file: the port reads numpy "
            f"arrays, Python containers and optax states only")


def read_ckpt(path: str) -> Any:
    with open(path, "rb") as f:
        return CkptUnpickler(f).load()


def _find_adam(state) -> OptaxState | None:
    if isinstance(state, OptaxState) and type(state).__name__ == "ScaleByAdamState":
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state, layout: str = "decoder") -> dict[str, dict[str, torch.Tensor]]:
    """``torch.optim.Adam`` per-parameter state from a pickled optax Adam
    state (``ScaleByAdamState`` inside the ``optax.adam`` chain):
    ``{name: {"step", "exp_avg", "exp_avg_sq"}}``.

    ``layout="decoder"``: ``mu`` / ``nu`` are parameter pytrees and go
    through :func:`cnf_state_dict_from_jax` (kernels transposed), keyed by
    the ``SirenFilm`` state-dict names.  ``layout="latents"``: one table,
    keyed ``"latents"``."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState in the optimizer state")
    if layout == "decoder":
        mu, nu = cnf_state_dict_from_jax(adam.mu), cnf_state_dict_from_jax(adam.nu)
    elif layout == "latents":
        mu, nu = {"latents": _t(adam.mu)}, {"latents": _t(adam.nu)}
    else:
        raise ValueError(f"unknown layout {layout!r}")
    step = float(np.asarray(adam.count))
    return {k: {"step": torch.tensor(step), "exp_avg": mu[k], "exp_avg_sq": nu[k]}
            for k in mu}


def _strip_module(sd: dict) -> dict:
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def latents_from_hidden_states(hidden_states) -> np.ndarray:
    """Latent table of a CNF checkpoint: the module-state layout
    ``{"latents": (N, F)}`` or the published raw tensor, which may carry
    broadcast singleton dims ``(N, 1, ..., F)``
    (``inference_function.py:182-212``)."""
    if isinstance(hidden_states, dict):
        if "latents" in hidden_states:
            hidden_states = hidden_states["latents"]
        else:
            (hidden_states,) = hidden_states.values()
    arr = _numpy(hidden_states)
    return arr.reshape(arr.shape[0], arr.shape[-1]) if arr.ndim > 2 else arr


def load_cnf_checkpoint(path: str) -> tuple[dict, np.ndarray | None]:
    """(SirenFilm state dict, latents or None) from ``.pt`` or ``.ckpt``."""
    if path.endswith(".pt"):
        ck = read_pt(path)
        state = _strip_module(ck["model_state_dict"])
    else:
        ck = read_ckpt(path)
        state = cnf_state_dict_from_jax(ck["model_state_dict"])
    hs = ck.get("hidden_states")
    return state, (None if hs is None else latents_from_hidden_states(hs))


def load_normalizer_file(path: str) -> dict[str, tuple[np.ndarray, ...]]:
    """Normalizer params file (``.pt`` or ``.ckpt``) as numpy, with the
    file's own keys (``x_normalizer_params``, ``y_normalizer0u_params``...)."""
    raw = read_pt(path) if path.endswith(".pt") else read_ckpt(path)
    return {k: (tuple(_numpy(a) for a in v) if isinstance(v, (tuple, list)) else _numpy(v))
            for k, v in raw.items()}


def load_normalizer_pair(checkpoint_path: str):
    """(x params, y params) from the ``normalizer_params`` file that must sit
    next to a CNF checkpoint (reference ``inference_function.py:147-159``)."""
    ckpt_dir = os.path.dirname(os.path.abspath(checkpoint_path))
    for name in ("normalizer_params.ckpt", "normalizer_params.pt"):
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            raw = load_normalizer_file(path)
            return raw["x_normalizer_params"], raw["y_normalizer_params"]
    raise FileNotFoundError(f"normalizer_params not found next to {checkpoint_path}")


def load_unet_state_dict(path: str, model: UNetModel) -> dict[str, torch.Tensor]:
    """U-Net weights from a reference ``.pt`` state dict or a JAX ``.ckpt``."""
    if path.endswith(".pt"):
        return _strip_module(read_pt(path))
    return unet_state_dict_from_jax(read_ckpt(path), model)
