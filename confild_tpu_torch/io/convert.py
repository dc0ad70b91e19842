"""Weights carried across: the JAX package's parameter pytrees -> the port's
state dicts, and the loaders for both checkpoint formats.

* A JAX-package ``.ckpt`` is a pickled pytree of numpy arrays (nested dicts
  and lists, ``confild_tpu/io/checkpoint.py:34-69``); it is read with
  ``pickle``, so neither format needs JAX.  Unpickling runs code from the
  file: load only checkpoints you trust.
* A reference ``.pt`` is read with ``torch.load(weights_only=True)``.

Layouts: JAX dense kernels are ``(in, out)`` and become torch ``(out, in)``
weights; JAX conv kernels are ``(*k, in, out)`` (HWIO) and become ``(out,
in, *k)`` (OIHW).  Key names are the reference's
(``confild_tpu/io/torch_export.py:21-34,66-130``); the port's own
``build_plan`` drives the U-Net walk.
"""

from __future__ import annotations

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


def read_ckpt(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


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
