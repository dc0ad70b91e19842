"""Plain MLP primitives (reference ``cnf/components.py:141-266``: ``MLP``,
``MLP_rezblk``, ``MLP_reznet``; ``confild_tpu/models/mlp.py``) with the
reference's nonlinearity registry (``NLS_AND_INITS``,
``components.py:39-49``): each name's activation and its weight init.

The layers are ``net.i`` ``nn.Linear``s, the JAX pytree's ``{"net": [...]}``
(``io/convert.py::nf_state_dict_from_jax`` carries it across).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from confild_tpu_torch.models.cnf import DEFAULT_W0, normal_, siren_init_, uniform_


def _normal_init(std_of: Callable[[int, int], float]):
    def init(lin: nn.Linear, generator, first: bool) -> None:
        normal_(lin.weight, std_of(lin.in_features, lin.out_features), generator)
        uniform_(lin.bias, 1.0 / math.sqrt(lin.in_features), generator)
    return init


def _sine_init(lin: nn.Linear, generator, first: bool) -> None:
    siren_init_(lin, generator, DEFAULT_W0, first_layer=first)


_KAIMING = _normal_init(lambda fan_in, fan_out: math.sqrt(2.0 / fan_in))
_XAVIER = _normal_init(lambda fan_in, fan_out: math.sqrt(2.0 / (fan_in + fan_out)))

# name -> (activation, init(linear, generator, first_layer)); biases
# uniform ±1/sqrt(in) (the SIREN init's for "sine")
NLS_AND_INITS: dict[str, tuple[Callable, Callable]] = {
    "sine": (lambda x: torch.sin(DEFAULT_W0 * x), _sine_init),
    "relu": (F.relu, _KAIMING),                          # kaiming-normal fan-in
    "sigmoid": (torch.sigmoid, _XAVIER),
    "tanh": (torch.tanh, _XAVIER),
    "selu": (F.selu, _normal_init(lambda fan_in, fan_out: 1.0 / math.sqrt(fan_in))),
    "softplus": (F.softplus, _KAIMING),
    "elu": (F.elu, _normal_init(
        lambda fan_in, fan_out: math.sqrt(1.5505188080679277) / math.sqrt(fan_in))),
    "swish": (F.silu, _XAVIER),
}


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_features: int
    out_features: int
    num_hidden_layers: int
    hidden_features: int
    nonlinearity: str = "relu"
    outermost_linear: bool = True


@dataclasses.dataclass(frozen=True)
class MLPRezConfig(MLPConfig):
    num_layers_per_block: int = 2


class MLP(nn.Module):
    """``MLP`` (an :class:`MLPConfig`) or ``MLP_reznet`` (an
    :class:`MLPRezConfig`: a first layer, ``num_hidden_layers`` blocks of
    ``num_layers_per_block`` layers with 0.5/0.5 skips, a head)."""

    def __init__(self, cfg: MLPConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        n_mid = cfg.num_hidden_layers * getattr(cfg, "num_layers_per_block", 1)
        widths = [cfg.in_features] + [cfg.hidden_features] * (n_mid + 1) + [cfg.out_features]
        self.net = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        init = NLS_AND_INITS[self.cfg.nonlinearity][1]
        for i, lin in enumerate(self.net):
            init(lin, generator, i == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.cfg, MLPRezConfig):
            return mlp_reznet_apply(self, self.cfg, x)
        return mlp_apply(self, self.cfg, x)


def init_mlp(cfg: MLPConfig, generator: torch.Generator | None = None) -> MLP:
    """An ``MLP`` or, for an :class:`MLPRezConfig`, an ``MLP_reznet``."""
    return MLP(cfg, generator)


def mlp_apply(model: MLP, cfg: MLPConfig, x: torch.Tensor) -> torch.Tensor:
    nl = NLS_AND_INITS[cfg.nonlinearity][0]
    for lin in model.net[:-1]:
        x = nl(lin(x))
    x = model.net[-1](x)
    return x if cfg.outermost_linear else nl(x)


def mlp_reznet_apply(model: MLP, cfg: MLPRezConfig, x: torch.Tensor) -> torch.Tensor:
    nl = NLS_AND_INITS[cfg.nonlinearity][0]
    net = model.net
    x = nl(net[0](x))
    idx = 1
    for _ in range(cfg.num_hidden_layers):
        x0 = x
        for _ in range(cfg.num_layers_per_block):
            x = nl(net[idx](x))
            idx += 1
        x = 0.5 * x0 + 0.5 * x
    return net[-1](x)
