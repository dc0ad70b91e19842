"""SIREN-FiLM conditional neural field decoder (reference
``ConditionalNeuralField/cnf/nf_networks.py:455-495``).

State-dict keys are the reference's: ``net1.i.weight`` is ``(out, in)`` and
applied as ``x @ W^T`` (``cnf/components.py:55-76``); ``net2`` is bias-free.
Per modulated layer ``x = sin(w0 * (net1[i](x) + net2[i](z)))``, then a
linear head.  ``num_hidden_layers`` counts the middle hidden-to-hidden
layers like the reference constructor: net1 has ``num_hidden_layers + 2``
layers and net2 ``num_hidden_layers + 1`` (``nf_networks.py:461-467``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

DEFAULT_W0 = 30.0


class SirenFilm(nn.Module):
    """``SIRENAutodecoder_film``: ``(..., m, c) x (..., 1 | m, l) -> (..., m, out)``."""

    def __init__(self, in_coord_features: int, in_latent_features: int,
                 out_features: int, num_hidden_layers: int,
                 hidden_features: int, w0: float = DEFAULT_W0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w0 = float(w0)
        n_mod = num_hidden_layers + 1
        self.net1 = nn.ModuleList(
            [nn.Linear(in_coord_features if i == 0 else hidden_features,
                       hidden_features) for i in range(n_mod)]
            + [nn.Linear(hidden_features, out_features)])
        self.net2 = nn.ModuleList(
            [nn.Linear(in_latent_features, hidden_features, bias=False)
             for _ in range(n_mod)])
        self.reset_parameters(generator)

    @property
    def n_modulated(self) -> int:
        return len(self.net2)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """SIREN init (``cnf/initialization.py:117-132``): hidden weights
        uniform ``±sqrt(6/in)/w0``, first-layer weights ``±1/in``; biases keep
        torch's Linear default ``±1/sqrt(in)``."""
        def uniform_(t, bound):
            t.copy_(torch.rand(t.shape, generator=generator) * 2 * bound - bound)

        for net in (self.net1, self.net2):
            for i, lin in enumerate(net):
                fan_in = lin.in_features
                uniform_(lin.weight, 1.0 / fan_in if i == 0
                         else math.sqrt(6.0 / fan_in) / self.w0)
                if lin.bias is not None:
                    uniform_(lin.bias, 1.0 / math.sqrt(fan_in))

    def forward(self, coords: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        return siren_film_apply(self, coords, latents, self.w0)

    @classmethod
    def from_state_dict(cls, state_dict: dict, w0: float = DEFAULT_W0) -> "SirenFilm":
        """Build a decoder whose shapes are read off a reference state dict."""
        sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
        n1 = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("net1."))
        hidden, in_coord = sd["net1.0.weight"].shape
        model = cls(in_coord_features=in_coord,
                    in_latent_features=sd["net2.0.weight"].shape[1],
                    out_features=sd[f"net1.{n1 - 1}.weight"].shape[0],
                    num_hidden_layers=n1 - 2, hidden_features=hidden, w0=w0)
        model.load_state_dict(sd)
        return model


def siren_film_apply(model: SirenFilm, coords: torch.Tensor,
                     latents: torch.Tensor, w0: float = DEFAULT_W0) -> torch.Tensor:
    """Reference-semantics forward (``nf_networks.py:480-495``): ``coords``
    ``(..., m, c)``, ``latents`` broadcastable to ``(..., 1, l)``."""
    x = coords
    for lin1, lin2 in zip(model.net1[:-1], model.net2):
        x = torch.sin(w0 * (lin1(x) + lin2(latents)))
    return model.net1[-1](x)


def siren_film_extra_in_apply(model: SirenFilm, coords, latents,
                              w0: float = DEFAULT_W0) -> torch.Tensor:
    """``SIRENAutodecoder_film_extra_in`` (``nf_networks.py:503-508``):
    ``coords`` is a pair ``(spatial_coords, extra_scalar)``; the scalar
    (broadcastable, e.g. per-sample ``(B, 1, 1)``) is prepended as a
    constant coordinate channel."""
    spatial, extra = coords
    extra_chan = torch.ones_like(spatial[..., :1]) * extra
    spatial_b = spatial.expand(*extra_chan.shape[:-1], spatial.shape[-1])
    return siren_film_apply(model, torch.cat([extra_chan, spatial_b], dim=-1), latents, w0)


class SirenFilmExtraIn(SirenFilm):
    """``SIRENAutodecoder_film_extra_in``: the SIREN-FiLM decoder, its
    ``in_coord_features`` counting the extra channel, called with a
    ``(spatial_coords, extra_scalar)`` pair.  Its state-dict keys are the
    plain decoder's."""

    def forward(self, coords, latents: torch.Tensor) -> torch.Tensor:
        return siren_film_extra_in_apply(self, coords, latents, self.w0)


def _make_film(name: str, cls=SirenFilm) -> Callable[..., SirenFilm]:
    def factory(in_coord_features: int, in_latent_features: int,
                out_features: int, num_hidden_layers: int,
                hidden_features: int, w0: float = DEFAULT_W0,
                **_ignored) -> SirenFilm:
        return cls(in_coord_features, in_latent_features, out_features,
                   num_hidden_layers, hidden_features, w0)
    factory.__name__ = name
    return factory


NF_REGISTRY: dict[str, Callable[..., SirenFilm]] = {
    "SIRENAutodecoder_film": _make_film("SIRENAutodecoder_film"),
    "SIRENAutodecoder_film_extra_in": _make_film("SIRENAutodecoder_film_extra_in",
                                                 SirenFilmExtraIn),
}


def create_nf(name: str, **kwargs) -> SirenFilm:
    if name not in NF_REGISTRY:
        raise KeyError(f"unknown NF model {name!r}; known: {sorted(NF_REGISTRY)}")
    return NF_REGISTRY[name](**kwargs)


def siren_film_from_recipe(hp) -> SirenFilm:
    """Build the NF from a CNF recipe (reference ``scripts/train.py:229-240``):
    coordinate dims and the ``hidden_size`` latent width come from the top
    level, the rest from the ``NF:`` block."""
    nf_spec = hp.NF if isinstance(hp.NF, dict) else hp.NF.to_dict()
    kwargs = dict(nf_spec.get("kwargs", {}))
    if not kwargs:
        kwargs = {
            "out_features": nf_spec["out_features"],
            "num_hidden_layers": nf_spec["num_hidden_layers"],
            "hidden_features": nf_spec["hidden_features"],
        }
        # the reference's NF block names the SIREN frequency ``omega_0``
        # (nf_networks.py:18,40-41); default 30 when absent
        for key in ("omega_0", "w0"):
            if key in nf_spec:
                kwargs["w0"] = float(nf_spec[key])
                break
    kwargs.setdefault("in_coord_features", hp.dims)
    kwargs.setdefault("in_latent_features", hp.hidden_size)
    return create_nf(nf_spec["name"], **kwargs)
