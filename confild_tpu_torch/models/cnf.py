"""Conditional neural field decoders (reference
``ConditionalNeuralField/cnf/nf_networks.py``; ``confild_tpu/models/cnf.py``).

State-dict keys are the reference's: ``net1.i.weight`` is ``(out, in)`` and
applied as ``x @ W^T`` (``cnf/components.py:55-76``); ``net2`` is bias-free.
Per modulated layer ``x = sin(w0 * (net1[i](x) + net2[i](z)))``, then a
linear head.  ``num_hidden_layers`` counts the middle hidden-to-hidden
layers like the reference constructor: net1 has ``num_hidden_layers + 2``
layers and net2 ``num_hidden_layers + 1`` (``nf_networks.py:461-467``).

Beside the flagship ``SIRENAutodecoder_film`` this module holds the plain
pieces the zoo builds on (``confild_tpu/models/cnf.py:148-334``): the plain
SIREN, the Fourier feature mapping and the multiplicative filter networks,
each an ``nn.Module`` built from its config dataclass, with an
``*_apply(model, ...)`` function.  A dense layer of the JAX pytree
(``{"kernel": (in, out), "bias"}``) is an ``nn.Linear`` at the same path, so
``io/convert.py::nf_state_dict_from_jax`` carries any of them across.

:data:`NF_REGISTRY` maps a registry name to a factory of ``nn.Module``
decoders; importing :mod:`confild_tpu_torch.models` registers the rest of
the zoo (:mod:`confild_tpu_torch.models.cnf_zoo`), as the JAX package's
``models/__init__.py`` does.  Every decoder has ``reset_parameters(
generator)``, the JAX init's bounds drawn from an explicit generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

DEFAULT_W0 = 30.0


# ---------------------------------------------------------------------------
# initialisation from an explicit generator (the JAX package's bounds)
# ---------------------------------------------------------------------------

def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator | None,
             low: float | None = None) -> None:
    """``t`` uniform on ``[low, bound)`` (``low`` defaults to ``-bound``),
    drawn on the host from ``generator`` and copied to ``t``'s device."""
    low = -bound if low is None else low
    t.copy_(torch.rand(t.shape, generator=generator) * (bound - low) + low)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator | None) -> None:
    t.copy_(torch.randn(t.shape, generator=generator) * std)


@torch.no_grad()
def siren_init_(lin: nn.Linear, generator, w0: float = DEFAULT_W0,
                first_layer: bool = False) -> None:
    """SIREN dense init (``cnf/initialization.py:117-132``): weights uniform
    ``±sqrt(6/in)/w0`` (hidden) or ``±1/in`` (first layer); the bias keeps
    torch's Linear default ``±1/sqrt(in)``."""
    fan_in = lin.in_features
    uniform_(lin.weight, 1.0 / fan_in if first_layer else math.sqrt(6.0 / fan_in) / w0,
             generator)
    if lin.bias is not None:
        uniform_(lin.bias, 1.0 / math.sqrt(fan_in), generator)


def film_layers(in_coord_features: int, in_latent_features: int, out_features: int,
                n_modulated: int, hidden_features: int) -> tuple[nn.ModuleList, nn.ModuleList]:
    """The FiLM decoder's ``net1`` (``n_modulated`` layers and the head) and
    bias-free ``net2``."""
    net1 = nn.ModuleList(
        [nn.Linear(in_coord_features if i == 0 else hidden_features, hidden_features)
         for i in range(n_modulated)] + [nn.Linear(hidden_features, out_features)])
    net2 = nn.ModuleList([nn.Linear(in_latent_features, hidden_features, bias=False)
                          for _ in range(n_modulated)])
    return net1, net2


def film_init_(net1: nn.ModuleList, net2: nn.ModuleList, w0: float, generator) -> None:
    """``init_siren_film``: each net's first layer the SIREN first-layer
    init, the rest the hidden init."""
    for net in (net1, net2):
        for i, lin in enumerate(net):
            siren_init_(lin, generator, w0, first_layer=(i == 0))


def film_forward(net1, net2, coords, latents, w0) -> torch.Tensor:
    x = coords
    for lin1, lin2 in zip(net1[:-1], net2):
        x = torch.sin(w0 * (lin1(x) + lin2(latents)))
    return net1[-1](x)


# ---------------------------------------------------------------------------
# SIRENAutodecoder_film
# ---------------------------------------------------------------------------

class SirenFilm(nn.Module):
    """``SIRENAutodecoder_film``: ``(..., m, c) x (..., 1 | m, l) -> (..., m, out)``."""

    def __init__(self, in_coord_features: int, in_latent_features: int,
                 out_features: int, num_hidden_layers: int,
                 hidden_features: int, w0: float = DEFAULT_W0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w0 = float(w0)
        self.net1, self.net2 = film_layers(in_coord_features, in_latent_features,
                                           out_features, num_hidden_layers + 1,
                                           hidden_features)
        self.reset_parameters(generator)

    @property
    def n_modulated(self) -> int:
        return len(self.net2)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """SIREN init (``cnf/initialization.py:117-132``): hidden weights
        uniform ``±sqrt(6/in)/w0``, first-layer weights ``±1/in``; biases keep
        torch's Linear default ``±1/sqrt(in)``."""
        film_init_(self.net1, self.net2, self.w0, generator)

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
    return film_forward(model.net1, model.net2, coords, latents, w0)


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


# ---------------------------------------------------------------------------
# plain SIREN (zoo parity)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SirenConfig:
    in_features: int
    out_features: int
    num_hidden_layers: int
    hidden_features: int
    w0: float = DEFAULT_W0


class Siren(nn.Module):
    """A plain SIREN: ``num_hidden_layers + 2`` dense layers (``net``), sine
    activations, a linear head."""

    def __init__(self, cfg: SirenConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        widths = ([cfg.in_features] + [cfg.hidden_features] * (cfg.num_hidden_layers + 1)
                  + [cfg.out_features])
        self.net = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for i, lin in enumerate(self.net):
            siren_init_(lin, generator, self.cfg.w0, first_layer=(i == 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return siren_apply(self, x, self.cfg.w0)


def init_siren(cfg: SirenConfig, generator: torch.Generator | None = None) -> Siren:
    return Siren(cfg, generator)


def siren_apply(model: Siren, x: torch.Tensor, w0: float = DEFAULT_W0) -> torch.Tensor:
    for lin in model.net[:-1]:
        x = torch.sin(w0 * lin(x))
    return model.net[-1](x)


# ---------------------------------------------------------------------------
# Fourier feature mapping (reference cnf/components.py:269-342)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FeatureMappingConfig:
    in_features: int
    mode: str = "basic"          # basic | gaussian | positional
    map_size: int = 256          # gaussian feature count
    map_scale: float = 10.0      # gaussian B-matrix scale / positional scale
    num_freqs: int = 7           # positional frequencies

    @property
    def dim(self) -> int:
        if self.mode == "basic":
            return 2 * self.in_features
        if self.mode == "gaussian":
            return 2 * self.map_size
        if self.mode == "positional":
            return 2 * self.in_features * self.num_freqs
        raise ValueError(f"unknown premap mode {self.mode!r}")


class FeatureMapping(nn.Module):
    """The feature map; the ``gaussian`` mode holds its ``B`` matrix ``(in,
    map_size)`` as a parameter, as the JAX pytree does."""

    def __init__(self, cfg: FeatureMappingConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.dim = cfg.dim              # raises on an unknown mode
        if cfg.mode == "gaussian":
            self.B = nn.Parameter(torch.empty(cfg.in_features, cfg.map_size))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        if self.cfg.mode == "gaussian":
            normal_(self.B, self.cfg.map_scale, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return feature_mapping_apply(self, self.cfg, x)


def init_feature_mapping(cfg: FeatureMappingConfig,
                         generator: torch.Generator | None = None) -> FeatureMapping:
    return FeatureMapping(cfg, generator)


def feature_mapping_apply(model: FeatureMapping, cfg: FeatureMappingConfig,
                          x: torch.Tensor) -> torch.Tensor:
    two_pi = 2.0 * math.pi
    if cfg.mode == "basic":
        return torch.cat([torch.sin(two_pi * x), torch.cos(two_pi * x)], dim=-1)
    if cfg.mode == "gaussian":
        proj = two_pi * (x @ model.B)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    if cfg.mode == "positional":
        freqs = (2.0 ** torch.arange(cfg.num_freqs, dtype=x.dtype, device=x.device)
                 * math.pi * cfg.map_scale)
        flat = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)     # (..., c * F)
        return torch.cat([torch.sin(flat), torch.cos(flat)], dim=-1)
    raise ValueError(f"unknown premap mode {cfg.mode!r}")


# ---------------------------------------------------------------------------
# Multiplicative filter networks (FourierNet / GaborNet,
# reference cnf/components.py:346-495)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MFNConfig:
    in_features: int
    out_features: int
    n_layers: int
    hidden_features: int
    input_scale: float = 256.0
    weight_scale: float = 1.0
    # gabor only:
    alpha: float = 6.0
    beta: float = 1.0
    filter_type: str = "fourier"   # fourier | gabor


class FilterLayer(nn.Linear):
    """A Fourier filter (``sin`` of a dense layer), or a Gabor filter with
    its envelope's ``gamma`` ``(out,)`` and centres ``mu`` ``(in, out)``
    (the JAX layout)."""

    def __init__(self, in_features: int, out_features: int, gabor: bool):
        super().__init__(in_features, out_features)
        if gabor:
            self.gamma = nn.Parameter(torch.empty(out_features))
            self.mu = nn.Parameter(torch.empty(in_features, out_features))


def gamma_(t: torch.Tensor, concentration: float, generator) -> None:
    """``t`` Gamma(``concentration``, 1) distributed, as ``jax.random.gamma``."""
    t.copy_(torch._standard_gamma(torch.full(t.shape, float(concentration)),
                                  generator=generator))


class MFN(nn.Module):
    """A multiplicative filter network: ``n_layers + 1`` filters, ``n_layers``
    linears and an ``out`` head."""

    def __init__(self, cfg: MFNConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_features
        self.filters = nn.ModuleList(FilterLayer(cfg.in_features, h, cfg.filter_type == "gabor")
                                     for _ in range(cfg.n_layers + 1))
        self.linears = nn.ModuleList(nn.Linear(h, h) for _ in range(cfg.n_layers))
        self.out = nn.Linear(h, cfg.out_features)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """``init_mfn``: filter weights normal times ``input_scale /
        sqrt(n_layers + 1)``, biases uniform on ``[-pi, pi)``, Gabor
        ``gamma`` Gamma(``alpha / (n_layers + 1)``) / ``beta`` and ``mu``
        uniform on ``[-1, 1)``; linears ``±sqrt(weight_scale / h)`` with zero
        biases; the head ``±sqrt(1 / h)``, zero bias."""
        cfg = self.cfg
        scale_per = cfg.input_scale / math.sqrt(cfg.n_layers + 1)
        for filt in self.filters:
            normal_(filt.weight, scale_per, generator)
            uniform_(filt.bias, math.pi, generator)
            if cfg.filter_type == "gabor":
                gamma_(filt.gamma, cfg.alpha / (cfg.n_layers + 1), generator)
                filt.gamma.div_(cfg.beta)
                uniform_(filt.mu, 1.0, generator)
        for lin in self.linears:
            uniform_(lin.weight, math.sqrt(cfg.weight_scale / cfg.hidden_features), generator)
            lin.bias.zero_()
        uniform_(self.out.weight, math.sqrt(1.0 / cfg.hidden_features), generator)
        self.out.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mfn_apply(self, self.cfg, x)


def init_mfn(cfg: MFNConfig, generator: torch.Generator | None = None) -> MFN:
    return MFN(cfg, generator)


def _mfn_filter_apply(filt: FilterLayer, cfg: MFNConfig, x: torch.Tensor) -> torch.Tensor:
    lin = filt(x)
    if cfg.filter_type == "fourier":
        return torch.sin(lin)
    # gabor: gaussian envelope times sinusoid
    d2 = torch.sum((x[..., None] - filt.mu) ** 2, dim=-2)
    return torch.exp(-0.5 * filt.gamma * d2) * torch.sin(lin)


def mfn_apply(model: MFN, cfg: MFNConfig, x: torch.Tensor) -> torch.Tensor:
    z = _mfn_filter_apply(model.filters[0], cfg, x)
    for filt, lin in zip(model.filters[1:], model.linears):
        z = _mfn_filter_apply(filt, cfg, x) * lin(z)
    return model.out(z)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# Registry (reference registry names from nf_networks.py)
# ---------------------------------------------------------------------------

def _make_film(name: str, cls=SirenFilm) -> Callable[..., SirenFilm]:
    def factory(in_coord_features: int, in_latent_features: int,
                out_features: int, num_hidden_layers: int,
                hidden_features: int, w0: float = DEFAULT_W0,
                **_ignored) -> SirenFilm:
        return cls(in_coord_features, in_latent_features, out_features,
                   num_hidden_layers, hidden_features, w0)
    factory.__name__ = name
    return factory


NF_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "SIRENAutodecoder_film": _make_film("SIRENAutodecoder_film"),
    "SIRENAutodecoder_film_extra_in": _make_film("SIRENAutodecoder_film_extra_in",
                                                 SirenFilmExtraIn),
}


def create_nf(name: str, **kwargs) -> nn.Module:
    if name not in NF_REGISTRY:
        raise KeyError(f"unknown NF model {name!r}; known: {sorted(NF_REGISTRY)}")
    return NF_REGISTRY[name](**kwargs)


def nf_kwargs(nf_spec: dict, dims: int, hidden_size: int) -> dict:
    """A recipe's ``NF:`` block as registry keyword arguments (reference
    ``scripts/train.py:229-240``): its ``kwargs`` when it has them, else
    ``out_features`` / ``num_hidden_layers`` / ``hidden_features`` and the
    SIREN frequency (the reference's ``omega_0``, or ``w0``; default 30);
    the coordinate dims and the ``hidden_size`` latent width fill in."""
    kwargs = dict(nf_spec.get("kwargs", {}))
    if not kwargs:
        kwargs = {k: nf_spec[k] for k in ("out_features", "num_hidden_layers",
                                          "hidden_features")}
        for key in ("omega_0", "w0"):
            if key in nf_spec:
                kwargs["w0"] = float(nf_spec[key])
                break
    kwargs.setdefault("in_coord_features", dims)
    kwargs.setdefault("in_latent_features", hidden_size)
    return kwargs


def siren_film_from_recipe(hp) -> nn.Module:
    """Build the recipe's decoder, any registered name (reference
    ``scripts/train.py:229-240``): coordinate dims and the ``hidden_size``
    latent width come from the top level, the rest from the ``NF:`` block."""
    nf_spec = hp.NF if isinstance(hp.NF, dict) else hp.NF.to_dict()
    return create_nf(nf_spec["name"], **nf_kwargs(nf_spec, hp.dims, hp.hidden_size))
