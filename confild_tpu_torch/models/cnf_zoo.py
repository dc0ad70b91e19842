"""The rest of the neural-field decoder zoo (reference
``ConditionalNeuralField/cnf/nf_networks.py``; ``confild_tpu/models/
cnf_zoo.py``), registered into :data:`confild_tpu_torch.models.cnf.
NF_REGISTRY` under the reference names:

* ``SIRENAutodecoder_film_single``: a plain SIREN, with optional per-layer
  additive latents (``nf_networks.py:228-302``);
* ``SIREN_rez_Autodecoder_film``: residual FiLM blocks with a 0.5/0.5 skip
  (``:305-377``);
* ``SIRENAutodecoder_tw_film``: FiLM SIREN with a trainable ``w0``
  (``:379-438``, ``Sine_tw`` at ``components.py:27-33``);
* ``FNAutodecoder_film`` / ``GNAutodecoder_film``: multiplicative filter
  (Fourier / Gabor) FiLM decoders (``:511-645``);
* ``SIRENAutodecoder_fp``: a hypernetwork head emits the whole SIREN
  parameter vector per latent (``:647-765``);
* ``SIRENAutodecoder_mdf_film`` (and ``_extra_in``): FiLM plus a
  per-latent full-projection weight modulation (``:767-845``);
* ``SIRENAutoencoder_film`` (and ``_extra_in``) / ``SIRENAutoencoder_fp``:
  a sine MLP encodes priors to latents; they return ``(out, latents)`` and
  ``(out, latent, params_vec)`` (``:12-226``).

Each is an ``nn.Module`` whose submodules sit at the JAX pytree's paths
(``net1``, ``net2``, ``filters``, ``hw_net``, ``hb_net``, ``hyper_last``,
``w0``...), ``forward(coords, latents)``, and ``reset_parameters(generator)``
with the JAX init's bounds.  The decoders run on the plain route (autograd
over PyTorch ops), as every non-FiLM decoder does in the JAX package; the
SIREN kernels take ``SIRENAutodecoder_film`` only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from confild_tpu_torch.models.cnf import (DEFAULT_W0, NF_REGISTRY, FilterLayer, film_forward,
                                          film_init_, film_layers, gamma_, siren_init_,
                                          uniform_)


def _extra_in(coords):
    """``(spatial, extra)`` -> the extra scalar prepended as a channel
    (``cnf_zoo.py:49-52``: ``spatial`` is not broadcast)."""
    spatial, extra = coords
    return torch.cat([torch.ones_like(spatial[..., :1]) * extra, spatial], dim=-1)


def _linears(widths, bias: bool = True) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(a, b, bias=bias) for a, b in zip(widths[:-1], widths[1:]))


# ---------------------------------------------------------------------------
# SIRENAutodecoder_film_single
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SirenSingleConfig:
    in_coord_features: int
    out_features: int
    num_hidden_layers: int
    hidden_features: int
    w0: float = DEFAULT_W0


class SirenSingle(nn.Module):
    def __init__(self, cfg: SirenSingleConfig):
        super().__init__()
        self.cfg = cfg
        self.net1 = _linears([cfg.in_coord_features]
                             + [cfg.hidden_features] * (cfg.num_hidden_layers + 1)
                             + [cfg.out_features])
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for i, lin in enumerate(self.net1):
            siren_init_(lin, generator, self.cfg.w0, first_layer=(i == 0))

    def forward(self, coords, all_latents=None):
        """``all_latents[i]`` (when given) is added before layer ``i``'s sine."""
        x = coords
        for i, lin in enumerate(self.net1[:-1]):
            x = lin(x)
            if all_latents is not None:
                x = x + all_latents[i]
            x = torch.sin(self.cfg.w0 * x)
        return self.net1[-1](x)


# ---------------------------------------------------------------------------
# SIREN_rez_Autodecoder_film
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SirenRezConfig:
    in_coord_features: int
    in_latent_features: int
    out_features: int
    num_hidden_blocks: int
    hidden_features: int
    num_hidden_layers_rez: int = 2
    w0: float = DEFAULT_W0


class SirenRez(nn.Module):
    def __init__(self, cfg: SirenRezConfig):
        super().__init__()
        self.cfg = cfg
        n_mod = cfg.num_hidden_blocks * cfg.num_hidden_layers_rez + 1
        self.net1, self.net2 = film_layers(cfg.in_coord_features, cfg.in_latent_features,
                                           cfg.out_features, n_mod, cfg.hidden_features)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        film_init_(self.net1, self.net2, self.cfg.w0, generator)

    def forward(self, coords, latents):
        cfg, net1, net2, w0 = self.cfg, self.net1, self.net2, self.cfg.w0
        x = torch.sin(w0 * (net1[0](coords) + net2[0](latents)))
        for i in range(cfg.num_hidden_blocks):
            x0 = x
            for j in range(cfg.num_hidden_layers_rez):
                ij = 1 + i * cfg.num_hidden_layers_rez + j
                x = torch.sin(w0 * (net1[ij](x) + net2[ij](latents)))
            x = 0.5 * x0 + 0.5 * x
        return net1[-1](x)


# ---------------------------------------------------------------------------
# SIRENAutodecoder_tw_film (trainable w0)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SirenFilmConfig:
    in_coord_features: int
    in_latent_features: int
    out_features: int
    num_hidden_layers: int
    hidden_features: int
    w0: float = DEFAULT_W0


class SirenTwFilm(nn.Module):
    """The FiLM SIREN with ``w0`` a parameter of shape ``(1,)``, initialised
    to ``cfg.w0`` (the layers' init reads that value too)."""

    def __init__(self, cfg: SirenFilmConfig):
        super().__init__()
        self.cfg = cfg
        self.net1, self.net2 = film_layers(cfg.in_coord_features, cfg.in_latent_features,
                                           cfg.out_features, cfg.num_hidden_layers + 1,
                                           cfg.hidden_features)
        self.w0 = nn.Parameter(torch.empty(1))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        film_init_(self.net1, self.net2, self.cfg.w0, generator)
        self.w0.fill_(self.cfg.w0)

    def forward(self, coords, latents):
        return film_forward(self.net1, self.net2, coords, latents, self.w0)


# ---------------------------------------------------------------------------
# MFN FiLM decoders (FNAutodecoder_film / GNAutodecoder_film)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MFNFilmConfig:
    in_coord_features: int
    in_latent_features: int
    out_features: int
    num_hidden_layers: int
    hidden_features: int
    input_scale: float = 256.0
    weight_scale: float = 1.0
    alpha: float = 6.0
    beta: float = 1.0
    filter_type: str = "fourier"


def _apply_filter(filt: FilterLayer, cfg: MFNFilmConfig, x):
    lin = filt(x)
    if cfg.filter_type == "gabor":
        d = ((x ** 2).sum(-1)[..., None] + (filt.mu ** 2).sum(0)[None, :]
             - 2 * (x @ filt.mu))
        return torch.sin(lin) * torch.exp(-0.5 * d * filt.gamma[None, :])
    return torch.sin(lin)


class MFNFilm(nn.Module):
    """``x = filter_0(c) * net2_0(z)``; ``x = filter_i(c) * (net1_{i-1}(x) +
    net2_i(z))``; the head ``net1[-1]`` (reference ``nf_networks.py:557-573``)."""

    def __init__(self, cfg: MFNFilmConfig):
        super().__init__()
        self.cfg = cfg
        n, h = cfg.num_hidden_layers, cfg.hidden_features
        self.net1 = _linears([h] * (n + 1) + [cfg.out_features])
        self.net2 = nn.ModuleList(nn.Linear(cfg.in_latent_features, h, bias=False)
                                  for _ in range(n + 1))
        self.filters = nn.ModuleList(FilterLayer(cfg.in_coord_features, h,
                                                 cfg.filter_type == "gabor")
                                     for _ in range(n + 1))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """``init_mfn_film``: net1 ``±sqrt(weight_scale / h)`` with biases
        ``±1/sqrt(h)``, net2 ``±sqrt(weight_scale / latent)``; each filter
        torch's Linear default ``±1/sqrt(in)`` times ``input_scale /
        sqrt(n + 1)`` (times ``sqrt(gamma)`` for Gabor), its bias on
        ``[-pi, pi)``, Gabor ``gamma`` Gamma(``alpha / (n + 1)``) / ``beta``
        and ``mu`` on ``[-1, 1)`` (``components.py:389-456``)."""
        cfg = self.cfg
        bound1 = math.sqrt(cfg.weight_scale / cfg.hidden_features)
        for lin in self.net1:
            uniform_(lin.weight, bound1, generator)
            uniform_(lin.bias, 1.0 / math.sqrt(cfg.hidden_features), generator)
        for lin in self.net2:
            uniform_(lin.weight, math.sqrt(cfg.weight_scale / cfg.in_latent_features),
                     generator)
        scale_per = cfg.input_scale / math.sqrt(cfg.num_hidden_layers + 1)
        for filt in self.filters:
            uniform_(filt.weight, 1.0 / math.sqrt(cfg.in_coord_features), generator)
            filt.weight.mul_(scale_per)
            uniform_(filt.bias, math.pi, generator)
            if cfg.filter_type == "gabor":
                gamma_(filt.gamma, cfg.alpha / (cfg.num_hidden_layers + 1), generator)
                filt.gamma.div_(cfg.beta)
                uniform_(filt.mu, 1.0, generator)
                filt.weight.mul_(torch.sqrt(filt.gamma)[:, None])

    def forward(self, coords, latents):
        cfg, net1, net2, filters = self.cfg, self.net1, self.net2, self.filters
        x = _apply_filter(filters[0], cfg, coords) * net2[0](latents)
        for i in range(1, len(filters)):
            x = _apply_filter(filters[i], cfg, coords) * (net1[i - 1](x) + net2[i](latents))
        return net1[-1](x)


# ---------------------------------------------------------------------------
# SIRENAutodecoder_fp (hypernetwork full projection)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SirenFPConfig:
    hyper_latent_features: int
    nf_in_features: int
    out_features: int
    nf_num_hidden_layers: int
    nf_hidden_features: int
    omega_0_e: float = DEFAULT_W0
    omega_0: float = DEFAULT_W0

    @property
    def num_nf_params(self) -> int:
        c, h, o, n = (self.nf_in_features, self.nf_hidden_features,
                      self.out_features, self.nf_num_hidden_layers)
        return (c + 1) * h + n * (h + 1) * h + (h + 1) * o


@torch.no_grad()
def _fp_head_init_(lin: nn.Linear, cfg: SirenFPConfig, generator) -> None:
    """The hypernetwork head (``nf_networks.py:712-733``): weights uniform
    ``±sqrt(6/latent) * 1e-2``; per-slot bias bounds that emulate the SIREN
    init of the generated parameters."""
    c, h, o, n = (cfg.nf_in_features, cfg.nf_hidden_features,
                  cfg.out_features, cfg.nf_num_hidden_layers)
    uniform_(lin.weight, math.sqrt(6.0 / cfg.hyper_latent_features) * 1e-2, generator)
    bounds = np.ones(cfg.num_nf_params, np.float32)
    n_first = c * h
    n_w = n_first + n * h * h + h * o
    bounds[:n_first] = 1.0 / c
    bounds[n_first:n_w] = math.sqrt(6.0 / h) / cfg.omega_0_e
    bounds[n_w:] = 1.0 / h
    r = torch.rand(lin.bias.shape, generator=generator)
    bounds = torch.from_numpy(bounds).to(r.device)
    lin.bias.copy_(r * 2 * bounds - bounds)


def _fp_decode(p: torch.Tensor, coords, cfg: SirenFPConfig) -> torch.Tensor:
    """Evaluate the SIREN whose parameters are the vector ``p`` ``(..., 1,
    n_params)``: every weight, then every bias, in layer order."""
    c, h, o, n = (cfg.nf_in_features, cfg.nf_hidden_features,
                  cfg.out_features, cfg.nf_num_hidden_layers)
    lead = p.shape[:-2]
    sizes = [c * h] + [h * h] * n + [h * o] + [h] * (n + 1) + [o]
    parts = list(torch.split(p, sizes, dim=-1))
    ws = [w.reshape(*lead, a, b) for w, (a, b) in
          zip(parts[:n + 2], [(c, h)] + [(h, h)] * n + [(h, o)])]
    bs = parts[n + 2:]
    x = coords
    for w, b in zip(ws[:-1], bs[:-1]):
        x = torch.sin(cfg.omega_0 * (torch.einsum("...mi,...ij->...mj", x, w) + b))
    return torch.einsum("...mi,...ij->...mj", x, ws[-1]) + bs[-1]


class SirenFP(nn.Module):
    """Latents -> the whole SIREN parameter vector (``hyper_last``) ->
    evaluate (``nf_networks.py:688-765``); ``latents`` ``(..., 1, L)``."""

    def __init__(self, cfg: SirenFPConfig):
        super().__init__()
        self.cfg = cfg
        self.hyper_last = nn.Linear(cfg.hyper_latent_features, cfg.num_nf_params)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        _fp_head_init_(self.hyper_last, self.cfg, generator)

    def forward(self, coords, latents):
        return _fp_decode(self.hyper_last(latents), coords, self.cfg)


# ---------------------------------------------------------------------------
# SIRENAutodecoder_mdf_film
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SirenMDFConfig:
    in_coord_features: int
    in_latent_features: int
    out_features: int
    num_hidden_layers: int
    hidden_features: int
    w0: float = DEFAULT_W0


class SirenMDF(nn.Module):
    """``x = sin(w0 * (nf_i(x) + x Wmod_i(z)^T + bmod_i(z)))``: ``hw_net[i]``
    generates layer ``i``'s ``(h, in)`` weight from the latent, applied
    TRANSPOSED as the reference's ``'thwji'`` einsum does
    (``cnf_zoo.py:370-389``)."""

    def __init__(self, cfg: SirenMDFConfig):
        super().__init__()
        self.cfg = cfg
        n_mod, h, lat = cfg.num_hidden_layers + 1, cfg.hidden_features, cfg.in_latent_features
        in_fs = [cfg.in_coord_features] + [h] * (n_mod - 1)
        self.nf_net = _linears(in_fs + [h, cfg.out_features])
        self.hw_net = nn.ModuleList(nn.Linear(lat, i * h, bias=False) for i in in_fs)
        self.hb_net = nn.ModuleList(nn.Linear(lat, h, bias=False) for _ in in_fs)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """``init_siren_mdf_film``: ``nf_net`` the SIREN init; the weight and
        bias generators uniform ``±sqrt(6/latent) * 1e-2``
        (``initialization.py:77-84``)."""
        for i, lin in enumerate(self.nf_net):
            siren_init_(lin, generator, self.cfg.w0, first_layer=(i == 0))
        bound = math.sqrt(6.0 / self.cfg.in_latent_features) * 1e-2
        for lin in (*self.hw_net, *self.hb_net):
            uniform_(lin.weight, bound, generator)

    def forward(self, coords, latents):
        h = self.cfg.hidden_features
        x = coords
        for lin, hw, hb in zip(self.nf_net[:-1], self.hw_net, self.hb_net):
            wmod = hw(latents)
            wmod = wmod.reshape(*wmod.shape[:-1], h, lin.in_features)
            x = (lin(x) + torch.einsum("...mi,...ji->...mj", x, wmod[..., 0, :, :])
                 + hb(latents))
            x = torch.sin(self.cfg.w0 * x)
        return self.nf_net[-1](x)


class SirenMDFExtraIn(SirenMDF):
    """``SIRENAutodecoder_mdf_film_extra_in``: coords is ``(spatial,
    extra)``; ``in_coord_features`` counts the extra channel."""

    def forward(self, coords, latents):
        return super().forward(_extra_in(coords), latents)


# ---------------------------------------------------------------------------
# Autoencoder variants (a sine MLP encoder over priors)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SirenAEFilmConfig:
    hyper_in_features: int
    hyper_latent_features: int
    hyper_num_hidden_layers: int
    hyper_hidden_features: int
    nf_in_features: int
    out_features: int
    nf_num_hidden_layers: int
    nf_hidden_features: int
    omega_0_e: float = DEFAULT_W0
    omega_0: float = DEFAULT_W0

    @property
    def fp(self) -> SirenFPConfig:
        return SirenFPConfig(self.hyper_latent_features, self.nf_in_features,
                             self.out_features, self.nf_num_hidden_layers,
                             self.nf_hidden_features, self.omega_0_e, self.omega_0)


def _hyper_net(cfg: SirenAEFilmConfig) -> nn.ModuleList:
    return _linears([cfg.hyper_in_features]
                    + [cfg.hyper_hidden_features] * (cfg.hyper_num_hidden_layers + 1)
                    + [cfg.hyper_latent_features])


def _hyper_init_(net: nn.ModuleList, cfg: SirenAEFilmConfig, generator) -> None:
    for i, lin in enumerate(net):
        siren_init_(lin, generator, cfg.omega_0_e, first_layer=(i == 0))


def _encode(net: nn.ModuleList, cfg: SirenAEFilmConfig, priors):
    p = priors
    for lin in net[:-1]:
        p = torch.sin(cfg.omega_0_e * lin(p))
    return net[-1](p)


class SirenAEFilm(nn.Module):
    """Encoder MLP (sine) -> latents -> FiLM decode; returns ``(out,
    latents)`` (``nf_networks.py:193-215``).  ``nf_net`` / ``proj_net`` are
    the FiLM decoder's ``net1`` / ``net2``."""

    def __init__(self, cfg: SirenAEFilmConfig):
        super().__init__()
        self.cfg = cfg
        self.hyper_net = _hyper_net(cfg)
        self.nf_net, self.proj_net = film_layers(
            cfg.nf_in_features, cfg.hyper_latent_features, cfg.out_features,
            cfg.nf_num_hidden_layers + 1, cfg.nf_hidden_features)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        _hyper_init_(self.hyper_net, self.cfg, generator)
        film_init_(self.nf_net, self.proj_net, self.cfg.omega_0, generator)

    def forward(self, coords, priors):
        latents = _encode(self.hyper_net, self.cfg, priors)
        return film_forward(self.nf_net, self.proj_net, coords, latents,
                            self.cfg.omega_0), latents


class SirenAEFilmExtraIn(SirenAEFilm):
    def forward(self, coords, priors):
        return super().forward(_extra_in(coords), priors)


class SirenAEFP(nn.Module):
    """Encoder -> latent -> full parameter projection -> SIREN evaluate;
    returns ``(out, latent, params_vec)`` (``nf_networks.py:57-110``)."""

    def __init__(self, cfg: SirenAEFilmConfig):
        super().__init__()
        self.cfg = cfg
        self.hyper_net = _hyper_net(cfg)
        self.hyper_last = nn.Linear(cfg.hyper_latent_features, cfg.fp.num_nf_params)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        _hyper_init_(self.hyper_net, self.cfg, generator)
        _fp_head_init_(self.hyper_last, self.cfg.fp, generator)

    def forward(self, coords, priors):
        latent = _encode(self.hyper_net, self.cfg, priors)
        params_vec = self.hyper_last(latent)
        return _fp_decode(params_vec, coords, self.cfg.fp), latent, params_vec


# ---------------------------------------------------------------------------
# registry wiring (the JAX factories' signatures, cnf_zoo.py:482-606)
# ---------------------------------------------------------------------------

def _reg(name):
    def deco(factory):
        factory.__name__ = name
        NF_REGISTRY[name] = factory
        return factory
    return deco


@_reg("SIRENAutodecoder_film_single")
def _film_single(in_coord_features, out_features, num_hidden_layers,
                 hidden_features, w0: float = DEFAULT_W0, **_):
    return SirenSingle(SirenSingleConfig(in_coord_features, out_features,
                                         num_hidden_layers, hidden_features, w0))


@_reg("SIREN_rez_Autodecoder_film")
def _rez_film(in_coord_features, in_latent_features, out_features,
              num_hidden_blocks=None, hidden_features=None,
              num_hidden_layers_rez: int = 2, num_hidden_layers=None,
              w0: float = DEFAULT_W0, **_):
    blocks = num_hidden_blocks if num_hidden_blocks is not None else num_hidden_layers
    return SirenRez(SirenRezConfig(in_coord_features, in_latent_features, out_features,
                                   blocks, hidden_features, num_hidden_layers_rez, w0))


@_reg("SIRENAutodecoder_tw_film")
def _tw_film(in_coord_features, in_latent_features, out_features,
             num_hidden_layers, hidden_features, w0_init: float = DEFAULT_W0, **_):
    return SirenTwFilm(SirenFilmConfig(in_coord_features, in_latent_features, out_features,
                                       num_hidden_layers, hidden_features, w0_init))


@_reg("FNAutodecoder_film")
def _fn_film(in_coord_features, in_latent_features, out_features,
             num_hidden_layers, hidden_features, input_scale: float = 256.0,
             weight_scale: float = 1.0, **_):
    return MFNFilm(MFNFilmConfig(in_coord_features, in_latent_features, out_features,
                                 num_hidden_layers, hidden_features, input_scale,
                                 weight_scale, filter_type="fourier"))


@_reg("GNAutodecoder_film")
def _gn_film(in_coord_features, in_latent_features, out_features,
             num_hidden_layers, hidden_features, input_scale: float = 256.0,
             weight_scale: float = 1.0, alpha: float = 6.0, beta: float = 1.0, **_):
    return MFNFilm(MFNFilmConfig(in_coord_features, in_latent_features, out_features,
                                 num_hidden_layers, hidden_features, input_scale,
                                 weight_scale, alpha, beta, filter_type="gabor"))


@_reg("SIRENAutodecoder_fp")
def _fp(hyper_latent_features=None, nf_in_features=None, out_features=None,
        nf_num_hidden_layers=None, nf_hidden_features=None,
        in_coord_features=None, in_latent_features=None,
        num_hidden_layers=None, hidden_features=None,
        omega_0_e: float = DEFAULT_W0, omega_0: float = DEFAULT_W0, **_):
    return SirenFP(SirenFPConfig(
        hyper_latent_features or in_latent_features,
        nf_in_features or in_coord_features,
        out_features,
        nf_num_hidden_layers if nf_num_hidden_layers is not None else num_hidden_layers,
        nf_hidden_features or hidden_features,
        omega_0_e, omega_0))


@_reg("SIRENAutodecoder_mdf_film")
def _mdf_film(in_coord_features, in_latent_features, out_features,
              num_hidden_layers, hidden_features, w0: float = DEFAULT_W0, **_):
    return SirenMDF(SirenMDFConfig(in_coord_features, in_latent_features, out_features,
                                   num_hidden_layers, hidden_features, w0))


@_reg("SIRENAutodecoder_mdf_film_extra_in")
def _mdf_film_extra(in_coord_features, in_latent_features, out_features,
                    num_hidden_layers, hidden_features, w0: float = DEFAULT_W0, **_):
    return SirenMDFExtraIn(SirenMDFConfig(in_coord_features, in_latent_features,
                                          out_features, num_hidden_layers,
                                          hidden_features, w0))


def _ae_config(hyper_in_features, hyper_latent_features, hyper_num_hidden_layers,
               hyper_hidden_features, nf_in_features, out_features,
               nf_num_hidden_layers, nf_hidden_features,
               omega_0_e: float = DEFAULT_W0, omega_0: float = DEFAULT_W0, **_):
    return SirenAEFilmConfig(hyper_in_features, hyper_latent_features,
                             hyper_num_hidden_layers, hyper_hidden_features,
                             nf_in_features, out_features, nf_num_hidden_layers,
                             nf_hidden_features, omega_0_e, omega_0)


@_reg("SIRENAutoencoder_film")
def _ae_film(**kw):
    return SirenAEFilm(_ae_config(**kw))


@_reg("SIRENAutoencoder_film_extra_in")
def _ae_film_extra(**kw):
    return SirenAEFilmExtraIn(_ae_config(**kw))


@_reg("SIRENAutoencoder_fp")
def _ae_fp(**kw):
    return SirenAEFP(_ae_config(**kw))
