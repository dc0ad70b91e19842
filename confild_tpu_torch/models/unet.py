"""ADM diffusion U-Net (reference
``UnconditionalDiffusionTraining_and_Generation/src/unet.py``),
channels-first, with the reference state-dict keys
(``confild_tpu/io/torch_export.py:66-130``).

* ``ResBlock`` with optional scale-shift GroupNorm FiLM and up/down variants
  (reference ``unet.py:143-256``);
* ``AttentionBlock`` with the legacy (per head ``[q, k, v]`` interleaved) or
  new (``[q, k, v]`` over all heads) qkv layout, the two-sided
  ``1/sqrt(sqrt(d))`` scaling and a float32 softmax (``unet.py:259-393``);
* input / middle / output stacks with skip concatenation and nearest-up /
  strided-conv (or avg-pool) down sampling (``unet.py:396-663``).

Only the dense attention path is ported.  The JAX package switches a block
to its Pallas flash-attention kernel at ``FLASH_MIN_TOKENS`` tokens; that
kernel is a later slice of the port, so such a configuration raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from confild_tpu_torch.models import nn as tnn

# token count at which the JAX package's U-Net uses flash attention
# (confild_tpu/models/unet.py:185)
FLASH_MIN_TOKENS = 16384


# ---------------------------------------------------------------------------
# layer specs (static plan nodes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvSpec:
    dims: int
    in_ch: int
    out_ch: int


@dataclasses.dataclass(frozen=True)
class ResSpec:
    dims: int
    in_ch: int
    out_ch: int
    emb_ch: int
    use_scale_shift_norm: bool = False
    up: bool = False
    down: bool = False
    dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    ch: int
    num_heads: int
    new_order: bool = False


@dataclasses.dataclass(frozen=True)
class UpSpec:
    dims: int
    in_ch: int
    out_ch: int
    use_conv: bool = True


@dataclasses.dataclass(frozen=True)
class DownSpec:
    dims: int
    in_ch: int
    out_ch: int
    use_conv: bool = True


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int
    in_channels: int
    model_channels: int
    out_channels: int
    num_res_blocks: int
    attention_resolutions: tuple[int, ...]  # downsample factors (ds)
    dropout: float = 0.0
    channel_mult: tuple[float, ...] = (1, 2, 4, 8)
    conv_resample: bool = True
    dims: int = 2
    num_heads: int = 1
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_new_attention_order: bool = False

    @property
    def emb_ch(self) -> int:
        return self.model_channels * 4

    def heads_for(self, ch: int, upsample: bool = False) -> int:
        if self.num_head_channels != -1:
            if ch % self.num_head_channels:
                raise ValueError(f"{ch} channels do not split into heads of "
                                 f"{self.num_head_channels}")
            return ch // self.num_head_channels
        if upsample and self.num_heads_upsample != -1:
            return self.num_heads_upsample
        return self.num_heads


@dataclasses.dataclass(frozen=True)
class UNetPlan:
    input_blocks: tuple[tuple[Any, ...], ...]
    middle_block: tuple[Any, ...]
    output_blocks: tuple[tuple[Any, ...], ...]
    out_ch_final: int


def build_plan(cfg: UNetConfig) -> UNetPlan:
    """Mirror of the reference block construction (``unet.py:478-615``)."""
    mc, emb_ch = cfg.model_channels, cfg.emb_ch
    ch = input_ch = int(cfg.channel_mult[0] * mc)
    input_blocks: list[tuple[Any, ...]] = [(ConvSpec(cfg.dims, cfg.in_channels, ch),)]
    input_block_chans = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers: list[Any] = [ResSpec(cfg.dims, ch, int(mult * mc), emb_ch,
                                         cfg.use_scale_shift_norm, dropout=cfg.dropout)]
            ch = int(mult * mc)
            if ds in cfg.attention_resolutions:
                layers.append(AttnSpec(ch, cfg.heads_for(ch), cfg.use_new_attention_order))
            input_blocks.append(tuple(layers))
            input_block_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                input_blocks.append((ResSpec(cfg.dims, ch, ch, emb_ch, cfg.use_scale_shift_norm,
                                             down=True, dropout=cfg.dropout),))
            else:
                input_blocks.append((DownSpec(cfg.dims, ch, ch, cfg.conv_resample),))
            input_block_chans.append(ch)
            ds *= 2

    middle_block = (
        ResSpec(cfg.dims, ch, ch, emb_ch, cfg.use_scale_shift_norm, dropout=cfg.dropout),
        AttnSpec(ch, cfg.heads_for(ch), cfg.use_new_attention_order),
        ResSpec(cfg.dims, ch, ch, emb_ch, cfg.use_scale_shift_norm, dropout=cfg.dropout),
    )

    output_blocks: list[tuple[Any, ...]] = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_block_chans.pop()
            layers = [ResSpec(cfg.dims, ch + ich, int(mc * mult), emb_ch,
                              cfg.use_scale_shift_norm, dropout=cfg.dropout)]
            ch = int(mc * mult)
            if ds in cfg.attention_resolutions:
                layers.append(AttnSpec(ch, cfg.heads_for(ch, upsample=True),
                                       cfg.use_new_attention_order))
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    layers.append(ResSpec(cfg.dims, ch, ch, emb_ch, cfg.use_scale_shift_norm,
                                          up=True, dropout=cfg.dropout))
                else:
                    layers.append(UpSpec(cfg.dims, ch, ch, cfg.conv_resample))
                ds //= 2
            output_blocks.append(tuple(layers))

    return UNetPlan(tuple(input_blocks), middle_block, tuple(output_blocks),
                    out_ch_final=input_ch)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _resample(x: torch.Tensor, dims: int, up: bool) -> torch.Tensor:
    if up:
        return tnn.nearest_upsample(x, dims)
    return tnn.avg_pool(x, (1, 2, 2) if dims == 3 else (2,) * dims)


class ResBlock(nn.Module):
    def __init__(self, spec: ResSpec):
        super().__init__()
        self.spec = spec
        d, cin, cout = spec.dims, spec.in_ch, spec.out_ch
        self.in_layers = nn.Sequential(tnn.GroupNorm32(cin), nn.SiLU(),
                                       tnn.conv_nd(d, cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(spec.emb_ch, 2 * cout if spec.use_scale_shift_norm else cout))
        self.out_layers = nn.Sequential(tnn.GroupNorm32(cout), nn.SiLU(),
                                        nn.Dropout(spec.dropout),
                                        tnn.conv_nd(d, cout, cout, 3, padding=1))
        self.skip_connection = (nn.Identity() if cout == cin
                                else tnn.conv_nd(d, cin, cout, 1))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        h = tnn.group_norm_silu(self.in_layers[0], x)
        if spec.up or spec.down:
            h = _resample(h, spec.dims, spec.up)
            x = _resample(x, spec.dims, spec.up)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers(emb).type(h.dtype)
        emb_out = emb_out.reshape(*emb_out.shape, *(1,) * (h.ndim - 2))
        if spec.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = tnn.group_norm_silu(self.out_layers[0], h, scale, shift)
        else:
            h = tnn.group_norm_silu(self.out_layers[0], h + emb_out)
        h = self.out_layers[3](self.out_layers[2](h))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Dense self-attention over the flattened spatial positions."""

    def __init__(self, spec: AttnSpec):
        super().__init__()
        self.spec = spec
        self.norm = tnn.GroupNorm32(spec.ch)
        self.qkv = nn.Conv1d(spec.ch, 3 * spec.ch, 1)
        self.proj_out = nn.Conv1d(spec.ch, spec.ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, *spatial = x.shape
        h = x.reshape(b, c, -1)
        n = h.shape[-1]
        qkv = self.qkv(self.norm(h))                   # (B, 3C, N)
        heads = self.spec.num_heads
        d = c // heads
        if self.spec.new_order:
            q, k, v = (t.reshape(b * heads, d, n) for t in qkv.chunk(3, dim=1))
        else:
            q, k, v = qkv.reshape(b * heads, 3 * d, n).split(d, dim=1)
        scale = 1.0 / np.sqrt(np.sqrt(d))
        logits = torch.einsum("bct,bcs->bts", q * scale, k * scale)
        weights = torch.softmax(logits.float(), dim=-1).type(x.dtype)
        out = torch.einsum("bts,bcs->bct", weights, v).reshape(b, c, n)
        return (h + self.proj_out(out)).reshape(b, c, *spatial)


class Upsample(nn.Module):
    def __init__(self, spec: UpSpec):
        super().__init__()
        self.dims = spec.dims
        if spec.use_conv:
            self.conv = tnn.conv_nd(spec.dims, spec.in_ch, spec.out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = tnn.nearest_upsample(x, self.dims)
        return self.conv(x) if hasattr(self, "conv") else x


class Downsample(nn.Module):
    def __init__(self, spec: DownSpec):
        super().__init__()
        self.dims = spec.dims
        if spec.use_conv:
            stride = (1, 2, 2) if spec.dims == 3 else 2
            self.op = tnn.conv_nd(spec.dims, spec.in_ch, spec.out_ch, 3,
                                  stride=stride, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "op"):
            return self.op(x)
        return _resample(x, self.dims, up=False)


def _layer(spec) -> nn.Module:
    if isinstance(spec, ConvSpec):
        return tnn.conv_nd(spec.dims, spec.in_ch, spec.out_ch, 3, padding=1)
    return {ResSpec: ResBlock, AttnSpec: AttentionBlock, UpSpec: Upsample,
            DownSpec: Downsample}[type(spec)](spec)


class TimestepEmbedSequential(nn.Sequential):
    """Passes the timestep embedding to the ResBlocks among its layers."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class UNetModel(nn.Module):
    """``model(x, timesteps)`` with ``x`` ``(B, C, *spatial)``."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.plan = build_plan(cfg)
        mc, emb_ch = cfg.model_channels, cfg.emb_ch
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        self.input_blocks = nn.ModuleList(
            TimestepEmbedSequential(*map(_layer, block)) for block in self.plan.input_blocks)
        self.middle_block = TimestepEmbedSequential(*map(_layer, self.plan.middle_block))
        self.output_blocks = nn.ModuleList(
            TimestepEmbedSequential(*map(_layer, block)) for block in self.plan.output_blocks)
        self.out = nn.Sequential(
            tnn.GroupNorm32(self.plan.out_ch_final), nn.SiLU(),
            tnn.conv_nd(cfg.dims, self.plan.out_ch_final, cfg.out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        emb = self.time_embed(tnn.timestep_embedding(timesteps, self.cfg.model_channels))
        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        return self.out[2](tnn.group_norm_silu(self.out[0], h))


# ---------------------------------------------------------------------------
# factory mirroring the reference create_model (script_util.py:130-187)
# ---------------------------------------------------------------------------

_DEFAULT_CHANNEL_MULT = {
    512: (0.5, 1, 1, 2, 2, 4, 4),
    256: (1, 1, 2, 2, 4, 4),
    128: (1, 1, 2, 3, 4),
    64: (1, 2, 3, 4),
}


def create_model(image_size: int, num_channels: int, num_res_blocks: int,
                 dims: int = 2, out_channels: int = 1,
                 channel_mult: str | Sequence[float] | None = None,
                 learn_sigma: bool = False, attention_resolutions: str = "16",
                 num_heads: int = 1, num_head_channels: int = -1,
                 num_heads_upsample: int = -1, use_scale_shift_norm: bool = False,
                 dropout: float = 0.0, resblock_updown: bool = False,
                 use_new_attention_order: bool = False,
                 use_flash_attention: bool | None = None) -> UNetModel:
    if channel_mult is None:
        if image_size not in _DEFAULT_CHANNEL_MULT:
            raise ValueError(f"unsupported image size: {image_size}")
        channel_mult = _DEFAULT_CHANNEL_MULT[image_size]
    elif isinstance(channel_mult, str):
        channel_mult = tuple(int(m) for m in channel_mult.split(","))
    else:
        channel_mult = tuple(channel_mult)

    attention_ds = tuple(image_size // int(res)
                         for res in str(attention_resolutions).split(","))

    def tokens(ds):
        n = image_size // ds
        return image_size * n * n if dims == 3 else n ** dims
    if use_flash_attention or (use_flash_attention is None and attention_ds
                               and max(map(tokens, attention_ds)) >= FLASH_MIN_TOKENS):
        raise NotImplementedError(
            "flash attention (the JAX package's ops/flash_attention.py kernels, "
            f"engaged at >= {FLASH_MIN_TOKENS} tokens) is not ported yet; see "
            "ROADMAP.md Queue 2")

    cfg = UNetConfig(
        image_size=image_size, in_channels=out_channels, model_channels=num_channels,
        out_channels=out_channels if not learn_sigma else 2 * out_channels,
        num_res_blocks=num_res_blocks, attention_resolutions=attention_ds,
        dropout=dropout, channel_mult=channel_mult, dims=dims, num_heads=num_heads,
        num_head_channels=num_head_channels, num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm, resblock_updown=resblock_updown,
        use_new_attention_order=use_new_attention_order)
    return UNetModel(cfg)
