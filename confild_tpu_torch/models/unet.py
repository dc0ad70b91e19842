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

An attention block takes the dense path or the flash-attention kernels
(``confild_tpu_torch/ops/flash_attention.py``), as the JAX package routes it:
``use_flash_attention`` true sends every block through the kernels; left
unset (auto), only blocks of at least ``FLASH_MIN_TOKENS`` tokens take them.
With a ``seq_mesh`` of more than one rank, a block of at least
``ring_min_tokens`` tokens (divisible by the ring) takes ring attention
(``confild_tpu_torch/ops/ring_attention.py``) before either, as
``confild_tpu/models/unet.py:366-377`` routes it.

As in the JAX package (``confild_tpu/models/unet.py:142-153, 508-577``):

* a bf16 torso (``use_bf16`` / ``use_fp16``): activations are cast to
  bfloat16 after the input, every convolution casts its float32 weights at
  use, the timestep embedding runs in float32 and is cast afterwards,
  GroupNorm keeps float32 statistics, the dense attention's logits and
  softmax stay float32; the tail (final norm, SiLU, convolution) runs in
  the torso dtype unless ``use_f32_tail``, and the output returns to the
  input's dtype.  :meth:`UNetModel.cast_torso_params` pre-casts the torso's
  convolutions for sampling;
* block rematerialization (``use_checkpoint``): each input block, the
  middle block and each output block run under ``torch.utils.checkpoint``
  (non-reentrant, RNG state preserved), with the ``remat_policy`` of
  :data:`REMAT_POLICIES`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from confild_tpu_torch.models import nn as tnn
from confild_tpu_torch.ops.flash_attention import flash_attention
from confild_tpu_torch.ops.ring_attention import ring_attention

# token count at which the JAX package's U-Net uses flash attention in auto
# mode (confild_tpu/models/unet.py:185); kept for routing parity, the H100
# crossover is in PERF.md
FLASH_MIN_TOKENS = 16384
# token count at which a U-Net with a seq_mesh takes ring attention
# (confild_tpu/models/unet.py:346)
RING_MIN_TOKENS = 8192

_aten = torch.ops.aten
_MATMULS = frozenset({_aten.convolution.default, _aten.mm.default, _aten.bmm.default,
                      _aten.addmm.default})
# the remat policies of confild_tpu/models/unet.py:94-120, as the ops whose
# outputs a checkpointed block saves (None: none, the whole block is
# recomputed).  "matmuls" saves the convolutions' and matrix products'
# outputs; "matmuls+stats" also GroupNorm's statistics, JAX's tagged
# ``gn_stats``: the float32 torso's ``native_group_norm`` (its mean and rstd,
# with the normalized output that the op returns beside them) and the bf16
# torso's ``var_mean`` (models/nn.py::_GroupNormLowp)
REMAT_POLICIES = {"full": None, "matmuls": _MATMULS,
                  "matmuls+stats": _MATMULS | {_aten.native_group_norm.default,
                                               _aten.var_mean.correction}}


def _save_ops(ops, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE


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
    use_flash: bool = False


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
    num_classes: int | None = None     # class-conditional: a label embedding
    num_heads: int = 1
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_new_attention_order: bool = False
    use_flash_attention: bool = False  # the flash kernels (O(N) memory)
    flash_auto: bool = False           # gate flash per block by token count
    torso_dtype: torch.dtype = torch.float32   # torch.bfloat16 for a bf16 torso
    tail_dtype: torch.dtype | None = None      # final norm + conv; None: the torso's
    use_checkpoint: bool = False       # rematerialize each top-level block
    remat_policy: str = "full"         # a key of REMAT_POLICIES

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

    def flash_at(ds: int) -> bool:
        """Auto mode gates flash per block (``confild_tpu/models/unet.py:
        192-201``)."""
        if not cfg.use_flash_attention:
            return False
        return not cfg.flash_auto or _tokens(cfg.image_size, cfg.dims, ds) >= FLASH_MIN_TOKENS

    def attn(ch: int, upsample: bool = False) -> AttnSpec:
        # ``ds`` is read at the call: the current level's downsample factor
        return AttnSpec(ch, cfg.heads_for(ch, upsample), cfg.use_new_attention_order,
                        flash_at(ds))
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
                layers.append(attn(ch))
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
        attn(ch),
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
                layers.append(attn(ch, upsample=True))
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
    """Self-attention over the flattened spatial positions: ring attention
    over ``seq_mesh`` (set by :class:`UNetModel`) from ``ring_min_tokens``
    tokens, else dense, or the flash kernels when ``spec.use_flash``
    (``confild_tpu/models/unet.py:366-384``)."""

    seq_mesh = None
    ring_min_tokens = RING_MIN_TOKENS

    def __init__(self, spec: AttnSpec):
        super().__init__()
        self.spec = spec
        self.norm = tnn.GroupNorm32(spec.ch)
        self.qkv = tnn.conv_nd(1, spec.ch, 3 * spec.ch, 1)
        self.proj_out = tnn.conv_nd(1, spec.ch, spec.ch, 1)

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
        n_ring = self.seq_mesh.size if self.seq_mesh is not None else 0
        if n_ring > 1 and n >= self.ring_min_tokens and n % n_ring == 0:
            # sequence parallel, in float32 as the JAX package's ring
            out = ring_attention(*(t.transpose(1, 2).float() for t in (q, k, v)),
                                 self.seq_mesh)
            out = out.to(x.dtype).transpose(1, 2).reshape(b, c, n)
        elif self.spec.use_flash:
            # (B*heads, N, d) in the same head order for both layouts
            out = flash_attention(*(t.transpose(1, 2) for t in (q, k, v)))
            out = out.transpose(1, 2).reshape(b, c, n)
        else:
            # float32 logits and softmax (float64 in a float64 run), the
            # weights in the activation dtype; q and k are scaled in float32,
            # as JAX's product with a NumPy scalar promotes them
            scale = 1.0 / np.sqrt(np.sqrt(d))
            up = torch.promote_types(q.dtype, torch.float32)
            logits = torch.einsum("bct,bcs->bts", q.to(up) * scale, k.to(up) * scale)
            weights = torch.softmax(logits, dim=-1).type(x.dtype)
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


@torch.no_grad()
def reset_unet_parameters(model: nn.Module, zeroed: Sequence[nn.Module],
                          generator: torch.Generator | None = None):
    """torch's default ``±1/sqrt(fan_in)`` uniform for every convolution and
    linear layer of ``model`` from ``generator``, unit GroupNorms, standard
    normal embeddings; each ResBlock's output convolution, each attention
    projection and the layers in ``zeroed`` zeroed."""
    zeroed = {id(m) for m in zeroed}
    for m in model.modules():
        if isinstance(m, ResBlock):
            zeroed.add(id(m.out_layers[3]))
        elif isinstance(m, AttentionBlock):
            zeroed.add(id(m.proj_out))
    for m in model.modules():
        if isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            if id(m) in zeroed:
                m.weight.zero_()
                m.bias.zero_()
                continue
            bound = 1.0 / np.sqrt(m.weight[0].numel())
            for t in (m.weight, m.bias):
                t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)
    return model


class UNetModel(nn.Module):
    """``model(x, timesteps, y=None)`` with ``x`` ``(B, C, *spatial)`` and,
    for a class-conditional model (``cfg.num_classes``), int labels ``y``
    ``(B,)`` whose embedding ``label_emb`` adds to the timestep embedding
    (``confild_tpu/models/unet.py:520-522``).  ``seq_mesh``:
    a :class:`~confild_tpu_torch.parallel.mesh.DataMesh` over which the
    attention blocks of at least ``ring_min_tokens`` tokens run ring
    attention; every rank of it runs the model on the same batch (the batch
    is not sharded over the same ranks)."""

    def __init__(self, cfg: UNetConfig, seq_mesh=None,
                 ring_min_tokens: int = RING_MIN_TOKENS):
        super().__init__()
        self.cfg = cfg
        self.plan = build_plan(cfg)
        mc, emb_ch = cfg.model_channels, cfg.emb_ch
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, emb_ch)
        self.input_blocks = nn.ModuleList(
            TimestepEmbedSequential(*map(_layer, block)) for block in self.plan.input_blocks)
        self.middle_block = TimestepEmbedSequential(*map(_layer, self.plan.middle_block))
        self.output_blocks = nn.ModuleList(
            TimestepEmbedSequential(*map(_layer, block)) for block in self.plan.output_blocks)
        self.out = nn.Sequential(
            tnn.GroupNorm32(self.plan.out_ch_final), nn.SiLU(),
            tnn.conv_nd(cfg.dims, self.plan.out_ch_final, cfg.out_channels, 3, padding=1))
        self.seq_mesh, self.ring_min_tokens = seq_mesh, ring_min_tokens
        for m in self.modules():
            if isinstance(m, AttentionBlock):
                m.seq_mesh, m.ring_min_tokens = seq_mesh, ring_min_tokens

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> "UNetModel":
        """The reference's initialisation from ``generator``: torch's default
        ``±1/sqrt(fan_in)`` uniform for every convolution and linear layer,
        unit GroupNorms, a standard normal label embedding, and the
        ``zero_module`` layers (each ResBlock's output convolution, each
        attention projection and the final convolution, reference
        ``unet.py:216-223,290,660``) zeroed, as the JAX ``init`` zeroes
        them."""
        return reset_unet_parameters(self, [self.out[2]], generator)

    def torso_layers(self):
        """The convolutions of the input, middle and output blocks: the
        layers of the JAX package's ``_TORSO_KERNEL_KEYS`` (``in_conv``,
        ``out_conv``, ``skip``, ``qkv``, ``proj``, ``conv``); not the
        timestep embedding, the ResBlocks' embedding projections, the
        GroupNorms or the tail."""
        for stack in (self.input_blocks, [self.middle_block], self.output_blocks):
            for block in stack:
                for m in block.modules():
                    if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
                        yield m

    @torch.no_grad()
    def cast_torso_params(self) -> "UNetModel":
        """Pre-cast the torso's convolutions to ``cfg.torso_dtype``, in place
        (``confild_tpu/models/unet.py:470-506``): the cast at use becomes a
        no-op, with bit-identical outputs.  For sampling only: training keeps
        float32 parameters."""
        if self.cfg.torso_dtype != torch.float32:
            for m in self.torso_layers():
                m.to(self.cfg.torso_dtype)
        return self

    def _block(self, block, h, emb):
        if not (self.cfg.use_checkpoint and torch.is_grad_enabled()):
            return block(h, emb)
        ops = REMAT_POLICIES[self.cfg.remat_policy]
        context = {} if ops is None else {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, functools.partial(_save_ops, ops))}
        return checkpoint(block, h, emb, use_reentrant=False, preserve_rng_state=True,
                          **context)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        emb = self.time_embed(tnn.timestep_embedding(timesteps, cfg.model_channels).to(
            self.time_embed[0].weight.dtype))
        if cfg.num_classes is not None:
            if y is None:
                raise ValueError("a class-conditional model needs labels y")
            emb = emb + self.label_emb(y.to(emb.device))
        hs = []
        h = x.to(cfg.torso_dtype)
        for block in self.input_blocks:
            h = self._block(block, h, emb)
            hs.append(h)
        h = self._block(self.middle_block, h, emb)
        for block in self.output_blocks:
            h = self._block(block, torch.cat([h, hs.pop()], dim=1), emb)
        h = h.to(cfg.tail_dtype or cfg.torso_dtype)
        return self.out[2](tnn.group_norm_silu(self.out[0], h)).to(x.dtype)


# ---------------------------------------------------------------------------
# factory mirroring the reference create_model (script_util.py:130-187)
# ---------------------------------------------------------------------------

_DEFAULT_CHANNEL_MULT = {
    512: (0.5, 1, 1, 2, 2, 4, 4),
    256: (1, 1, 2, 2, 4, 4),
    128: (1, 1, 2, 3, 4),
    64: (1, 2, 3, 4),
}


def _tokens(image_size: int, dims: int, ds: int) -> int:
    """Tokens of an attention block at downsample factor ``ds`` (the image
    depth times the plane for ``dims == 3``)."""
    n = image_size // ds
    return image_size * n * n if dims == 3 else n ** dims


def create_model(image_size: int, num_channels: int, num_res_blocks: int,
                 dims: int = 2, out_channels: int = 1,
                 channel_mult: str | Sequence[float] | None = None,
                 learn_sigma: bool = False, class_cond: bool = False,
                 num_classes: int = 1000, attention_resolutions: str = "16",
                 num_heads: int = 1, num_head_channels: int = -1,
                 num_heads_upsample: int = -1, use_scale_shift_norm: bool = False,
                 dropout: float = 0.0, resblock_updown: bool = False,
                 use_new_attention_order: bool = False,
                 use_flash_attention: bool | None = None,
                 use_checkpoint: bool = False, remat_policy: str = "full",
                 use_bf16: bool = False, use_fp16: bool = False,
                 use_f32_tail: bool = False, sequence_parallel_mesh=None) -> UNetModel:
    """The U-Net of a recipe (``confild_tpu/models/unet.py:595-674``);
    ``use_fp16`` means a bf16 torso, as in the JAX package; ``class_cond``
    gives it ``num_classes`` label embeddings; ``sequence_parallel_mesh`` is
    the model's ``seq_mesh``."""
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

    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; one of "
                         f"{sorted(REMAT_POLICIES)}")
    # auto (None): build_plan gates flash per block at FLASH_MIN_TOKENS; the
    # flag records whether any block crosses it (confild_tpu/models/unet.py:
    # 630-668)
    flash_auto = use_flash_attention is None
    if flash_auto:
        use_flash_attention = max(_tokens(image_size, dims, ds)
                                  for ds in attention_ds) >= FLASH_MIN_TOKENS

    cfg = UNetConfig(
        image_size=image_size, in_channels=out_channels, model_channels=num_channels,
        out_channels=out_channels if not learn_sigma else 2 * out_channels,
        num_res_blocks=num_res_blocks, attention_resolutions=attention_ds,
        dropout=dropout, channel_mult=channel_mult, dims=dims,
        num_classes=num_classes if class_cond else None, num_heads=num_heads,
        num_head_channels=num_head_channels, num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm, resblock_updown=resblock_updown,
        use_new_attention_order=use_new_attention_order,
        use_flash_attention=bool(use_flash_attention), flash_auto=flash_auto,
        torso_dtype=torch.bfloat16 if (use_bf16 or use_fp16) else torch.float32,
        tail_dtype=torch.float32 if use_f32_tail else None,
        use_checkpoint=use_checkpoint, remat_policy=remat_policy)
    return UNetModel(cfg, seq_mesh=sequence_parallel_mesh)
