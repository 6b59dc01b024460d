"""UNet2DConditionModel, port of tango_tpu/models/unet.py.

The public forward keeps the JAX layout: sample (B, T, F, C) in and out.
Inside, activations are NCHW, the layout of cuDNN's convolutions, and the
spatial transformer flattens (B, C, T, F) to (B, T*F, C) tokens in the same
order as the JAX (B, T, F, C) reshape. Submodules carry the JAX module names
(`down_blocks_0`, `resnets_1`, `to_qkv`, ...) so that a Flax parameter path
maps onto a state-dict key (utils/convert.py).

GroupNorm goes through ops.basic.group_norm (the GN kernels) and
self-attention through ops.attention.multi_head_attention (the attention
kernel at Sq >= 256); convs and projections are cuDNN/cuBLAS, as they were
XLA in JAX. Both kernel routes carry their own backward kernels.

A config with `quant_int8` builds the int8 modules of its `quant_scope`
(ops/quant.py: QLinear through the `w8a8_matmul` kernel, QConv2d) at the
JAX names, so a state dict converted from a `quantize_tree` output loads
with the strict key check; `quantize_unet_` turns a float UNet into the same.

`remat=True` recomputes each down, mid and up block in the backward pass
(`torch.utils.checkpoint`, as `nn.remat` in JAX) whenever gradients are
being recorded: the forward kernels of a block then run twice per training
step.

Mustango's music UNet is this UNet with `cfg.extra_cond_streams = 2`: every
cross-attention layer runs one Transformer2DModel per stream in sequence,
text (`attentions_{i}`), then beats (`attentions_{i}_extra1`), then chords
(`attentions_{i}_extra2`), each attending to its own context under its own
mask (tango_tpu/models/unet.py:272-295).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tango_tpu_torch.configs import UNetConfig
from tango_tpu_torch.models.layers import GroupNorm, nchw_to_nhwc, nhwc_to_nchw
from tango_tpu_torch.ops.attention import multi_head_attention
from tango_tpu_torch.ops.basic import geglu, silu
from tango_tpu_torch.ops.quant import quantize_unet_
from tango_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model, split_span


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True, downscale_freq_shift: float = 0.0,
                           max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, f32 (diffusers embeddings.py)."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """0/1 key mask (B, S) -> additive f32 bias (B, S): (1 - mask) * -10000."""
    return (1.0 - mask.float()) * -10000.0


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb):
        return self.linear_2(silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, groups: int, eps: float):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, groups, eps, act="silu")
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(out_ch, groups, eps, act="silu")
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))
        h = h + self.time_emb_proj(silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Projections + attention core. `fuse="qkv"` (self-attention) computes
    q, k, v with one matmul; `fuse="kv"` fuses k, v of the context.

    Under tensor parallelism (parallel.mesh.shard_params) a model rank keeps
    whole heads, spread as evenly as possible (5 over 2 ranks: 3 and 2; a
    rank may keep none): the fused weights keep their chunk layout on each
    rank, [q_local; k_local; v_local], and to_out_0 its rows' columns; its
    partial sums are all-reduced and its bias added once, after."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, context_dim: int,
                 upcast: bool, fuse: str):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.upcast, self.fuse = heads, upcast, fuse
        self.local_heads, self.tp_mesh = heads, None
        if fuse == "qkv":
            self.to_qkv = nn.Linear(query_dim, 3 * inner, bias=False)
        else:
            self.to_q = nn.Linear(query_dim, inner, bias=False)
            self.to_kv = nn.Linear(context_dim, 2 * inner, bias=False)
        self.to_out_0 = nn.Linear(inner, query_dim)

    def tp_layout(self, parts: int, index: int) -> dict:
        """{weight: (axis, indices)} model rank `index` of `parts` keeps; {}
        for int8 layers, which stay whole (JAX's int8 leaves match no rule)."""
        linears = [self.to_out_0, *((self.to_qkv,) if self.fuse == "qkv" else
                                    (self.to_q, self.to_kv))]
        if any(type(m) is not nn.Linear for m in linears):
            return {}
        dh = self.to_out_0.in_features // self.heads
        inner = self.heads * dh
        lo, hi = split_span(self.heads, parts, index)
        rows = torch.arange(lo * dh, hi * dh)
        if self.fuse == "qkv":
            out = {"to_qkv.weight": (0, torch.cat([rows, rows + inner, rows + 2 * inner]))}
        else:
            out = {"to_q.weight": (0, rows), "to_kv.weight": (0, torch.cat([rows, rows + inner]))}
        out["to_out_0.weight"] = (1, rows)
        return out

    def enter_tp_(self, mesh, parts: int, index: int) -> None:
        lo, hi = split_span(self.heads, parts, index)
        self.local_heads, self.tp_mesh = hi - lo, mesh

    def forward(self, x, context=None, bias=None):
        tp = self.tp_mesh
        if tp is not None:
            x = copy_to_model(x, tp)
            context = None if context is None else copy_to_model(context, tp)
        if self.fuse == "qkv":
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        else:
            q = self.to_q(x)
            k, v = self.to_kv(x if context is None else context).chunk(2, dim=-1)
        if self.local_heads:
            out = multi_head_attention(q, k, v, heads=self.local_heads, bias=bias,
                                       upcast=self.upcast)
        else:
            out = q  # no head on this rank: (B, S, 0), a zero partial sum below
        if tp is None:
            return self.to_out_0(out)
        return reduce_from_model(F.linear(out, self.to_out_0.weight), tp) + self.to_out_0.bias


class FeedForward(nn.Module):
    """GEGLU feed-forward, mult 4. Under tensor parallelism a model rank keeps
    a span of the 4 * dim hidden units: net_0_proj's rows of both halves,
    [hidden_local; gate_local], and net_2's columns; net_0_proj's bias stays
    whole (a 1-D leaf, replicated by the rules) and is indexed at use."""

    def __init__(self, dim: int):
        super().__init__()
        self.net_0_proj = nn.Linear(dim, dim * 8)
        self.net_2 = nn.Linear(dim * 4, dim)
        self.tp_mesh = None

    def _span(self, parts: int, index: int) -> torch.Tensor:
        return torch.arange(*split_span(self.net_2.in_features, parts, index))

    def tp_layout(self, parts: int, index: int) -> dict:
        if type(self.net_0_proj) is not nn.Linear or type(self.net_2) is not nn.Linear:
            return {}
        rows = self._span(parts, index)
        return {"net_0_proj.weight": (0, torch.cat([rows, rows + self.net_2.in_features])),
                "net_2.weight": (1, rows)}

    def enter_tp_(self, mesh, parts: int, index: int) -> None:
        self.tp_mesh = mesh
        cols = self.tp_layout(parts, index)["net_0_proj.weight"][1]
        self.register_buffer("tp_cols", cols.to(self.net_2.weight.device), persistent=False)

    def forward(self, x):
        tp = self.tp_mesh
        if tp is None:
            return self.net_2(geglu(self.net_0_proj(x)))
        x = copy_to_model(x, tp)
        # the whole bias through copy_to_model: each rank's gradient covers
        # its own columns, and the all-reduce gives every rank all of them
        b = copy_to_model(self.net_0_proj.bias, tp)[self.tp_cols]
        h = geglu(F.linear(x, self.net_0_proj.weight, b))
        return reduce_from_model(F.linear(h, self.net_2.weight), tp) + self.net_2.bias


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int, upcast: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head, dim, upcast, fuse="qkv")
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, context_dim, upcast, fuse="kv")
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, context_bias):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context, bias=context_bias)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """Spatial transformer over NCHW features (linear projections)."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 cfg: UNetConfig):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(channels, cfg.norm_num_groups, 1e-6)
        # a 1x1 conv projection is a dense over channels; JAX keeps a
        # distinct name for it, and so does the port
        self.proj_names = ("proj_in", "proj_out") if cfg.use_linear_projection else (
            "proj_in_conv", "proj_out_conv")
        self.add_module(self.proj_names[0], nn.Linear(channels, inner))
        self.transformer_blocks_0 = BasicTransformerBlock(
            inner, heads, dim_head, context_dim, cfg.upcast_attention)
        self.add_module(self.proj_names[1], nn.Linear(inner, channels))

    def forward(self, x, context, context_bias):
        b, c, hh, ww = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = getattr(self, self.proj_names[0])(h)
        h = self.transformer_blocks_0(h, context, context_bias)
        h = getattr(self, self.proj_names[1])(h)
        return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int, padding: int):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=padding)

    def forward(self, x):
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))  # asymmetric pad-then-conv of diffusers
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _stream_names(prefix: str, cfg: UNetConfig) -> list:
    return [prefix] + [f"{prefix}_extra{j}" for j in range(1, 1 + cfg.extra_cond_streams)]


def _add_streams(owner: nn.Module, prefix: str, ch: int, heads: int, cfg: UNetConfig) -> None:
    """One Transformer2DModel per conditioning stream, each with the width
    of its own context."""
    dims = (cfg.cross_attention_dim, *cfg.extra_cond_dims)
    for name, dim in zip(_stream_names(prefix, cfg), dims):
        owner.add_module(name, Transformer2DModel(ch, heads, ch // heads, dim, cfg))


def _run_streams(owner: nn.Module, prefix: str, x, contexts, biases):
    """The stream transformers in sequence: text, then the extra streams."""
    for name, context, bias in zip(_stream_names(prefix, owner.cfg), contexts, biases):
        x = getattr(owner, name)(x, context, bias)
    return x


class _Block(nn.Module):
    """One down or up level: resnets, optional transformers, optional resampler.

    `in_channels[i]` is the input width of resnet i (the skip connection
    already concatenated for up levels)."""

    def __init__(self, cfg: UNetConfig, in_channels, out_ch: int, temb_ch: int,
                 heads: int | None, resample: str | None):
        super().__init__()
        self.cfg = cfg
        self.n = len(in_channels)
        self.has_attn = heads is not None
        for i, cin in enumerate(in_channels):
            self.add_module(f"resnets_{i}", ResnetBlock2D(
                cin, out_ch, temb_ch, cfg.norm_num_groups, cfg.norm_eps))
            if self.has_attn:
                _add_streams(self, f"attentions_{i}", out_ch, heads, cfg)
        if resample == "down":
            self.downsamplers_0 = Downsample2D(out_ch, cfg.downsample_padding)
        elif resample == "up":
            self.upsamplers_0 = Upsample2D(out_ch)

    def layer(self, i, x, temb, context, bias):
        x = getattr(self, f"resnets_{i}")(x, temb)
        if self.has_attn:
            x = _run_streams(self, f"attentions_{i}", x, context, bias)
        return x

    def down(self, x, temb, context, bias):
        """A down level: its output and the skip states it adds."""
        outs = []
        for i in range(self.n):
            x = self.layer(i, x, temb, context, bias)
            outs.append(x)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
            outs.append(x)
        return x, outs

    def up(self, x, skips, temb, context, bias):
        """An up level over its skip states, the last one first."""
        for j in range(self.n):
            x = torch.cat([x, skips[-1 - j]], dim=1)
            x = self.layer(j, x, temb, context, bias)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x


class UNetMidBlock2DCrossAttn(nn.Module):
    """resnet -> transformer -> resnet at the lowest resolution."""

    def __init__(self, cfg: UNetConfig, ch: int, temb_ch: int, heads: int):
        super().__init__()
        self.cfg = cfg
        self.resnets_0 = ResnetBlock2D(ch, ch, temb_ch, cfg.norm_num_groups, cfg.norm_eps)
        _add_streams(self, "attentions_0", ch, heads, cfg)
        self.resnets_1 = ResnetBlock2D(ch, ch, temb_ch, cfg.norm_num_groups, cfg.norm_eps)

    def forward(self, x, temb, context, bias):
        x = _run_streams(self, "attentions_0", self.resnets_0(x, temb), context, bias)
        return self.resnets_1(x, temb)


class UNet2DConditionModel(nn.Module):
    """The denoiser: sample (B, T, F, C), timesteps (B,) or scalar, text
    context (B, S, D) with an optional 0/1 key mask (B, S) -> (B, T, F, C).

    With extra streams the context is a list, one (B, S_j, D_j) per stream,
    and the mask a list of the same length, or one mask (or None) for every
    stream (tango_tpu/models/unet.py:452-467)."""

    def __init__(self, cfg: UNetConfig, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        ch = cfg.block_out_channels
        temb_ch = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], cfg.conv_in_kernel,
                                 padding=(cfg.conv_in_kernel - 1) // 2)

        skips = [ch[0]]
        cin = ch[0]
        for level, kind in enumerate(cfg.down_block_types):
            if kind not in ("CrossAttnDownBlock2D", "DownBlock2D"):
                raise ValueError(f"unknown down block {kind}")
            out = ch[level]
            final = level == len(ch) - 1
            heads = cfg.heads_for_level(level) if kind == "CrossAttnDownBlock2D" else None
            ins = [cin] + [out] * (cfg.layers_per_block - 1)
            self.add_module(f"down_blocks_{level}", _Block(
                cfg, ins, out, temb_ch, heads, None if final else "down"))
            skips += [out] * (cfg.layers_per_block + (0 if final else 1))
            cin = out

        if cfg.mid_block_type == "UNetMidBlock2DCrossAttn":
            self.mid_block = UNetMidBlock2DCrossAttn(cfg, ch[-1], temb_ch,
                                                     cfg.heads_for_level(len(ch) - 1))
        elif cfg.mid_block_type is not None:
            raise ValueError(f"unknown mid block {cfg.mid_block_type}")

        rev = list(reversed(ch))
        rev_heads = list(reversed([cfg.heads_for_level(i) for i in range(len(ch))]))
        for i, kind in enumerate(cfg.up_block_types):
            if kind not in ("CrossAttnUpBlock2D", "UpBlock2D"):
                raise ValueError(f"unknown up block {kind}")
            out = rev[i]
            final = i == len(cfg.up_block_types) - 1
            ins = []
            for _ in range(cfg.layers_per_block + 1):
                ins.append(cin + skips.pop())
                cin = out
            heads = rev_heads[i] if kind == "CrossAttnUpBlock2D" else None
            self.add_module(f"up_blocks_{i}", _Block(
                cfg, ins, out, temb_ch, heads, None if final else "up"))

        self.conv_norm_out = GroupNorm(ch[0], cfg.norm_num_groups, cfg.norm_eps, act="silu")
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, cfg.conv_out_kernel,
                                  padding=(cfg.conv_out_kernel - 1) // 2)
        if cfg.quant_int8:
            # int8 modules in place of the scope's float ones; their weights
            # are placeholders until a state dict is loaded
            quantize_unet_(self, cfg.quant_scope)

    def forward(self, sample, timesteps, encoder_hidden_states, encoder_attention_mask=None):
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        n_streams = 1 + cfg.extra_cond_streams
        contexts = (list(encoder_hidden_states)
                    if isinstance(encoder_hidden_states, (tuple, list))
                    else [encoder_hidden_states])
        assert len(contexts) == n_streams, (len(contexts), n_streams)
        masks = (list(encoder_attention_mask)
                 if isinstance(encoder_attention_mask, (tuple, list))
                 else [encoder_attention_mask] * n_streams)
        context = [c.to(dtype) for c in contexts]
        bias = [None if m is None else mask_to_bias(m)[:, None, :] for m in masks]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps[None].expand(sample.shape[0])
        if cfg.center_input_sample:
            sample = 2.0 * sample - 1.0

        t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0],
                                       cfg.flip_sin_to_cos, float(cfg.freq_shift))
        temb = self.time_embedding(t_emb.to(dtype))

        def run(fn, *args):
            if self.remat and torch.is_grad_enabled():
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        x = self.conv_in(nhwc_to_nchw(sample.to(dtype)))
        res = [x]
        for level in range(len(cfg.down_block_types)):
            x, outs = run(getattr(self, f"down_blocks_{level}").down, x, temb, context, bias)
            res += outs

        if cfg.mid_block_type is not None:
            x = run(self.mid_block, x, temb, context, bias)

        for i in range(len(cfg.up_block_types)):
            blk = getattr(self, f"up_blocks_{i}")
            skips = res[-blk.n:]
            del res[-blk.n:]
            x = run(blk.up, x, skips, temb, context, bias)

        x = self.conv_out(self.conv_norm_out(x))
        return nchw_to_nhwc(x)
