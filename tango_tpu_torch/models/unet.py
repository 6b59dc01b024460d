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

`latent_sharder=functools.partial(parallel.mesh.shard_latents_seq,
mesh=mesh)` (JAX's field) runs the forward sequence-parallel over the
mesh's 'model' ranks, each holding the whole input and the parameters
replicated: from `conv_in` to `conv_out` each rank computes its
contiguous slab of the latent time axis T (channels-first, the rows of
dim 2) at every level that 'model' divides into slabs of an even number of
rows (or of any number at the last level, which does not downsample);
another level runs whole on every rank (JAX leaves it unconstrained), its
input gathered, and the slabs resume at the next level that divides. The
exchanges (parallel/mesh.py):
  * a 3x3 stride-1 convolution (`seq_conv`: the resnets', `conv_out`)
    reads one halo row from each neighbour and pads only F; `conv_in` takes
    its halo from the whole input every rank holds; `Upsample2D` exchanges
    its rows before the nearest-2x upsample, which makes them the halo
    after it; `Downsample2D` (a slab starts on an even row) reads the row
    above with padding 1, the row below with diffusers' asymmetric padding 0;
  * a GroupNorm all-reduces its partial sums (ops.basic.group_norm's `sp`);
  * a self-attention gathers its normed hidden states (C wide, half the
    bytes of K and V) and projects K and V for every token; each rank keeps
    its queries (a T-slab of (T, F) row-major tokens is a contiguous range);
  * an int8 convolution (QConv2d, the 3x3s, the resamplers' and the 1x1
    `conv_shortcut`) quantizes its slab with one scale a sample, the whole
    tensor's: each rank's amax, the largest taken over 'model' (one
    all-reduce, `int8_amax`), as XLA's SPMD takes JAX's `_quantize_act`
    amax over the whole; QLinear quantizes each token alone, locally;
  * projections, the feed-forward, every stream's cross-attention and the
    float 1x1 convolutions are local; the output is gathered along T, so
    every rank returns the meshless-shaped prediction.
It trains: each exchange carries its backward (parallel/mesh.py's gradient
rule), and the output passes its gradient divided by 'model'
(`partial_grad`), since every model rank computes the same loss from it;
the parameters' gradients are then the slab's partial ones, which the
trainer sums over 'model'. Under `remat` each block's forward exchanges run
again inside the backward, in the same order on every rank. It raises for a
TP-sharded UNet (SP and TP are alternative uses of 'model').

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
from tango_tpu_torch.ops.quant import QConv2d, QLinear, act_amax, int8_dot, quantize_unet_
from tango_tpu_torch.parallel.mesh import (
    all_max_over_model_,
    copy_to_model,
    gather_seq,
    halo_rows,
    partial_grad,
    reduce_from_model,
    seq_mesh,
    slab_span,
    split_span,
)


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


def _pad_f(conv) -> int:
    """A convolution's padding of F (its padding of T too: both symmetric)."""
    return conv.padding if isinstance(conv, QConv2d) else conv.padding[1]


def _conv_unpadded_t(conv, x, amax=None):
    """conv over x with no padding of T, x's first spatial axis: x carries
    the rows the padding would give. An int8 conv quantizes with `amax`,
    the whole tensor's (`_slab_amax`)."""
    if isinstance(conv, QConv2d):
        return conv(x, padding=(0, conv.padding), amax=amax)
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, (0, _pad_f(conv)))


def _slab_amax(conv, x, sp):
    """For an int8 conv of this rank's T-slab x: the per-sample amax of the
    whole tensor, the largest of every slab's (one all-reduce over 'model',
    `int8_amax`), which the meshless quantize takes; None for a float conv.
    The halo rows are other slabs' own values and the pads zeros, so the
    slab, its halo and its pads quantize with it to the meshless int8
    values."""
    return all_max_over_model_(act_amax(x), sp) if isinstance(conv, QConv2d) else None


def seq_conv(conv, x, sp):
    """A 'same' stride-1 convolution of x (a 3x3 or a 1x1); under sequence
    parallelism (`sp`, the mesh) of this rank's T-slab x, the neighbours'
    halo rows in place of T's zero padding."""
    if sp is None:
        return conv(x)
    amax, h = _slab_amax(conv, x, sp), _pad_f(conv)
    if h:
        top, bottom = halo_rows(x, sp, h, h)
        x = torch.cat([top, x, bottom], 2)
    return _conv_unpadded_t(conv, x, amax)


def _down_len(t: int, padding: int) -> int:
    """Rows after a Downsample2D of t rows."""
    return (t + 2 * padding - 3) // 2 + 1 if padding else (t - 2) // 2 + 1


def _reslab(x, src, dst, kind: str = "level"):
    """x (B, C, T, F) from one level's placement to another's: a mesh, this
    rank's T-slab; None, the whole."""
    if src is not None and dst is None:
        return gather_seq(x, src, 2, kind)
    if src is None and dst is not None:
        return x.narrow(2, *slab_span(x.shape[2], dst)).contiguous()
    return x


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

    def forward(self, x, temb, sp=None):
        h = seq_conv(self.conv1, self.norm1(x, sp), sp)
        h = h + self.time_emb_proj(silu(temb))[:, :, None, None]
        h = seq_conv(self.conv2, self.norm2(h, sp), sp)
        if self.conv_shortcut is not None:
            x = seq_conv(self.conv_shortcut, x, sp)
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

    def forward(self, x, context=None, bias=None, sp=None):
        if sp is not None:
            return self.to_out_0(self._seq_self_attention(x, sp))
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

    def _seq_self_attention(self, x, sp):
        """Self-attention of a T-slab's tokens x under sequence parallelism:
        the normed hidden states of every token gathered (in rank order, the
        token order), q projected for the slab, k and v for every token."""
        whole = gather_seq(x, sp, 1, "kv")
        inner = self.to_out_0.in_features
        q = self._qkv_rows(x, 0, inner)
        k, v = self._qkv_rows(whole, inner, 3 * inner).chunk(2, dim=-1)
        return multi_head_attention(q, k, v, heads=self.heads, upcast=self.upcast,
                                    global_queries=whole.shape[1])

    def _qkv_rows(self, x, lo: int, hi: int):
        """x through rows lo:hi of the fused to_qkv; an int8 to_qkv quantizes
        each token alone, so its rows' products are the fused one's."""
        m = self.to_qkv
        if isinstance(m, QLinear):
            return int8_dot(x, m.weight[lo:hi], m.weight_scale[lo:hi])
        return F.linear(x, m.weight[lo:hi])


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

    def forward(self, x, context, context_bias, sp=None):
        x = x + self.attn1(self.norm1(x), sp=sp)
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

    def forward(self, x, context, context_bias, sp=None):
        b, c, hh, ww = x.shape
        h = self.norm(x, sp).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = getattr(self, self.proj_names[0])(h)
        h = self.transformer_blocks_0(h, context, context_bias, sp)
        h = getattr(self, self.proj_names[1])(h)
        return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int, padding: int):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=padding)

    def forward(self, x, sp=None):
        if sp is not None:
            # output row i reads rows 2i - p .. 2i - p + 2, so a slab that
            # starts on an even row reads p rows above it, and with p = 0 the
            # row below (the last rank's: the pad's zero row)
            amax = _slab_amax(self.conv, x, sp)
            top, bottom = halo_rows(x, sp, self.padding, int(self.padding == 0))
            x = torch.cat([top, x, bottom], 2)
            return _conv_unpadded_t(self.conv, F.pad(x, (0, 1)) if self.padding == 0 else x,
                                    amax)
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))  # asymmetric pad-then-conv of diffusers
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, sp=None):
        if sp is None:
            return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        # the neighbours' rows before the upsample are its halo after it
        # (nearest: the upsample keeps the amax)
        amax = _slab_amax(self.conv, x, sp)
        top, bottom = halo_rows(x, sp, 1, 1)
        up = F.interpolate(torch.cat([top, x, bottom], 2), scale_factor=2.0, mode="nearest")
        return _conv_unpadded_t(self.conv, up[:, :, 1:-1], amax)


def _stream_names(prefix: str, cfg: UNetConfig) -> list:
    return [prefix] + [f"{prefix}_extra{j}" for j in range(1, 1 + cfg.extra_cond_streams)]


def _add_streams(owner: nn.Module, prefix: str, ch: int, heads: int, cfg: UNetConfig) -> None:
    """One Transformer2DModel per conditioning stream, each with the width
    of its own context."""
    dims = (cfg.cross_attention_dim, *cfg.extra_cond_dims)
    for name, dim in zip(_stream_names(prefix, cfg), dims):
        owner.add_module(name, Transformer2DModel(ch, heads, ch // heads, dim, cfg))


def _run_streams(owner: nn.Module, prefix: str, x, contexts, biases, sp=None):
    """The stream transformers in sequence: text, then the extra streams."""
    for name, context, bias in zip(_stream_names(prefix, owner.cfg), contexts, biases):
        x = getattr(owner, name)(x, context, bias, sp)
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

    def layer(self, i, x, temb, context, bias, sp=None):
        x = getattr(self, f"resnets_{i}")(x, temb, sp)
        if self.has_attn:
            x = _run_streams(self, f"attentions_{i}", x, context, bias, sp)
        return x

    def down(self, x, temb, context, bias, sp=None):
        """A down level: its output and the skip states it adds. `sp`: the
        mesh whose T-slabs x is, or None."""
        outs = []
        for i in range(self.n):
            x = self.layer(i, x, temb, context, bias, sp)
            outs.append(x)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x, sp)
            outs.append(x)
        return x, outs

    def up(self, x, skips, temb, context, bias, sp=None):
        """An up level over its skip states, the last one first."""
        for j in range(self.n):
            x = torch.cat([x, skips[-1 - j]], dim=1)
            x = self.layer(j, x, temb, context, bias, sp)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x, sp)
        return x


class UNetMidBlock2DCrossAttn(nn.Module):
    """resnet -> transformer -> resnet at the lowest resolution."""

    def __init__(self, cfg: UNetConfig, ch: int, temb_ch: int, heads: int):
        super().__init__()
        self.cfg = cfg
        self.resnets_0 = ResnetBlock2D(ch, ch, temb_ch, cfg.norm_num_groups, cfg.norm_eps)
        _add_streams(self, "attentions_0", ch, heads, cfg)
        self.resnets_1 = ResnetBlock2D(ch, ch, temb_ch, cfg.norm_num_groups, cfg.norm_eps)

    def forward(self, x, temb, context, bias, sp=None):
        x = _run_streams(self, "attentions_0", self.resnets_0(x, temb, sp), context, bias, sp)
        return self.resnets_1(x, temb, sp)


class UNet2DConditionModel(nn.Module):
    """The denoiser: sample (B, T, F, C), timesteps (B,) or scalar, text
    context (B, S, D) with an optional 0/1 key mask (B, S) -> (B, T, F, C).

    With extra streams the context is a list, one (B, S_j, D_j) per stream,
    and the mask a list of the same length, or one mask (or None) for every
    stream (tango_tpu/models/unet.py:452-467)."""

    def __init__(self, cfg: UNetConfig, remat: bool = False, latent_sharder=None):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.latent_sharder = latent_sharder
        seq_mesh(latent_sharder)  # a sharder the port cannot read raises here
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

    def _seq_plan(self, sample, mesh) -> list:
        """Each level's placement under the latent sharder's mesh: the mesh
        where the level runs on T-slabs, None where it runs whole (every
        level without sequence parallelism). Raises where SP cannot run."""
        levels = len(self.cfg.block_out_channels)
        if mesh is None:
            return [None] * levels
        for m in self.modules():
            if getattr(m, "tp_mesh", None) is not None:
                raise ValueError("sequence parallelism of a TP-sharded UNet: SP and TP are "
                                 "alternative uses of 'model'; shard_params(tp=False)")
        parts, t, plan = mesh.shape["model"], sample.shape[1], []
        for level in range(levels):
            last = level == levels - 1
            plan.append(mesh if t % parts == 0 and (last or t // parts % 2 == 0) else None)
            t = _down_len(t, self.cfg.downsample_padding)
        return plan

    def _conv_in_slab(self, x, sp):
        """conv_in over this rank's T-slab of the whole input x, its halo
        taken from x (every rank holds all of it)."""
        p = self.conv_in.padding[0]
        start, n = slab_span(x.shape[2], sp)
        return _conv_unpadded_t(self.conv_in, F.pad(x, (0, 0, p, p)).narrow(2, start, n + 2 * p))

    def forward(self, sample, timesteps, encoder_hidden_states, encoder_attention_mask=None):
        cfg = self.cfg
        mesh = seq_mesh(self.latent_sharder)
        plan = self._seq_plan(sample, mesh)
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

        x = nhwc_to_nchw(sample.to(dtype))
        x = self.conv_in(x) if plan[0] is None else self._conv_in_slab(x, plan[0])
        res = [x]
        for level in range(len(cfg.down_block_types)):
            blk = getattr(self, f"down_blocks_{level}")
            x, outs = run(blk.down, x, temb, context, bias, plan[level])
            if hasattr(blk, "downsamplers_0"):
                x = outs[-1] = _reslab(x, plan[level], plan[level + 1])
            res += outs

        if cfg.mid_block_type is not None:
            x = run(self.mid_block, x, temb, context, bias, plan[-1])

        for i in range(len(cfg.up_block_types)):
            level = len(cfg.up_block_types) - 1 - i
            blk = getattr(self, f"up_blocks_{i}")
            skips = res[-blk.n:]
            del res[-blk.n:]
            x = run(blk.up, x, skips, temb, context, bias, plan[level])
            if hasattr(blk, "upsamplers_0"):
                x = _reslab(x, plan[level], plan[level - 1])

        x = seq_conv(self.conv_out, self.conv_norm_out(x, plan[0]), plan[0])
        if mesh is not None:
            x = partial_grad(x, mesh)
        return nchw_to_nhwc(_reslab(x, plan[0], None, "output"))
