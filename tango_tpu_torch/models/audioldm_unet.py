"""AudioLDM's FiLM-conditioned UNet (openai style), port of
tango_tpu/models/audioldm_unet.py.

The audioldm-s geometry: model_channels 128, channel_mult (1, 2, 3, 5), two
res blocks a level, self-attention spatial transformers at downsample rates
{2, 4, 8}, heads of num_head_channels = 32, and a 512-wide CLAP embedding
that conditions the res blocks through the time embedding, concatenated to
it (extra_film_use_concat) or added. Where it differs from the Tango UNet
(models/unet.py):
  * the timestep embedding is ordered [cos, sin];
  * a skip state is saved after every input block, downsamples included;
  * the spatial transformer has no context: attn2 is a second self-attention;
  * proj_in and proj_out are 1x1 convolutions;
  * the downsample is a symmetric pad-1 stride-2 convolution.

The forward takes and returns (B, T, F, C), as the JAX module does; inside,
activations are NCHW. Submodules carry the JAX module names (`input_4_res`,
`middle_attn`, `output_2_up`, ...), so a Flax parameter path maps onto a
state-dict key (utils/convert.py:from_jax_params), the self-attentions'
q, k and v fused into one `to_qkv`. GroupNorm goes through
ops.basic.group_norm (the GN kernels) and attention through
ops.attention.multi_head_attention (the attention kernel at Sq >= 256; head
dim 32 here, which attn_fwd's tensor-core body takes); convolutions and
projections are cuDNN / cuBLAS, as they were XLA in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tango_tpu_torch.configs import _FromDict
from tango_tpu_torch.models.layers import GroupNorm, nchw_to_nhwc, nhwc_to_nchw
from tango_tpu_torch.models.unet import Attention, FeedForward
from tango_tpu_torch.ops.basic import silu
from tango_tpu_torch.utils.convert import StateDict


@dataclasses.dataclass(frozen=True)
class FilmUNetConfig(_FromDict):
    """Key-compatible with the reference's unet_config params and JAX's
    FilmUNetConfig."""

    image_size: int = 64
    in_channels: int = 8
    out_channels: int = 8
    model_channels: int = 128
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 4, 2)
    channel_mult: Tuple[int, ...] = (1, 2, 3, 5)
    num_head_channels: int = 32
    extra_film_condition_dim: Optional[int] = 512
    extra_film_use_concat: bool = True
    use_spatial_transformer: bool = True
    use_scale_shift_norm: bool = False
    conv_resample: bool = True

    def __post_init__(self):
        object.__setattr__(self, "attention_resolutions", tuple(self.attention_resolutions))
        object.__setattr__(self, "channel_mult", tuple(self.channel_mult))


AUDIOLDM_S_UNET = FilmUNetConfig()


def openai_timestep_embedding(timesteps: torch.Tensor, dim: int,
                              max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding ordered [cos, sin], f32; a zero column for odd dim."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class FilmResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, use_scale_shift_norm: bool):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm(in_ch, 32, 1e-5, act="silu")
        self.in_conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.emb_proj = nn.Linear(emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch)
        # with scale-shift the SiLU comes after the FiLM affine
        self.out_norm = GroupNorm(out_ch, 32, 1e-5,
                                  act=None if use_scale_shift_norm else "silu")
        self.out_conv = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.skip = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, emb):
        h = self.in_conv(self.in_norm(x))
        e = self.emb_proj(silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = silu(self.out_norm(h) * (1.0 + scale) + shift)
        else:
            h = self.out_norm(h + e)
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class SelfSpatialTransformer(nn.Module):
    """The spatial transformer without context: both attentions are self."""

    def __init__(self, channels: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        self.norm1 = nn.LayerNorm(inner, eps=1e-5)
        self.attn1 = Attention(inner, heads, dim_head, inner, upcast=True, fuse="qkv")
        self.norm2 = nn.LayerNorm(inner, eps=1e-5)
        self.attn2 = Attention(inner, heads, dim_head, inner, upcast=True, fuse="qkv")
        self.norm3 = nn.LayerNorm(inner, eps=1e-5)
        self.ff = FeedForward(inner)
        self.proj_out = nn.Conv2d(inner, channels, 1)

    def forward(self, x):
        b, _, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        inner = h.shape[1]
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, inner)
        h = h + self.attn1(self.norm1(h))
        h = h + self.attn2(self.norm2(h))
        h = h + self.ff(self.norm3(h))
        h = h.reshape(b, hh, ww, inner).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class FilmDownsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class FilmUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class FilmUNet(nn.Module):
    def __init__(self, cfg: FilmUNetConfig = AUDIOLDM_S_UNET):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        time_dim = mc * 4
        self.time_embed_0 = nn.Linear(mc, time_dim)
        self.time_embed_2 = nn.Linear(time_dim, time_dim)
        emb_dim = time_dim
        if cfg.extra_film_condition_dim is not None:
            self.film_emb = nn.Linear(cfg.extra_film_condition_dim, time_dim)
            if cfg.extra_film_use_concat:
                emb_dim = 2 * time_dim
        self.input_conv = nn.Conv2d(cfg.in_channels, mc, 3, padding=1)

        def res(name, cin, cout):
            self.add_module(name, FilmResBlock(cin, cout, emb_dim, cfg.use_scale_shift_norm))

        def attn(name, ch):
            self.add_module(name, SelfSpatialTransformer(ch, ch // cfg.num_head_channels,
                                                         cfg.num_head_channels))

        # the constructor walk of the JAX module: (kind, name) in call order
        self.plan = []
        chans = [mc]
        ch, ds, idx = mc, 1, 1
        n_levels = len(cfg.channel_mult)
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                res(f"input_{idx}_res", ch, mult * mc)
                ch = mult * mc
                self.plan.append(("res", f"input_{idx}_res"))
                if ds in cfg.attention_resolutions:
                    attn(f"input_{idx}_attn", ch)
                    self.plan.append(("attn", f"input_{idx}_attn"))
                self.plan.append(("push", None))
                chans.append(ch)
                idx += 1
            if level != n_levels - 1:
                self.add_module(f"input_{idx}_down", FilmDownsample(ch))
                self.plan += [("down", f"input_{idx}_down"), ("push", None)]
                chans.append(ch)
                idx += 1
                ds *= 2
        res("middle_res1", ch, ch)
        attn("middle_attn", ch)
        res("middle_res2", ch, ch)
        self.plan += [("res", "middle_res1"), ("attn", "middle_attn"), ("res", "middle_res2")]
        idx = 0
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                self.plan.append(("pop", None))
                res(f"output_{idx}_res", ch + chans.pop(), mc * mult)
                ch = mc * mult
                self.plan.append(("res", f"output_{idx}_res"))
                if ds in cfg.attention_resolutions:
                    attn(f"output_{idx}_attn", ch)
                    self.plan.append(("attn", f"output_{idx}_attn"))
                if level and i == cfg.num_res_blocks:
                    self.add_module(f"output_{idx}_up", FilmUpsample(ch))
                    self.plan.append(("up", f"output_{idx}_up"))
                    ds //= 2
                idx += 1
        self.out_norm = GroupNorm(ch, 32, 1e-5, act="silu")
        self.out_conv = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps, film_cond: Optional[torch.Tensor] = None):
        """sample (B, T, F, C), timesteps (B,) or a scalar, film_cond (B,
        extra_film_condition_dim) -> (B, T, F, out_channels) in the module's dtype."""
        cfg = self.cfg
        dtype = self.input_conv.weight.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = openai_timestep_embedding(timesteps, cfg.model_channels).to(dtype)
        emb = self.time_embed_2(silu(self.time_embed_0(t_emb)))
        if cfg.extra_film_condition_dim is not None:
            if film_cond is None:
                raise ValueError("FiLM condition required")
            film = self.film_emb(film_cond.to(dtype))
            emb = torch.cat([emb, film], dim=-1) if cfg.extra_film_use_concat else emb + film

        h = self.input_conv(nhwc_to_nchw(sample.to(dtype)))
        hs = [h]
        for kind, name in self.plan:
            if kind == "res":
                h = getattr(self, name)(h, emb)
            elif kind in ("attn", "down", "up"):
                h = getattr(self, name)(h)
            elif kind == "push":
                hs.append(h)
            else:  # pop
                h = torch.cat([h, hs.pop()], dim=1)
        return nchw_to_nhwc(self.out_conv(self.out_norm(h)))


def convert_film_unet(sd: Mapping[str, torch.Tensor],
                      cfg: FilmUNetConfig = AUDIOLDM_S_UNET) -> StateDict:
    """Reference openai UNetModel state dict (`input_blocks.N.M.*`,
    `middle_block.M.*`, `output_blocks.N.M.*`, M indexing the layers of each
    TimestepEmbedSequential) -> FilmUNet's, walking the block indices in
    constructor order as JAX's converter does. Both are torch layouts: keys
    are renamed, and each self-attention's to_q | to_k | to_v concatenated
    into to_qkv."""
    out: StateDict = {}

    def take(src, dst, leaves=("weight", "bias")):
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]

    def res_block(src, dst):
        take(f"{src}.in_layers.0", f"{dst}.in_norm")
        take(f"{src}.in_layers.2", f"{dst}.in_conv")
        take(f"{src}.emb_layers.1", f"{dst}.emb_proj")
        take(f"{src}.out_layers.0", f"{dst}.out_norm")
        take(f"{src}.out_layers.3", f"{dst}.out_conv")
        if f"{src}.skip_connection.weight" in sd:
            take(f"{src}.skip_connection", f"{dst}.skip")

    def spatial(src, dst):
        for name in ("norm", "proj_in", "proj_out"):
            take(f"{src}.{name}", f"{dst}.{name}")
        tb = f"{src}.transformer_blocks.0"
        if f"{src}.transformer_blocks.1.norm1.weight" in sd:
            raise ValueError(f"{src}: more than one transformer block is not supported")
        for ln in ("norm1", "norm2", "norm3"):
            take(f"{tb}.{ln}", f"{dst}.{ln}")
        for a in ("attn1", "attn2"):
            out[f"{dst}.{a}.to_qkv.weight"] = torch.cat(
                [sd[f"{tb}.{a}.to_{n}.weight"] for n in "qkv"])
            take(f"{tb}.{a}.to_out.0", f"{dst}.{a}.to_out_0")
        take(f"{tb}.ff.net.0.proj", f"{dst}.ff.net_0_proj")
        take(f"{tb}.ff.net.2", f"{dst}.ff.net_2")

    take("time_embed.0", "time_embed_0")
    take("time_embed.2", "time_embed_2")
    if "film_emb.weight" in sd:
        take("film_emb", "film_emb")
    take("input_blocks.0.0", "input_conv")

    n_levels = len(cfg.channel_mult)
    idx, ds = 1, 1
    for level in range(n_levels):
        for _ in range(cfg.num_res_blocks):
            res_block(f"input_blocks.{idx}.0", f"input_{idx}_res")
            if ds in cfg.attention_resolutions:
                spatial(f"input_blocks.{idx}.1", f"input_{idx}_attn")
            idx += 1
        if level != n_levels - 1:
            take(f"input_blocks.{idx}.0.op", f"input_{idx}_down.conv")
            idx += 1
            ds *= 2

    res_block("middle_block.0", "middle_res1")
    spatial("middle_block.1", "middle_attn")
    res_block("middle_block.2", "middle_res2")

    idx = 0
    for level in range(n_levels - 1, -1, -1):
        for i in range(cfg.num_res_blocks + 1):
            res_block(f"output_blocks.{idx}.0", f"output_{idx}_res")
            li = 1
            if ds in cfg.attention_resolutions:
                spatial(f"output_blocks.{idx}.{li}", f"output_{idx}_attn")
                li += 1
            if level and i == cfg.num_res_blocks:
                take(f"output_blocks.{idx}.{li}.conv", f"output_{idx}_up.conv")
                ds //= 2
            idx += 1

    take("out.0", "out_norm")
    take("out.2", "out_conv")
    return out
