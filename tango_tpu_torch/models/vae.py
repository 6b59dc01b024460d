"""AudioLDM KL autoencoder, port of tango_tpu/models/vae.py.

Public layouts follow JAX: latents (B, T, F, z) and mels (B, T*2^(L-1),
F*2^(L-1), 1). Inside, activations are NCHW. The mid attention blocks stay
plain matmul + softmax, as they are in JAX. The encoder (training's side) is
built with `AutoencoderKL(cfg, with_encoder=True)`; serving builds the decode
side alone. Its large feature maps take the two-stage GroupNorm kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tango_tpu_torch.configs import VAEConfig
from tango_tpu_torch.models.layers import GroupNorm, nchw_to_nhwc, nhwc_to_nchw


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, 32, 1e-6, act="silu")
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(out_ch, 32, 1e-6, act="silu")
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1-conv q, k, v."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm(ch, 32, 1e-6)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)

        def tokens(conv):  # (B, C, H, W) -> (B, H*W, C)
            return conv(h).reshape(b, c, hh * ww).transpose(1, 2)

        q, k, v = tokens(self.q), tokens(self.k), tokens(self.v)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2))
        probs = torch.softmax(logits * (c**-0.5), dim=-1).to(x.dtype)
        h = torch.matmul(probs, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class VAEUpsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAEDownsample(nn.Module):
    """Asymmetric (0, 1, 0, 1) zero pad, then a stride-2 VALID 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        levels = len(cfg.ch_mult)
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        self.order = []  # module names in forward order
        res, block_in = cfg.resolution, cfg.ch
        for level in range(levels):
            out = cfg.ch * cfg.ch_mult[level]
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_block_{i}", VAEResnetBlock(block_in, out))
                self.order.append(f"down_{level}_block_{i}")
                block_in = out
                if res in cfg.attn_resolutions:
                    self.add_module(f"down_{level}_attn_{i}", VAEAttnBlock(out))
                    self.order.append(f"down_{level}_attn_{i}")
            if level != levels - 1:
                self.add_module(f"down_{level}_downsample", VAEDownsample(out))
                self.order.append(f"down_{level}_downsample")
                res //= 2
        self.mid_block_1 = VAEResnetBlock(block_in, block_in)
        self.mid_attn_1 = VAEAttnBlock(block_in)
        self.mid_block_2 = VAEResnetBlock(block_in, block_in)
        self.norm_out = GroupNorm(block_in, 32, 1e-6, act="silu")
        z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(block_in, z_out, 3, padding=1)

    def forward(self, x):
        """x (B, in_channels, H, W) NCHW -> (B, 2z, H', W') NCHW."""
        h = self.conv_in(x)
        for name in self.order:
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        levels = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid_block_1 = VAEResnetBlock(block_in, block_in)
        self.mid_attn_1 = VAEAttnBlock(block_in)
        self.mid_block_2 = VAEResnetBlock(block_in, block_in)
        self.order = []  # module names in forward order
        res = cfg.resolution // 2 ** (levels - 1)
        for level in reversed(range(levels)):
            out = cfg.ch * cfg.ch_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_block_{i}", VAEResnetBlock(block_in, out))
                self.order.append(f"up_{level}_block_{i}")
                block_in = out
                if res in cfg.attn_resolutions:
                    self.add_module(f"up_{level}_attn_{i}", VAEAttnBlock(out))
                    self.order.append(f"up_{level}_attn_{i}")
            if level != 0:
                self.add_module(f"up_{level}_upsample", VAEUpsample(out))
                self.order.append(f"up_{level}_upsample")
                res *= 2
        self.norm_out = GroupNorm(block_in, 32, 1e-6, act="silu")
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, z):
        """z (B, z, H, W) NCHW -> (B, out_ch, H', W') NCHW."""
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for name in self.order:
            h = getattr(self, name)(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """post_quant_conv + decoder, and with `with_encoder` encoder + quant_conv."""

    def __init__(self, cfg: VAEConfig, with_encoder: bool = False):
        super().__init__()
        self.cfg = cfg
        if with_encoder:
            self.encoder = Encoder(cfg)
            self.quant_conv = nn.Conv2d(self.encoder.conv_out.out_channels, 2 * cfg.embed_dim, 1)
        self.decoder = Decoder(cfg)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def encode_moments(self, x: torch.Tensor):
        """mel (B, T, F, 1) -> (mean, logvar), each (B, T/4, F/4, embed_dim)."""
        dtype = self.quant_conv.weight.dtype
        moments = nchw_to_nhwc(self.quant_conv(self.encoder(nhwc_to_nchw(x.to(dtype)))))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode_first_stage(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """mel -> scaled latent drawn from the posterior with `generator`."""
        mean, logvar = self.encode_moments(x)
        return self.cfg.scale_factor * sample_diagonal_gaussian(mean, logvar, generator)

    def encode_first_stage_mode(self, x: torch.Tensor) -> torch.Tensor:
        mean, _ = self.encode_moments(x)
        return self.cfg.scale_factor * mean

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, T, F, embed_dim) -> mel (B, T', F', out_ch)."""
        dtype = self.post_quant_conv.weight.dtype
        x = self.post_quant_conv(nhwc_to_nchw(z.to(dtype)))
        return nchw_to_nhwc(self.decoder(x))

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z / self.cfg.scale_factor)


def sample_diagonal_gaussian(mean, logvar, generator=None, noise=None):
    """A draw of the diagonal Gaussian posterior; `noise` replaces the
    standard normal draw (the tests feed both packages the same numbers)."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise


def kl_diagonal_gaussian(mean, logvar):
    """KL(posterior || N(0, I)) per batch element."""
    return 0.5 * torch.sum(mean**2 + torch.exp(logvar) - 1.0 - logvar,
                           dim=tuple(range(1, mean.dim())))
