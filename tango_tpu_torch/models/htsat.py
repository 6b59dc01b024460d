"""HTSAT, CLAP's audio tower (a hierarchical token-semantic Swin
transformer): port of tango_tpu/models/htsat.py.

HTSAT-tiny: 48 kHz input, a 1024 / 480 STFT, 64 mels in [50, 14000] Hz,
spec_size 256 (freq_ratio 4), 4x4 patches, embed 96, depths (2, 2, 6, 2),
heads (4, 8, 16, 32), window 8. The (T, 64) log-mel is resized to (1024, 64)
by an align_corners bicubic matrix and folded into a 256 x 256 image of 4
time chunks stacked along frequency; Swin window attention with
relative-position-bias tables and shifted windows (masks built on the host
for each resolution); the token-semantic head regroups the tokens by
(frequency, time). CLAP's audio embedding is the projected trunk embedding,
L2-normalized. Inference only.

Attention is plain torch (matmul, softmax), as JAX's is einsum and softmax:
head dim 24 and 64-token windows. The patch and head convolutions run
NCHW; the tokens are (B, L, C), row-major over (frequency, time) as in JAX.
`convert_htsat` / `convert_clap_audio` map the released checkpoint's names
onto these modules' (the JAX modules' names).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tango_tpu_torch.audio.stft import hann_window_periodic, mel_filter_bank, stft_magnitude
from tango_tpu_torch.configs import _FromDict
from tango_tpu_torch.eval.panns import BatchNormEval, convert_batchnorm
from tango_tpu_torch.utils.convert import StateDict, f32_tensor


@dataclasses.dataclass(frozen=True)
class HTSATConfig(_FromDict):
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: Tuple[int, int] = (4, 4)
    in_chans: int = 1
    num_classes: int = 527
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    # audio cfg (HTSAT-tiny.json)
    sample_rate: int = 48000
    clip_samples: int = 480000
    mel_bins: int = 64
    stft_window_size: int = 1024
    hop_size: int = 480
    fmin: float = 50.0
    fmax: float = 14000.0
    # CLAP joint space
    joint_embed_dim: int = 512

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins


HTSAT_TINY = HTSATConfig()


# ------------------------------------------------------- static host helpers

def bicubic_matrix_align_corners(n_in: int, n_out: int, a: float = -0.75) -> np.ndarray:
    """(n_out, n_in) matrix of torch's F.interpolate(mode='bicubic',
    align_corners=True) along one axis (cubic convolution kernel)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)

    def kernel(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x**3 - (a + 3) * x**2 + 1
        if x < 2:
            return a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a
        return 0.0

    m = np.zeros((n_out, n_in), np.float64)
    scale = (n_in - 1) / (n_out - 1)
    for j in range(n_out):
        x = j * scale
        x0 = int(np.floor(x))
        for k in range(-1, 3):
            idx = min(max(x0 + k, 0), n_in - 1)
            m[j, idx] += kernel(x - (x0 + k))
    return m.astype(np.float32)


def relative_position_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)  # (w*w, w*w)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> Optional[np.ndarray]:
    """(nW, w*w, w*w) additive mask (0 / -100) for shifted windows."""
    if shift == 0:
        return None
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // window, window, w // window, window).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, window * window)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window * window, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """(B * nW, window * window, C) -> (B, H, W, C)."""
    b = x.shape[0] // (h * w // window // window)
    x = x.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


# ----------------------------------------------------------------- modules

class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.window, self.heads = window, heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[np.ndarray]) -> torch.Tensor:
        """x: (B * nW, w*w, C); mask: (nW, w*w, w*w) or None."""
        bnw, n, c = x.shape
        h = self.heads
        d = c // h
        idx = torch.from_numpy(relative_position_index(self.window).reshape(-1)).to(x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, h).permute(2, 0, 1)[None]
        qkv = self.qkv(x).reshape(bnw, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (d**-0.5), qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1) + bias
        if mask is not None:
            nw = mask.shape[0]
            m = torch.from_numpy(mask).to(x.device)
            attn = (attn.reshape(bnw // nw, nw, h, n, n) + m[None, :, None]).reshape(bnw, h, n, n)
        out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(bnw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, resolution: Tuple[int, int], heads: int, window: int,
                 shift: int, mlp_ratio: float = 4.0):
        super().__init__()
        h, w = resolution
        if min(h, w) <= window:
            window, shift = min(h, w), 0
        self.resolution, self.window, self.shift = resolution, window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        window, shift = self.window, self.shift
        b, l, c = x.shape
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw = self.attn(window_partition(x, window), shift_attn_mask(h, w, window, shift))
        x = window_reverse(xw, window, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x.reshape(b, l, c)
        hdn = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + hdn


class PatchMerging(nn.Module):
    def __init__(self, dim: int, resolution: Tuple[int, int]):
        super().__init__()
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class HTSAT(nn.Module):
    """(B, T_frames, mel) log-mel -> {"embedding": (B, C), "clipwise_output":
    (B, classes), "latent_map": (B, C, freq bins, time)}."""

    def __init__(self, cfg: HTSATConfig = HTSAT_TINY):
        super().__init__()
        self.cfg = cfg
        self.bn0 = BatchNormEval(cfg.mel_bins)
        self.patch_proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                                    stride=cfg.patch_stride)
        self.patch_norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        res = (cfg.spec_size // cfg.patch_stride[0], cfg.spec_size // cfg.patch_stride[1])
        dim = cfg.embed_dim
        for li, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            for bi in range(depth):
                shift = 0 if bi % 2 == 0 else cfg.window_size // 2
                setattr(self, f"layer_{li}_block_{bi}",
                        SwinBlock(dim, res, heads, cfg.window_size, shift, cfg.mlp_ratio))
            if li < len(cfg.depths) - 1:
                setattr(self, f"layer_{li}_downsample", PatchMerging(dim, res))
                res = (res[0] // 2, res[1] // 2)
                dim *= 2
        self.final_resolution = res
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        c_freq_bin = res[0] // cfg.freq_ratio
        self.tscam_conv = nn.Conv2d(dim, cfg.num_classes, (c_freq_bin, 3), padding=(0, 1))

    def reshape_wav2img(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) log-mel -> (B, 1, 256, 256) folded image: H the
        frequency axis with 4 time chunks stacked on it, W time."""
        cfg = self.cfg
        b, t, f = x.shape
        target_t = cfg.spec_size * cfg.freq_ratio
        target_f = cfg.spec_size // cfg.freq_ratio
        if t > target_t or f > target_f:
            raise ValueError(f"log-mel ({t}, {f}) exceeds ({target_t}, {target_f})")
        if t < target_t:
            m = torch.from_numpy(bicubic_matrix_align_corners(t, target_t)).to(x.device)
            x = torch.einsum("ot,btf->bof", m, x)
        if f < target_f:
            m = torch.from_numpy(bicubic_matrix_align_corners(f, target_f)).to(x.device)
            x = torch.einsum("of,btf->bto", m, x)
        x = x.transpose(1, 2)  # (B, F, T)
        x = x.reshape(b, target_f, cfg.freq_ratio, target_t // cfg.freq_ratio)
        x = x.permute(0, 2, 1, 3)  # (B, ratio, F, T / ratio)
        return x.reshape(b, 1, cfg.freq_ratio * target_f, target_t // cfg.freq_ratio)

    def forward(self, logmel: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        x = self.reshape_wav2img(self.bn0(logmel, dim=2))  # bn0 over the mel bins
        x = self.patch_proj(x)  # (B, C, gh, gw)
        x = self.patch_norm(x.flatten(2).transpose(1, 2))  # tokens row-major over (gh, gw)
        for li, depth in enumerate(cfg.depths):
            for bi in range(depth):
                x = getattr(self, f"layer_{li}_block_{bi}")(x)
            if li < len(cfg.depths) - 1:
                x = getattr(self, f"layer_{li}_downsample")(x)
        x = self.norm(x)
        b, _, c = x.shape
        res = self.final_resolution
        # token-semantic regrouping: (SF, ST) tokens -> (B, C, freq bins, time)
        x = x.transpose(1, 2).reshape(b, c, res[0], res[1])
        c_freq_bin = res[0] // cfg.freq_ratio
        x = x.reshape(b, c, res[0] // c_freq_bin, c_freq_bin, res[1])
        x = x.permute(0, 1, 3, 2, 4).reshape(b, c, c_freq_bin, -1)
        latent = x.reshape(b, c, -1).mean(-1)  # AdaptiveAvgPool1d(1)
        logits = self.tscam_conv(x).flatten(2).mean(-1)  # (B, classes)
        return {"embedding": latent, "clipwise_output": torch.sigmoid(logits), "latent_map": x}


def l2_normalize(e: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(e.float() ** 2, dim=-1, keepdim=True))
    return (e.float() / torch.clamp(norm, min=1e-12)).to(e.dtype)


class ClapAudioEncoder(nn.Module):
    """(B, T, mel) log-mel -> L2-normalized CLAP audio embedding."""

    def __init__(self, cfg: HTSATConfig = HTSAT_TINY):
        super().__init__()
        self.cfg = cfg
        self.htsat = HTSAT(cfg)
        width = cfg.embed_dim * 2 ** (len(cfg.depths) - 1)
        self.proj_0 = nn.Linear(width, cfg.joint_embed_dim)
        self.proj_2 = nn.Linear(cfg.joint_embed_dim, cfg.joint_embed_dim)

    def forward(self, logmel: torch.Tensor) -> torch.Tensor:
        e = self.htsat(logmel)["embedding"]
        return l2_normalize(self.proj_2(F.relu(self.proj_0(e))))


def clap_logmel(wav48k: torch.Tensor, cfg: HTSATConfig = HTSAT_TINY) -> torch.Tensor:
    """48 kHz waveform (B, L) -> (B, T, 64) log-mel (torchlibrosa: power,
    Slaney mel, 10 log10 with amin 1e-10 and ref 1), on wav48k's device."""
    window = torch.from_numpy(hann_window_periodic(cfg.stft_window_size)).to(wav48k.device)
    power = stft_magnitude(wav48k, cfg.stft_window_size, cfg.hop_size, window) ** 2
    mel_fb = torch.from_numpy(np.ascontiguousarray(mel_filter_bank(
        cfg.sample_rate, cfg.stft_window_size, cfg.mel_bins, cfg.fmin, cfg.fmax).T))
    return 10.0 * torch.log10(torch.clamp(power @ mel_fb.to(wav48k.device), min=1e-10))


# ---------------------------------------------------------------- converter

def convert_htsat(sd: Mapping, cfg: HTSATConfig = HTSAT_TINY, prefix: str = "") -> StateDict:
    """torch HTSAT_Swin_Transformer state dict -> HTSAT's. `prefix`, e.g.
    "audio_branch." for a whole CLAP checkpoint."""
    out = convert_batchnorm(sd, prefix + "bn0", "bn0")

    def take(src, dst, leaves=("weight", "bias")):
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = f32_tensor(sd[f"{prefix}{src}.{leaf}"])

    take("patch_embed.proj", "patch_proj")
    take("patch_embed.norm", "patch_norm")
    take("norm", "norm")
    take("tscam_conv", "tscam_conv")
    for li, depth in enumerate(cfg.depths):
        for bi in range(depth):
            src, dst = f"layers.{li}.blocks.{bi}", f"layer_{li}_block_{bi}"
            for s, d in (("norm1", "norm1"), ("norm2", "norm2"), ("attn.qkv", "attn.qkv"),
                         ("attn.proj", "attn.proj"), ("mlp.fc1", "mlp_fc1"),
                         ("mlp.fc2", "mlp_fc2")):
                take(f"{src}.{s}", f"{dst}.{d}")
            take(f"{src}.attn", f"{dst}.attn", ("relative_position_bias_table",))
        if li < len(cfg.depths) - 1:
            take(f"layers.{li}.downsample.norm", f"layer_{li}_downsample.norm")
            take(f"layers.{li}.downsample.reduction", f"layer_{li}_downsample.reduction",
                 ("weight",))
    return out


def convert_projection(sd: Mapping, src: str) -> StateDict:
    """CLAP's `{src}.0` / `{src}.2` projection (Linear, ReLU, Linear) ->
    `proj_0` / `proj_2`."""
    return {f"proj_{i}.{leaf}": f32_tensor(sd[f"{src}.{i}.{leaf}"])
            for i in (0, 2) for leaf in ("weight", "bias")}


def convert_clap_audio(sd: Mapping, cfg: HTSATConfig = HTSAT_TINY, prefix: str = "") -> StateDict:
    """CLAP's audio side, {prefix}audio_branch.* and {prefix}audio_projection.*
    -> ClapAudioEncoder's."""
    out = {f"htsat.{k}": v for k, v in convert_htsat(sd, cfg, prefix + "audio_branch.").items()}
    out.update(convert_projection(sd, prefix + "audio_projection"))
    return out
