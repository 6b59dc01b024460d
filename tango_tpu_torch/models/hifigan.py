"""HiFi-GAN generator, port of tango_tpu/models/hifigan.py.

mel (B, T_mel, n_mels) in, waveform (B, T_wav) out, as in JAX; inside the
layout is NCW for cuDNN's 1-D convs. The JAX package computes each transposed
conv as interleaved dense convs (a TPU rewrite); here it is
`nn.ConvTranspose1d`, the same function (utils/convert.py flips the kernel).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tango_tpu_torch.configs import HiFiGANConfig

LRELU_SLOPE = 0.1


class ResBlock(nn.Module):
    """3 x [lrelu -> dilated conv -> lrelu -> conv] with residuals."""

    def __init__(self, ch: int, kernel_size: int, dilations):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}", nn.Conv1d(
                ch, ch, kernel_size, dilation=d, padding=(kernel_size * d - d) // 2))
            self.add_module(f"convs2_{i}", nn.Conv1d(
                ch, ch, kernel_size, padding=(kernel_size - 1) // 2))

    def forward(self, x):
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            h = getattr(self, f"convs2_{i}")(F.leaky_relu(h, LRELU_SLOPE))
            x = x + h
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7, padding=3)
        nk = len(cfg.resblock_kernel_sizes)
        ch = c0
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            out = c0 // (2 ** (i + 1))
            self.add_module(f"ups_{i}", nn.ConvTranspose1d(ch, out, k, u, padding=(k - u) // 2))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i * nk + j}", ResBlock(out, rk, rd))
            ch = out
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, n_mels) -> waveform (B, T_wav) in [-1, 1]."""
        cfg = self.cfg
        nk = len(cfg.resblock_kernel_sizes)
        x = self.conv_pre(mel.to(self.conv_pre.weight.dtype).transpose(1, 2))
        for i in range(len(cfg.upsample_rates)):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(nk):
                out = getattr(self, f"resblocks_{i * nk + j}")(x)
                acc = out if acc is None else acc + out
            x = acc / nk
        # the reference's last activation uses the default slope 0.01
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0, :]


def waveform_to_int16(wav) -> np.ndarray:
    """Float waveform in [-1, 1] -> int16, the JAX package's scaling."""
    if isinstance(wav, torch.Tensor):
        wav = wav.detach().float().cpu().numpy()
    return (np.asarray(wav) * 32768.0).astype("int16")
