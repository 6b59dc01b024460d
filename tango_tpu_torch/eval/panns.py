"""PANNs Cnn14, the evaluation's feature extractor: port of
tango_tpu/eval/panns.py.

The 16 kHz Cnn14 of audioldm_eval (window 512, hop 160, 64 mels in [50,
8000] Hz, 527 classes) gives the FD / KL / IS / KID features. The frontend
is torchlibrosa's: the power spectrogram, a Slaney mel bank, 10 log10 of the
mel clipped at 1e-10. Inference only: the BatchNorms apply their running
statistics. NCHW inside; `(B, T, n_mels)` log-mel in. `convert_cnn14` maps
the released checkpoint's names onto this module's (the JAX module's names),
equal to `utils.convert.from_jax_params` of JAX's converter.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tango_tpu_torch.audio.stft import hann_window_periodic, mel_filter_bank, stft_magnitude
from tango_tpu_torch.utils.convert import StateDict, f32_tensor


def logmel_frontend(wav: torch.Tensor, sr: int = 16000, n_fft: int = 512, hop: int = 160,
                    n_mels: int = 64, fmin: float = 50.0, fmax: float = 8000.0) -> torch.Tensor:
    """(B, L) -> (B, T, n_mels) log-mel (power, 10 log10, amin 1e-10), on wav's device."""
    window = torch.from_numpy(hann_window_periodic(n_fft)).to(wav.device)
    power = stft_magnitude(wav, n_fft, hop, window) ** 2
    mel_fb = torch.from_numpy(np.ascontiguousarray(
        mel_filter_bank(sr, n_fft, n_mels, fmin, fmax).T)).to(wav.device)
    return 10.0 * torch.log10(torch.clamp(power @ mel_fb, min=1e-10))


class BatchNormEval(nn.Module):
    """Inference-mode BatchNorm over axis `dim` of the input:
    y = (x - mean) / sqrt(var + eps) * weight + bias."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[dim] = -1
        inv = torch.rsqrt(self.var + self.eps) * self.weight
        return x * inv.view(shape) + (self.bias - self.mean * inv).view(shape)


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNormEval(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn2 = BatchNormEval(out_channels)

    def forward(self, x: torch.Tensor, pool: int = 2) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.avg_pool2d(x, pool) if pool > 1 else x


CNN14_CHANNELS = (64, 128, 256, 512, 1024, 2048)


class Cnn14(nn.Module):
    """(B, T, 64) log-mel -> {"2048": (B, 2048), "logits": (B, classes),
    "clipwise_output": sigmoid of the logits}."""

    def __init__(self, classes_num: int = 527):
        super().__init__()
        self.bn0 = BatchNormEval(64)
        ins = (1,) + CNN14_CHANNELS[:-1]
        for i, (ci, co) in enumerate(zip(ins, CNN14_CHANNELS)):
            setattr(self, f"conv_block{i + 1}", ConvBlock(ci, co))
        self.fc1 = nn.Linear(2048, 2048)
        self.fc_audioset = nn.Linear(2048, classes_num)

    def forward(self, logmel: torch.Tensor) -> Dict[str, torch.Tensor]:
        # bn0 normalizes over the mel axis, the last one of (B, 1, T, M)
        x = self.bn0(logmel[:, None], dim=3)
        for i in range(len(CNN14_CHANNELS)):
            x = getattr(self, f"conv_block{i + 1}")(x, pool=2 if i < 5 else 1)
        x = x.mean(dim=3)                                 # over mel -> (B, C, T')
        x = x.amax(dim=2) + x.mean(dim=2)                 # (B, C)
        embedding = F.relu(self.fc1(x))
        logits = self.fc_audioset(embedding)
        return {"2048": embedding, "logits": logits, "clipwise_output": torch.sigmoid(logits)}


def convert_batchnorm(sd: Mapping, src: str, dst: str) -> StateDict:
    """A torch BatchNorm's weight, bias and running statistics -> BatchNormEval's."""
    return {f"{dst}.weight": f32_tensor(sd[src + ".weight"]), f"{dst}.bias": f32_tensor(sd[src + ".bias"]),
            f"{dst}.mean": f32_tensor(sd[src + ".running_mean"]),
            f"{dst}.var": f32_tensor(sd[src + ".running_var"])}


def convert_cnn14(sd: Mapping) -> StateDict:
    """The released Cnn14 state dict (a checkpoint's "model") -> Cnn14's.
    Both are torch layouts: the names stay, the frontend's and
    `num_batches_tracked` keys are dropped."""
    out = convert_batchnorm(sd, "bn0", "bn0")
    for i in range(1, len(CNN14_CHANNELS) + 1):
        blk = f"conv_block{i}"
        for n in ("1", "2"):
            out[f"{blk}.conv{n}.weight"] = f32_tensor(sd[f"{blk}.conv{n}.weight"])
            out.update(convert_batchnorm(sd, f"{blk}.bn{n}", f"{blk}.bn{n}"))
    for name in ("fc1", "fc_audioset"):
        out[f"{name}.weight"] = f32_tensor(sd[f"{name}.weight"])
        out[f"{name}.bias"] = f32_tensor(sd[f"{name}.bias"])
    return out
