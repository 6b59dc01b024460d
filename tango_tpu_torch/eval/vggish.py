"""VGGish, the Frechet Audio Distance's embedding model: port of
tango_tpu/eval/vggish.py.

Frontend (numpy, the published VGGish mel_features): 16 kHz mono, 400-sample
frames (25 ms) at a 160-sample hop, periodic Hann, |rfft| at 512 (magnitude,
not power), an HTK-scale mel bank of 64 bands in [125, 7500] Hz without
normalisation, log(mel + 0.01), then examples of 96 frames at a hop of 96:
(N, 96, 64).

Network (torchvggish): conv64, pool, conv128, pool, conv256 x2, pool,
conv512 x2, pool, flattened in (H, W, C) order (torchvggish transposes to
channels-last before its view), fc 4096, fc 4096, fc 128, ReLU after each;
the last ReLU only with `use_activation=True`: the reference FAD takes the
raw last-layer output. NCHW inside. `convert_vggish` maps the torchvggish
names onto this module's (the JAX module's).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tango_tpu_torch.audio.wav import resample_poly
from tango_tpu_torch.utils.convert import StateDict, f32_tensor


# ------------------------------------------------------------------ frontend

def _htk_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def vggish_mel_matrix(num_spectrogram_bins: int = 257, sr: int = 16000,
                      n_mels: int = 64, fmin: float = 125.0, fmax: float = 7500.0) -> np.ndarray:
    """(num_spectrogram_bins, n_mels), HTK scale, unnormalized triangles."""
    nyquist = sr / 2.0
    spectrogram_bins_mel = _htk_mel(np.linspace(0.0, nyquist, num_spectrogram_bins))
    band_edges_mel = np.linspace(_htk_mel(fmin), _htk_mel(fmax), n_mels + 2)
    weights = np.zeros((num_spectrogram_bins, n_mels))
    for i in range(n_mels):
        lower, center, upper = band_edges_mel[i: i + 3]
        lower_slope = (spectrogram_bins_mel - lower) / (center - lower)
        upper_slope = (upper - spectrogram_bins_mel) / (upper - center)
        weights[:, i] = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0  # the DC bin is left out (mel_features.py)
    return weights.astype(np.float32)


def waveform_to_examples(wav: np.ndarray, sr: int = 16000) -> np.ndarray:
    """Mono float waveform -> (N, 96, 64) log-mel examples."""
    if sr != 16000:
        wav = resample_poly(wav, sr, 16000)
    win, hop, n_fft = 400, 160, 512
    if len(wav) < win:
        wav = np.pad(wav, (0, win - len(wav)))
    n_frames = 1 + (len(wav) - win) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(win)[None, :]
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)
    mag = np.abs(np.fft.rfft(wav[idx] * window, n_fft, axis=-1))
    log_mel = np.log(mag.dot(vggish_mel_matrix()) + 0.01)
    n_ex = log_mel.shape[0] // 96
    if n_ex == 0:
        return np.zeros((0, 96, 64), np.float32)
    return log_mel[: n_ex * 96].reshape(n_ex, 96, 64).astype(np.float32)


# -------------------------------------------------------------------- network

VGGISH_GROUPS = ((64,), (128,), (256, 256), (512, 512))
VGGISH_FC = (4096, 4096, 128)


class VGGish(nn.Module):
    """(N, 96, 64) examples -> (N, 128) embeddings."""

    def __init__(self, use_activation: bool = False):
        super().__init__()
        self.use_activation = use_activation
        ci = 1
        li = 0
        for group in VGGISH_GROUPS:
            for co in group:
                setattr(self, f"conv{li}", nn.Conv2d(ci, co, 3, padding=1))
                ci, li = co, li + 1
        fi = 512 * 6 * 4
        for i, fo in enumerate(VGGISH_FC):
            setattr(self, f"fc{i}", nn.Linear(fi, fo))
            fi = fo

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None]
        li = 0
        for group in VGGISH_GROUPS:
            for _ in group:
                x = F.relu(getattr(self, f"conv{li}")(x))
                li += 1
            x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # (H, W, C) order
        x = F.relu(self.fc0(x))
        x = F.relu(self.fc1(x))
        x = self.fc2(x)
        return F.relu(x) if self.use_activation else x


def convert_vggish(sd: Mapping) -> StateDict:
    """torchvggish state dict (features.{0,3,6,8,11,13} convs,
    embeddings.{0,2,4} linears) -> VGGish's."""
    out = {}
    for i, tid in enumerate((0, 3, 6, 8, 11, 13)):
        for leaf in ("weight", "bias"):
            out[f"conv{i}.{leaf}"] = f32_tensor(sd[f"features.{tid}.{leaf}"])
    for i, tid in enumerate((0, 2, 4)):
        for leaf in ("weight", "bias"):
            out[f"fc{i}.{leaf}"] = f32_tensor(sd[f"embeddings.{tid}.{leaf}"])
    return out
