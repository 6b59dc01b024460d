"""Mel-spectrogram frontend in torch, port of tango_tpu/audio/stft.py.

The reference TacotronSTFT: reflect padding of n_fft//2 on both sides, a
periodic Hann window, the magnitude of the real FFT, a Slaney-normalised
Slaney-scale mel filterbank, and log compression clamped at 1e-5. Frames
are a strided view of the padded signal and go through `torch.fft.rfft`.
It runs on the host (the CPU) inside the data loader's thread, as the JAX
package runs it there. `istft` and `griffin_lim` invert it (the reference's
audio_processing.py), in torch ops on whatever device their inputs are on.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tango_tpu_torch.configs import StftConfig


# ------------------------------------------------------------ mel filter bank

def _hz_to_mel_slaney(freq) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
                    freq / f_sp)


def _mel_to_hz_slaney(mels) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    mels * f_sp)


def mel_filter_bank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) with its defaults
    (Slaney scale and norm): (n_mels, 1 + n_fft//2) float32."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                                          n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def hann_window_periodic(win_length: int) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


# ---------------------------------------------------------------- core STFT

def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Reflect-pad by n_fft//2 and frame: (B, T) -> (B, n_frames, n_fft), a view."""
    pad = n_fft // 2
    y = F.pad(y.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return y.unfold(-1, n_fft, hop)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor) -> torch.Tensor:
    """|STFT| with the reference conventions: (B, T) -> (B, n_frames, 1 + n_fft//2)."""
    return torch.fft.rfft(frame_signal(y, n_fft, hop) * window, dim=-1).abs()


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=clip_val))


class MelSpectrogram:
    """TacotronSTFT: mel_spectrogram(y) for y in [-1, 1] of shape (B, T)
    returns (mel (B, n_frames, n_mels), log magnitudes (B, n_frames,
    1 + n_fft//2)), time-major as in the JAX package."""

    def __init__(self, cfg: StftConfig | None = None):
        self.cfg = cfg or StftConfig()
        self.window = torch.from_numpy(hann_window_periodic(self.cfg.win_length))
        self.mel_basis = torch.from_numpy(np.ascontiguousarray(mel_filter_bank(
            self.cfg.sampling_rate, self.cfg.filter_length, self.cfg.n_mel_channels,
            self.cfg.mel_fmin, self.cfg.mel_fmax).T))      # (n_freq, n_mels)

    def mel_spectrogram(self, y) -> Tuple[torch.Tensor, torch.Tensor]:
        y = torch.as_tensor(y, dtype=torch.float32)
        mag = stft_magnitude(y, self.cfg.filter_length, self.cfg.hop_length,
                             self.window.to(y.device))
        mel = torch.matmul(mag, self.mel_basis.to(y.device))
        return dynamic_range_compression(mel), dynamic_range_compression(mag)


# ------------------------------------------------------------- featurization

def normalize_wav(waveform: np.ndarray) -> np.ndarray:
    """Zero mean, peak 0.5."""
    waveform = waveform - np.mean(waveform)
    waveform = waveform / (np.max(np.abs(waveform)) + 1e-8)
    return (waveform * 0.5).astype(np.float32)


def pad_wav(waveform: np.ndarray, segment_length: int | None) -> np.ndarray:
    """Trim or zero-pad to segment_length."""
    if segment_length is None or len(waveform) == segment_length:
        return waveform
    if len(waveform) > segment_length:
        return waveform[:segment_length]
    return np.pad(waveform, (0, segment_length - len(waveform)))


def pad_spec(fbank: torch.Tensor, target_length: int) -> torch.Tensor:
    """(B, n_frames, channels) -> (B, target_length, even channels): pad or
    trim time, drop the last channel when their count is odd."""
    n = fbank.shape[1]
    if target_length > n:
        fbank = F.pad(fbank, (0, 0, 0, target_length - n))
    else:
        fbank = fbank[:, :target_length]
    if fbank.shape[2] % 2 != 0:
        fbank = fbank[:, :, :-1]
    return fbank


def wav_batch_to_fbank(mel: MelSpectrogram, waveforms, target_length: int = 1024):
    """Waveforms (B, T) in [-1, 1] -> (fbank (B, L, n_mels), log magnitudes)."""
    y = torch.nan_to_num(torch.clamp(torch.as_tensor(waveforms, dtype=torch.float32), -1.0, 1.0))
    fbank, log_mag = mel.mel_spectrogram(y)
    return pad_spec(fbank, target_length), pad_spec(log_mag, target_length)


# ------------------------------------------------------------- inverse / GL

def stft_complex(y: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor):
    """(B, T) -> (magnitude, phase), each (B, n_frames, 1 + n_fft//2), as the
    reference STFT.transform (stft.py:52-84) computes them."""
    spec = torch.fft.rfft(frame_signal(y, n_fft, hop) * window, dim=-1)
    return spec.abs(), spec.angle()


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int,
          window: torch.Tensor) -> torch.Tensor:
    """Inverse STFT with window-sumsquare normalisation, as the reference's
    conv-transpose inverse (stft.py:86-128): the overlap-add of window *
    irfft(spec), divided by the squared window's envelope where that exceeds
    f32's smallest normal, with the n_fft//2 reflect-pad margins trimmed.
    magnitude and phase are time-major, (B, n_frames, 1 + n_fft//2)."""
    b, n_frames, _ = magnitude.shape
    spec = torch.polar(magnitude.float(), phase.float())
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window       # (B, n_frames, n_fft)
    out_len = n_fft + hop * (n_frames - 1)
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    sig = frames.new_zeros((b, out_len)).index_add_(1, idx, frames.reshape(b, -1))
    wss = window.new_zeros(out_len).index_add_(0, idx, (window**2).repeat(n_frames))
    tiny = torch.finfo(torch.float32).tiny
    sig = torch.where(wss > tiny, sig / torch.where(wss > tiny, wss, 1.0), sig)
    pad = n_fft // 2
    return sig[:, pad:-pad]


def griffin_lim(magnitude: torch.Tensor, n_fft: int = 1024, hop: int = 160, n_iters: int = 30,
                generator: torch.Generator | None = None,
                init_phase: torch.Tensor | None = None) -> torch.Tensor:
    """Phase reconstruction (the reference's audio_processing.py:66-82) from
    linear magnitudes (B, n_frames, 1 + n_fft//2): a uniform initial phase in
    [-pi, pi) (from `generator`, or `init_phase` when given), then n_iters
    rounds of istft and re-analysis, as JAX's."""
    magnitude = torch.as_tensor(magnitude, dtype=torch.float32)
    window = torch.from_numpy(hann_window_periodic(n_fft)).to(magnitude.device)
    if init_phase is None:
        init_phase = torch.rand(magnitude.shape, generator=generator,
                                device=magnitude.device) * (2 * np.pi) - np.pi
    signal = istft(magnitude, torch.as_tensor(init_phase, dtype=torch.float32), n_fft, hop,
                   window)
    for _ in range(n_iters):
        _, phase = stft_complex(signal, n_fft, hop, window)
        n = min(phase.shape[1], magnitude.shape[1])
        signal = istft(magnitude[:, :n], phase[:, :n], n_fft, hop, window)
    return signal
