"""A-weighted gain-matched audio mixup (training augmentation).

The port's own copy of tango_tpu/audio/mix.py (numpy only), the reference's
mixing math (tools/mix.py and tools/torch_tools.py of declare-lab/tango): two
sounds are mixed with a ratio derived from their maximum A-weighted frame
gains, and their captions are joined with "and".
"""

from __future__ import annotations

import itertools
import random
from typing import List, Sequence, Tuple

import numpy as np


def a_weight(fs: int, n_fft: int, min_db: float = -80.0) -> np.ndarray:
    freq = np.linspace(0, fs // 2, n_fft // 2 + 1)
    freq_sq = np.power(freq, 2)
    freq_sq[0] = 1.0
    weight = 2.0 + 20.0 * (
        2 * np.log10(12194)
        + 2 * np.log10(freq_sq)
        - np.log10(freq_sq + 12194**2)
        - np.log10(freq_sq + 20.6**2)
        - 0.5 * np.log10(freq_sq + 107.7**2)
        - 0.5 * np.log10(freq_sq + 737.9**2)
    )
    return np.maximum(weight, min_db)


def compute_gain(sound: np.ndarray, fs: int, min_db: float = -80.0, mode: str = "A_weighting") -> np.ndarray:
    if fs == 16000:
        n_fft = 2048
    elif fs == 44100:
        n_fft = 4096
    else:
        raise ValueError(f"Invalid fs {fs}")
    stride = n_fft // 2
    aw = np.power(10, a_weight(fs, n_fft) / 10) if mode == "A_weighting" else None
    win = np.hanning(n_fft + 1)[:-1]

    gains = []
    for i in range(0, len(sound) - n_fft + 1, stride):
        if mode == "RMSE":
            g = np.mean(sound[i : i + n_fft] ** 2)
        elif mode == "A_weighting":
            spec = np.fft.rfft(win * sound[i : i + n_fft])
            g = np.sum(np.abs(spec) ** 2 * aw)
        else:
            raise ValueError(f"Invalid mode {mode}")
        gains.append(g)
    gains = np.maximum(np.asarray(gains), np.power(10, min_db / 10))
    return 10 * np.log10(gains)


def mix(sound1: np.ndarray, sound2: np.ndarray, r: float, fs: int) -> np.ndarray:
    """Gain-aware crossfade (mix.py:46-51)."""
    gain1 = np.max(compute_gain(sound1, fs))
    gain2 = np.max(compute_gain(sound2, fs))
    t = 1.0 / (1 + np.power(10.0, (gain1 - gain2) / 20.0) * (1 - r) / r)
    return (sound1 * t + sound2 * (1 - t)) / np.sqrt(t**2 + (1 - t) ** 2)


def uncapitalize(s: str) -> str:
    return s[:1].lower() + s[1:] if s else ""


def mix_pairs(
    waveforms: np.ndarray,
    captions: Sequence[str],
    num_items: int = 4,
    fs: int = 16000,
    rng: random.Random | None = None,
) -> Tuple[np.ndarray, List[str]]:
    """Augment a batch by mixing random caption pairs (torch_tools.py:100-128).

    waveforms: (B, L) already-read normalized batch. Returns mixed (K, L)
    renormalized to peak 0.5 and combined captions.
    """
    rng = rng or random
    combos = list(itertools.combinations(range(len(captions)), 2))
    rng.shuffle(combos)
    combos = combos[:num_items]
    if not combos:
        return np.zeros((0,) + waveforms.shape[1:], np.float32), []
    mixed, texts = [], []
    for i, j in combos:
        m = mix(waveforms[i], waveforms[j], 0.5, fs)
        mixed.append(m[None])
        texts.append(f"{captions[i]} and {uncapitalize(captions[j])}")
    out = np.concatenate(mixed, 0)
    out = out / np.max(np.abs(out) + 1e-12)
    return (0.5 * out).astype(np.float32), texts
