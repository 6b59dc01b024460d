"""WAV reading and resampling, port of the WAV path of tango_tpu/audio/wav.py.

The reference read path: read, take the first channel, resample to 16 kHz
(polyphase FIR, `scipy.signal.resample_poly`), normalise (zero mean, peak
0.5), pad or trim to the segment, renormalise to peak 0.5. Reading is
`scipy.io.wavfile`. The JAX package's other decoders (FLAC, MPEG audio, Ogg
Vorbis and Opus, AIFF) are not ported yet (ROADMAP queue A #10): a file of
one of those formats raises NotImplementedError, by its magic bytes, so a
manifest of them fails loudly instead of training on the loader's constant
stand-in for an unreadable file.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly as _scipy_resample_poly

from tango_tpu_torch.audio.stft import normalize_wav, pad_wav

# formats the JAX package decodes and the port does not yet
UNPORTED_FORMATS = ("flac", "mp3", "ogg", "opus", "aiff")


def sniff_format(path: str) -> str:
    """'wav', one of UNPORTED_FORMATS, or 'unknown' by the file's magic bytes."""
    with open(path, "rb") as f:
        head = f.read(64)
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:4] == b"fLaC":
        return "flac"
    if head[:3] == b"ID3" or (len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0):
        return "mp3"
    if head[:4] == b"OggS":
        return "opus" if b"OpusHead" in head else "ogg"
    if head[:4] == b"FORM" and head[8:12] in (b"AIFF", b"AIFC"):
        return "aiff"
    return "unknown"


def check_decodable(path: str) -> str:
    """The file's format; NotImplementedError for one whose decoder is not ported."""
    fmt = sniff_format(path)
    if fmt in UNPORTED_FORMATS:
        raise NotImplementedError(
            f"{path}: {fmt} decoding is not ported to tango_tpu_torch yet (ROADMAP queue A "
            "#10, ingestion); transcode to WAV")
    return fmt


def _check_rate(sr: int) -> int:
    # a corrupt rate field would make the 16 kHz resample allocate len*16000 samples
    if not 1000 <= sr <= 768000:
        raise ValueError(f"implausible sample rate {sr} Hz (corrupt header?)")
    return sr


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """A WAV file -> (float32 samples in [-1, 1], sample rate)."""
    check_decodable(path)
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, _check_rate(int(sr))


def write_wav(path: str, waveform: np.ndarray, sr: int = 16000) -> None:
    """Write an int16 WAV from float samples in [-1, 1] or int16."""
    if waveform.dtype != np.int16:
        waveform = (np.clip(waveform, -1.0, 1.0) * 32768.0).astype(np.int16)
    wavfile.write(path, sr, waveform)


def resample_poly(waveform: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    if orig_sr == new_sr:
        return waveform.astype(np.float32)
    g = math.gcd(int(orig_sr), int(new_sr))
    return _scipy_resample_poly(waveform, new_sr // g, orig_sr // g).astype(np.float32)


def read_wav_file(path: str, segment_length: int | None, target_sr: int = 16000) -> np.ndarray:
    """The reference read path -> (1, L) float32."""
    data, sr = read_wav(path)
    if data.ndim > 1:
        data = data[:, 0]
    data = resample_poly(data, sr, target_sr)
    try:
        data = normalize_wav(data)
    except Exception:
        data = np.ones(160000, dtype=np.float32)
    data = pad_wav(data, segment_length)
    data = data / np.max(np.abs(data) + 1e-12)
    return (0.5 * data)[None, :].astype(np.float32)
