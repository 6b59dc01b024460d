"""Audio reading and resampling, port of tango_tpu/audio/wav.py.

The reference read path: read, take the first channel, resample to 16 kHz
(polyphase FIR, `scipy.signal.resample_poly`), normalise (zero mean, peak
0.5), pad or trim to the segment, renormalise to peak 0.5. `read_wav`
dispatches by the file's magic bytes (`sniff_format`), as JAX does: WAV
through `scipy.io.wavfile`, FLAC (audio/flac.py), MPEG Layer I/II/III
(audio/mp3.py), Ogg Vorbis (audio/vorbis.py), Ogg Opus (audio/opus.py, the
system libopus) and AIFF / AIFF-C (audio/aiff.py), so a manifest may mix the
six formats.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.io import wavfile

from tango_tpu_torch.audio.stft import normalize_wav, pad_wav


def _is_mpeg_sync(b0: int, b1: int) -> bool:
    # frame sync + non-reserved layer bits (Layer I/II/III), any MPEG
    # version, CRC or not
    return b0 == 0xFF and (b1 & 0xE0) == 0xE0 and (b1 & 0x06) != 0


def sniff_format(path: str) -> str:
    """'wav' | 'flac' | 'mp3' | 'ogg' (vorbis) | 'opus' | 'aiff' | a short
    description of an unsupported format, by the file's magic bytes: the
    rule of tango_tpu/audio/wav.py:sniff_format, copied."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:4] == b"fLaC":
        return "flac"
    if head[:3] == b"ID3":
        if len(head) < 10:
            return "truncated ID3 header (unsupported)"
        # ID3 tags prefix both mp3 and (rarely) FLAC: peek past the tag
        # (10-byte header + 28-bit syncsafe size + optional 10-byte footer)
        size = (
            ((head[6] & 0x7F) << 21) | ((head[7] & 0x7F) << 14)
            | ((head[8] & 0x7F) << 7) | (head[9] & 0x7F)
        )
        if head[5] & 0x10:  # ID3v2.4 footer present flag
            size += 10
        with open(path, "rb") as f:
            f.seek(10 + size)
            magic = f.read(4)
        if magic == b"fLaC":
            return "flac"
        if len(magic) >= 2 and _is_mpeg_sync(magic[0], magic[1]):
            return "mp3"
        return "non-MPEG audio with ID3 tag (unsupported — transcode to wav/flac/mp3/ogg-vorbis)"
    if len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0:
        if _is_mpeg_sync(head[0], head[1]):
            return "mp3"
        return "MPEG stream with reserved layer bits (unsupported — transcode to wav/flac/mp3/ogg-vorbis)"
    if head[:4] == b"OggS":
        # peek the first packet of the first page to identify the codec
        with open(path, "rb") as f:
            first = f.read(27 + 255 + 8)
        if len(first) < 28:
            return "truncated ogg page (unsupported)"
        nsegs = first[26]
        body = first[27 + nsegs : 27 + nsegs + 8]
        if body[:7] == b"\x01vorbis":
            return "ogg"
        if body[:8] == b"OpusHead":
            return "opus"
        return "ogg container with unknown codec (unsupported — transcode to wav/flac/mp3/ogg-vorbis/opus)"
    if head[:4] == b"FORM":
        if head[8:12] in (b"AIFF", b"AIFC"):
            return "aiff"
        return f"IFF FORM type {head[8:12]!r} (unsupported)"
    return f"unknown format (magic {head[:4]!r})"


def _check_rate(sr: int) -> int:
    # a corrupt rate field would make the 16 kHz resample allocate len*16000 samples
    if not 1000 <= sr <= 768000:
        raise ValueError(f"implausible sample rate {sr} Hz (corrupt header?)")
    return sr


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """A WAV, FLAC, mp3, Ogg Vorbis / Opus or AIFF file -> (float32 samples
    in [-1, 1], sample rate), by magic bytes."""
    fmt = sniff_format(path)
    if fmt == "flac":
        from tango_tpu_torch.audio.flac import read_flac

        pcm, sr = read_flac(path)
        return pcm, _check_rate(sr)
    if fmt == "mp3":
        from tango_tpu_torch.audio.mp3 import read_mp3

        pcm, sr = read_mp3(path)
        return pcm, _check_rate(sr)
    if fmt == "ogg":
        from tango_tpu_torch.audio.vorbis import read_vorbis

        pcm, sr = read_vorbis(path)
        return pcm, _check_rate(sr)
    if fmt == "opus":
        from tango_tpu_torch.audio.opus import read_opus

        pcm, sr = read_opus(path)
        return pcm, _check_rate(sr)
    if fmt == "aiff":
        from tango_tpu_torch.audio.aiff import read_aiff

        pcm, sr = read_aiff(path)
        return pcm, _check_rate(sr)
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
    from scipy import signal  # here: scipy.signal takes seconds to import

    g = math.gcd(int(orig_sr), int(new_sr))
    return signal.resample_poly(waveform, new_sr // g, orig_sr // g).astype(np.float32)


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
