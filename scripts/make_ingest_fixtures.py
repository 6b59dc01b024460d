#!/usr/bin/env python3
"""Write the ingestion fixtures of `tests/data/ingest/` and their references.

    python scripts/make_ingest_fixtures.py

One short clip of each compressed or container format the port reads
besides WAV, made by the JAX package's own test makers, and JAX's decode of
each one (`tango_tpu.audio.wav.read_wav`) in `reference.npz`:

  name   format                        rate   ch  length   maker
  flac   FLAC, 16-bit, fixed order 2,  44100  2   1.0 s    tests/_flac_encoder.py encode_flac
         mid/side, 4096-sample blocks,
         Rice parameter 8
  mp3    MPEG-1 Layer III, 128 kbit/s  44100  1   39       tests/_mp3_encoder.py encode_stream
         (random spectra, one table            frames     (GranuleSpec of seeded spectra)
         per region)                           (1.019 s)
  ogg    Ogg Vorbis, quality 0.4       22050  1   1.0 s    tests/_vorbis_oracle.py encode_vorbis
                                                           (the system libvorbisenc)
  opus   Ogg Opus, 96 kbit/s,          48000  1   1.0 s    tests/_opus_fixtures.py encode_opus
         20 ms frames                                      (the system libopus)
  aiff   AIFF, 16-bit big-endian PCM   16000  2   1.0 s    tests/test_aiff.py _build_aifc

The signals are seeded (a few partials under a slow tremolo, plus noise),
so a rerun writes the same bytes where the maker is deterministic (all but
the two system encoders, whose output may change with their version). The
lossy clips are mono and the AIFF one at 16 kHz to keep the directory under
1 MB: the decoders' cost is about linear in samples times channels, so a
rate measured here scales to other layouts.

`reference.npz` holds, for each name, `<name>_rate` and JAX's decoded PCM:
`<name>_int16`, the samples times 32768 (exact: FLAC and AIFF decode 16-bit
integers), or `<name>_f32` for the lossy formats. `chip_smoke.py`'s phase
`ingest` holds the port's `read_wav` to these on the card, where there is no
JAX; `tests/test_torch_ingest.py` holds them to JAX's decode of the
committed files here, so the two cannot drift apart.

Runs on the CPU, with the JAX package and the system libvorbisenc and
libopus; it is not part of the port (the port imports none of this).
"""

from __future__ import annotations

import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

OUT = REPO / "tests" / "data" / "ingest"
SEED = 23

# name -> (format, rate, channels, seconds)
FIXTURES = {
    "flac": ("FLAC", 44100, 2, 1.0),
    "mp3": ("MPEG-1 Layer III", 44100, 1, 39 * 1152 / 44100),
    "ogg": ("Ogg Vorbis", 22050, 1, 1.0),
    "opus": ("Ogg Opus", 48000, 1, 1.0),
    "aiff": ("AIFF", 16000, 2, 1.0),
}
EXTENSION = {"flac": "flac", "mp3": "mp3", "ogg": "ogg", "opus": "opus", "aiff": "aiff"}
LOSSLESS = ("flac", "aiff")


def signal(rate: int, channels: int, seconds: float, seed: int) -> np.ndarray:
    """(n, channels) float32 in [-1, 1]: three partials under a tremolo and
    a little noise, each channel with its own phase."""
    rng = np.random.default_rng(seed)
    n = int(round(rate * seconds))
    t = np.arange(n) / rate
    f0 = rng.uniform(110.0, 440.0)
    cols = []
    for c in range(channels):
        x = sum(rng.uniform(0.1, 0.25) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3))
                for h in (1, 2, 3))
        x = x * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t))
        cols.append(x + 0.003 * rng.standard_normal(n))
    return np.clip(np.stack(cols, 1), -1, 1).astype(np.float32)


def make_flac() -> bytes:
    from tests._flac_encoder import encode_flac

    _, rate, ch, seconds = FIXTURES["flac"]
    pcm = np.round(signal(rate, ch, seconds, SEED) * 32767).astype(np.int64)
    return encode_flac(pcm, sample_rate=rate, bps=16, block_size=4096, stereo_mode="mid_side",
                       kind="fixed", order=2, rice_param=8, partition_order=2)


def make_mp3() -> bytes:
    from tests._mp3_encoder import GranuleSpec, encode_stream

    rng = np.random.default_rng(SEED)
    frames = []
    for _ in range(39):
        granules = []
        for _gr in range(2):
            s = np.zeros(576, np.int64)
            n = int(rng.integers(100, 160))
            s[:n] = rng.integers(-5, 6, n)
            granules.append([GranuleSpec(spectrum=s, global_gain=int(rng.integers(140, 152)),
                                         table_select=(9, 9, 9), region0_count=8,
                                         region1_count=7)])
        frames.append(granules)
    return encode_stream(frames, sr=44100, version="1", mode=3, bitrate=128)


def make_ogg() -> bytes:
    from tests._vorbis_oracle import encode_vorbis

    _, rate, ch, seconds = FIXTURES["ogg"]
    return encode_vorbis(signal(rate, ch, seconds, SEED + 1), rate, quality=0.4)


def make_opus() -> bytes:
    from tests._opus_fixtures import encode_opus

    _, rate, ch, seconds = FIXTURES["opus"]
    return encode_opus(signal(rate, ch, seconds, SEED + 2)[:, 0], bitrate=96000)


def make_aiff() -> bytes:
    from tests.test_aiff import _build_aifc

    _, rate, ch, seconds = FIXTURES["aiff"]
    pcm = np.round(signal(rate, ch, seconds, SEED + 3) * 32767).astype(">i2")
    return _build_aifc(pcm.tobytes(), ch, len(pcm), 16, rate, form=b"AIFF")


MAKERS = {"flac": make_flac, "mp3": make_mp3, "ogg": make_ogg, "opus": make_opus,
          "aiff": make_aiff}


def path_of(name: str) -> pathlib.Path:
    return OUT / f"clip.{EXTENSION[name]}"


def references() -> dict:
    """JAX's decode of every committed fixture, in reference.npz's layout."""
    from tango_tpu.audio.wav import read_wav

    arrays = {}
    for name in FIXTURES:
        pcm, rate = read_wav(str(path_of(name)))
        arrays[f"{name}_rate"] = np.int64(rate)
        if name in LOSSLESS:
            scaled = pcm.astype(np.float64) * 32768.0
            assert np.array_equal(scaled, np.round(scaled)), name
            arrays[f"{name}_int16"] = scaled.astype(np.int16)
        else:
            arrays[f"{name}_f32"] = pcm.astype(np.float32)
    return arrays


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    for name, make in MAKERS.items():
        path_of(name).write_bytes(make())
    np.savez_compressed(OUT / "reference.npz", **references())
    total = 0
    for p in sorted(OUT.iterdir()):
        total += p.stat().st_size
        print(f"{p.relative_to(REPO)}: {p.stat().st_size} bytes")
    print(f"total {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
