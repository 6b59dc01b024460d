"""AIFF / AIFF-C decoder — pure python + numpy, no external deps. A copy of
tango_tpu/audio/aiff.py for the port.

The reference ingests anything torchaudio's sox backend decodes
(tools/torch_tools.py:43-54), which includes AIFF; this module closes that
format natively. Scope is the uncompressed and trivially-compressed AIFF-C
profiles sox itself decodes:

  - 'NONE' / 'twos'  : big-endian signed PCM, 1-32 bits (left-justified in
                       ceil(bits/8)-byte containers per the AIFF-1.3 spec)
  - 'sowt'           : little-endian 16-bit PCM (the Mac OS X variant)
  - 'fl32'/'FL32'    : big-endian IEEE float32
  - 'fl64'/'FL64'    : big-endian IEEE float64
  - 'ulaw'/'ULAW'    : G.711 mu-law (8-bit log PCM)
  - 'alaw'/'ALAW'    : G.711 A-law

Genuinely-compressed AIFF-C codecs (ima4, GSM, MACE, qdm*, ...) are refused
loudly. The sample rate is the COMM chunk's 80-bit IEEE-754 extended float,
parsed exactly. Pinned against the stdlib `aifc` module (the CPython
reference reader, removed in 3.13 — tests keep fixtures it wrote) plus
hand-crafted AIFC streams for the profiles `aifc` cannot write.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class AiffError(ValueError):
    pass


def _read_extended(b: bytes) -> float:
    """80-bit IEEE-754 extended float (sign + 15-bit exponent + 64-bit
    explicit-leading-bit mantissa) — the COMM sampleRate field."""
    if len(b) != 10:
        raise AiffError(f"extended float needs 10 bytes, got {len(b)}")
    sign = b[0] >> 7
    exp = ((b[0] & 0x7F) << 8) | b[1]
    mant = int.from_bytes(b[2:10], "big")
    if exp == 0 and mant == 0:
        return -0.0 if sign else 0.0
    if exp == 0x7FFF:
        raise AiffError("non-finite sample rate (extended float inf/nan)")
    try:
        val = mant * 2.0 ** (exp - 16383 - 63)
    except OverflowError:
        # the 15-bit exponent range far exceeds f64; a corrupt field must
        # refuse, not leak OverflowError past the AiffError contract
        raise AiffError(f"extended-float exponent {exp} overflows") from None
    return -val if sign else val


# G.711 decode to 16-bit linear — same values as audioop.ulaw2lin/alaw2lin
# (ITU-T G.711 tables A.1/A.2, decoder output = midpoint of the quantization
# interval).
def _ulaw_table() -> np.ndarray:
    out = np.empty(256, dtype=np.int16)
    for u in range(256):
        v = ~u & 0xFF
        t = (((v & 0x0F) << 3) + 0x84) << ((v >> 4) & 0x07)
        t -= 0x84
        out[u] = -t if v & 0x80 else t
    return out


def _alaw_table() -> np.ndarray:
    out = np.empty(256, dtype=np.int16)
    for a in range(256):
        v = a ^ 0x55
        mant, exp = v & 0x0F, (v >> 4) & 0x07
        if exp == 0:
            t = (mant << 4) + 8
        else:
            t = ((mant << 4) + 0x108) << (exp - 1)
        # A-law sign bit SET means positive (opposite of complemented mu-law)
        out[a] = t if v & 0x80 else -t
    return out


_ULAW = _ulaw_table()
_ALAW = _alaw_table()

_PCM_TYPES = (b"NONE", b"twos", b"sowt")
_FLOAT_TYPES = (b"fl32", b"FL32", b"fl64", b"FL64")
_G711_TYPES = (b"ulaw", b"ULAW", b"alaw", b"ALAW")


def decode_aiff(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an AIFF/AIFF-C byte string -> (float32 (frames, channels) in
    [-1, 1], sample_rate)."""
    if len(data) < 12 or data[:4] != b"FORM":
        raise AiffError("not an AIFF file (missing FORM header)")
    form_type = data[8:12]
    if form_type not in (b"AIFF", b"AIFC"):
        raise AiffError(f"FORM type {form_type!r} is not AIFF/AIFC")
    form_size = int.from_bytes(data[4:8], "big")
    end = min(len(data), 8 + form_size)

    comm = None
    ssnd = None
    pos = 12
    while pos + 8 <= end:
        cid = data[pos : pos + 4]
        csize = int.from_bytes(data[pos + 4 : pos + 8], "big")
        body_start = pos + 8
        if body_start + csize > len(data):
            raise AiffError(
                f"chunk {cid!r} claims {csize} bytes but only "
                f"{len(data) - body_start} remain (truncated file)"
            )
        if cid == b"COMM":
            comm = data[body_start : body_start + csize]
        elif cid == b"SSND":
            ssnd = data[body_start : body_start + csize]
        pos = body_start + csize + (csize & 1)  # chunks pad to even

    if comm is None:
        raise AiffError("missing COMM chunk")
    if len(comm) < 18:
        raise AiffError(f"COMM chunk too short ({len(comm)} < 18 bytes)")
    channels = int.from_bytes(comm[0:2], "big", signed=True)
    num_frames = int.from_bytes(comm[2:6], "big")
    bits = int.from_bytes(comm[6:8], "big", signed=True)
    sr_f = _read_extended(comm[8:18])
    comp = b"NONE"
    if form_type == b"AIFC":
        if len(comm) < 22:
            raise AiffError("AIFC COMM chunk missing compression type")
        comp = comm[18:22]
    if channels <= 0:
        raise AiffError(f"invalid channel count {channels}")
    if not (1 <= bits <= 64):
        raise AiffError(f"invalid sample size {bits} bits")
    if sr_f <= 0 or not np.isfinite(sr_f):
        raise AiffError(f"invalid sample rate {sr_f}")
    sr = int(round(sr_f))
    if sr <= 0:  # rates in (0, 0.5) round to 0 -> div-by-zero downstream
        raise AiffError(f"sample rate {sr_f} rounds to zero")

    known = _PCM_TYPES + _FLOAT_TYPES + _G711_TYPES
    if comp not in known:
        raise AiffError(
            f"AIFF-C compression {comp!r} is not supported "
            "(decodable: NONE/twos/sowt PCM, fl32/fl64, ulaw/alaw)"
        )

    if num_frames == 0:
        return np.zeros((0, channels), dtype=np.float32), sr
    if ssnd is None:
        raise AiffError("missing SSND chunk with numSampleFrames > 0")
    if len(ssnd) < 8:
        raise AiffError("SSND chunk too short for offset/blockSize fields")
    offset = int.from_bytes(ssnd[0:4], "big")
    frames_bytes = ssnd[8 + offset :]

    if comp in (b"fl32", b"FL32", b"fl64", b"FL64"):
        width = 4 if comp in (b"fl32", b"FL32") else 8
        dt = ">f4" if width == 4 else ">f8"
        need = num_frames * channels * width
        if len(frames_bytes) < need:
            raise AiffError(
                f"SSND holds {len(frames_bytes)} bytes, COMM declares "
                f"{need} ({num_frames} frames x {channels} ch x {width} B)"
            )
        flat = np.frombuffer(frames_bytes[:need], dtype=dt).astype(np.float32)
    elif comp in (b"ulaw", b"ULAW", b"alaw", b"ALAW"):
        need = num_frames * channels
        if len(frames_bytes) < need:
            raise AiffError(
                f"SSND holds {len(frames_bytes)} bytes, COMM declares {need}"
            )
        codes = np.frombuffer(frames_bytes[:need], dtype=np.uint8)
        table = _ULAW if comp in (b"ulaw", b"ULAW") else _ALAW
        flat = table[codes].astype(np.float32) / 32768.0
    else:  # integer PCM: NONE/twos (big-endian), sowt (little-endian)
        width = (bits + 7) // 8
        need = num_frames * channels * width
        if len(frames_bytes) < need:
            raise AiffError(
                f"SSND holds {len(frames_bytes)} bytes, COMM declares "
                f"{need} ({num_frames} frames x {channels} ch x {width} B)"
            )
        raw = np.frombuffer(frames_bytes[:need], dtype=np.uint8).reshape(-1, width)
        order = raw[:, ::-1] if comp == b"sowt" else raw
        # assemble signed big-endian ints of `width` bytes; samples are
        # left-justified in the container (AIFF-1.3 "Sound Data"), so
        # normalizing by the container width is exact
        acc = order[:, 0].astype(np.int64)
        acc = np.where(acc >= 128, acc - 256, acc)
        for i in range(1, width):
            acc = (acc << 8) | order[:, i].astype(np.int64)
        flat = acc.astype(np.float32) / float(1 << (8 * width - 1))

    return flat.reshape(num_frames, channels), sr


def read_aiff(path: str) -> Tuple[np.ndarray, int]:
    """Read an AIFF/AIFF-C file -> (float32 (n,) or (n, ch) in [-1, 1], sr) —
    read_wav's output contract (see audio/wav.read_wav)."""
    with open(path, "rb") as f:
        data = f.read()
    pcm, sr = decode_aiff(data)
    if pcm.shape[1] == 1:
        pcm = pcm[:, 0]
    return pcm, sr
