"""FLAC decoder, a copy of tango_tpu/audio/flac.py for the port.

The reference reads flac/mp3/ogg through torchaudio
(tools/torch_tools.py:43-54); the port reads them with its own decoders, so
that a FLAC manifest trains on its audio and not on the loader's constant
stand-in for an unreadable file. This module decodes the native-FLAC subset
that covers real-world audio datasets:

  * metadata: STREAMINFO (+ all other blocks skipped)
  * frames: fixed+variable blocking, all block-size/sample-rate codes,
    8/12/16/20/24/32-bit samples, 1-8 channels, the four stereo decorrelation
    modes (independent, left/side, right/side, mid/side)
  * subframes: CONSTANT, VERBATIM, FIXED (orders 0-4), LPC (orders 1-32),
    wasted bits
  * residuals: RICE (4-bit) and RICE2 (5-bit) partitioned coding incl.
    escape partitions
  * integrity: frame-header CRC-8 always verified; whole-frame CRC-16
    optional (verify_crc=True)

Two decode paths, bit-exact against each other (tests/test_torch_decoders.py):
  * native: _flac_native.c compiled by the host C compiler at first use and
    loaded via ctypes (flac_native.py), int64 exact arithmetic (the FLAC
    spec bounds the LPC accumulator under 2^53 for valid streams)
  * pure python (this file): the reference implementation and the fallback
    when no C compiler is present: python ints in the LPC recurrence, so
    no overflow class at any bit depth, but ~50x slower
`SUBFRAMES` counts the subframes each path decoded. The training loader
overlaps either with device compute via its prefetch thread. Unsupported
containers (Ogg-FLAC, mp3, ...) raise loudly; see
train.data.validate_manifest for the preflight.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tango_tpu_torch.audio import flac_native

_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCKSIZE_CODES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}

_SAMPLE_RATE_CODES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}

_SAMPLE_SIZE_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class FlacError(ValueError):
    pass


# the native subframe decoder (C via ctypes, ~50-100x the python bit loop),
# built at its first use; None forces the python path
_native = flac_native

# subframes decoded by each path, since import
SUBFRAMES = {"native": 0, "python": 0}


class _Bits:
    """Big-endian bit reader over a bytes buffer (frame decode path)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos_bits: int = 0):
        self.buf = buf
        self.pos = pos_bits

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        start = p >> 3
        end = (p + n + 7) >> 3
        if end > len(self.buf):
            raise FlacError("truncated FLAC stream")
        chunk = int.from_bytes(self.buf[start:end], "big")
        return (chunk >> (end * 8 - (p + n))) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def unary(self) -> int:
        """Count 0-bits until (and consuming) the terminating 1-bit."""
        buf, p = self.buf, self.pos
        q = 0
        while True:
            byte_i = p >> 3
            if byte_i >= len(buf):
                raise FlacError("truncated FLAC stream in unary code")
            rem = 8 - (p & 7)
            b = buf[byte_i] & ((1 << rem) - 1)
            if b:
                lz = rem - b.bit_length()
                self.pos = p + lz + 1
                return q + lz
            q += rem
            p += rem

    def align(self):
        self.pos = (self.pos + 7) & ~7


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _read_utf8_number(bits: _Bits) -> int:
    """FLAC's extended UTF-8 coded frame/sample number (up to 36 bits)."""
    first = bits.read(8)
    if first < 0x80:
        return first
    n_extra = 0
    mask = 0x40
    while first & mask:
        n_extra += 1
        mask >>= 1
    if n_extra == 0 or n_extra > 6:
        raise FlacError(f"invalid UTF-8 coded number lead byte {first:#x}")
    val = first & (mask - 1)
    for _ in range(n_extra):
        b = bits.read(8)
        if b >> 6 != 0b10:
            raise FlacError("invalid UTF-8 continuation in frame number")
        val = (val << 6) | (b & 0x3F)
    return val


def _decode_residual(bits: _Bits, block_size: int, pred_order: int) -> list:
    method = bits.read(2)
    if method > 1:
        raise FlacError(f"reserved residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = bits.read(4)
    n_parts = 1 << part_order
    if block_size % n_parts:
        raise FlacError("partition count does not divide block size")
    part_len = block_size >> part_order
    out = []
    for pi in range(n_parts):
        n = part_len - (pred_order if pi == 0 else 0)
        if n < 0:
            raise FlacError("predictor order exceeds first partition")
        param = bits.read(param_bits)
        if param == escape:
            raw = bits.read(5)
            if raw == 0:
                out.extend([0] * n)
            else:
                out.extend(bits.read_signed(raw) for _ in range(n))
            continue
        unary = bits.unary
        read = bits.read
        for _ in range(n):
            q = unary()
            v = (q << param) | read(param) if param else q
            out.append((v >> 1) ^ -(v & 1))
    return out


def _predict(warmup: list, residual: list, coeffs: list, shift: int) -> list:
    """Exact integer linear prediction (python ints: no overflow class)."""
    data = list(warmup)
    order = len(coeffs)
    for e in residual:
        acc = 0
        for j, c in enumerate(coeffs):
            acc += c * data[-1 - j]
        data.append((acc >> shift) + e)
    return data


def _decode_subframe(bits: _Bits, block_size: int, bps: int) -> np.ndarray:
    if _native is not None and _native.available():
        data, new_pos = _native.decode_subframe(bits.buf, bits.pos, block_size, bps)
        if data is not None:
            bits.pos = new_pos
            SUBFRAMES["native"] += 1
            return data
        # native reported an error: re-run the python path from the same
        # position for the precise FlacError message
    if bits.read(1):
        raise FlacError("subframe padding bit set")
    sf_type = bits.read(6)
    wasted = 0
    if bits.read(1):
        wasted = bits.unary() + 1
        bps -= wasted
        if bps <= 0:
            raise FlacError("wasted bits exceed sample bit depth")
    if sf_type == 0:  # CONSTANT
        data = [bits.read_signed(bps)] * block_size
    elif sf_type == 1:  # VERBATIM
        data = [bits.read_signed(bps) for _ in range(block_size)]
    elif 8 <= sf_type <= 12:  # FIXED order 0-4
        order = sf_type - 8
        warmup = [bits.read_signed(bps) for _ in range(order)]
        residual = _decode_residual(bits, block_size, order)
        data = _predict(warmup, residual, _FIXED_COEFFS[order], 0)
    elif sf_type >= 32:  # LPC order 1-32
        order = sf_type - 31
        warmup = [bits.read_signed(bps) for _ in range(order)]
        precision = bits.read(4)
        if precision == 0xF:
            raise FlacError("invalid LPC coefficient precision")
        precision += 1
        shift = bits.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coeffs = [bits.read_signed(precision) for _ in range(order)]
        residual = _decode_residual(bits, block_size, order)
        data = _predict(warmup, residual, coeffs, shift)
    else:
        raise FlacError(f"reserved subframe type {sf_type:#08b}")
    if sf_type >= 8 and data:
        # every valid subframe's samples fit the declared bit depth; a
        # FIXED/LPC recurrence escaping that range means a corrupt stream
        # (and, unchecked, unbounded python ints that overflow the int64
        # conversion below — the C path applies the identical per-sample
        # bound, keeping the two paths' accept/reject sets equal and the C
        # accumulator provably inside int64)
        lim = 1 << (bps - 1)
        if not (-lim <= min(data) and max(data) < lim):
            raise FlacError("decoded sample exceeds bit depth (corrupt stream)")
    if wasted:
        data = [v << wasted for v in data]
    SUBFRAMES["python"] += 1
    return np.asarray(data, np.int64)


def _decode_frame(buf: bytes, byte_pos: int, info: dict, verify_crc: bool):
    """One frame at byte_pos -> (channel-major sample lists, next byte_pos)."""
    bits = _Bits(buf, byte_pos * 8)
    sync = bits.read(14)
    if sync != 0x3FFE:
        raise FlacError(f"bad frame sync at byte {byte_pos}: {sync:#x}")
    if bits.read(1):
        raise FlacError("reserved bit set in frame header")
    bits.read(1)  # blocking strategy (frame/sample numbering only)
    bs_code = bits.read(4)
    sr_code = bits.read(4)
    ch_code = bits.read(4)
    ss_code = bits.read(3)
    if bits.read(1):
        raise FlacError("reserved bit set in frame header")
    _read_utf8_number(bits)
    if bs_code == 0:
        raise FlacError("reserved block size code 0")
    elif bs_code == 6:
        block_size = bits.read(8) + 1
    elif bs_code == 7:
        block_size = bits.read(16) + 1
    else:
        block_size = _BLOCKSIZE_CODES[bs_code]
    if sr_code == 12:
        bits.read(8)
    elif sr_code in (13, 14):
        bits.read(16)
    elif sr_code == 15:
        raise FlacError("invalid sample rate code")
    if ss_code in (0,):
        bps = info["bits_per_sample"]
    elif ss_code == 3:
        raise FlacError("reserved sample size code")
    else:
        bps = _SAMPLE_SIZE_CODES[ss_code]
    header_end = (bits.pos + 7) >> 3  # header is byte-aligned pre-CRC
    crc8 = bits.read(8)
    if _crc8(buf[byte_pos:header_end]) != crc8:
        raise FlacError(f"frame header CRC-8 mismatch at byte {byte_pos}")

    if ch_code < 8:
        n_ch = ch_code + 1
        channels = [
            _decode_subframe(bits, block_size, bps) for _ in range(n_ch)
        ]
    elif ch_code in (8, 9, 10):
        # the SIDE channel carries one extra bit; int64 numpy shifts are
        # arithmetic, matching the exact python-int reference semantics
        if ch_code == 8:  # left/side
            left = _decode_subframe(bits, block_size, bps)
            side = _decode_subframe(bits, block_size, bps + 1)
            channels = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _decode_subframe(bits, block_size, bps + 1)
            right = _decode_subframe(bits, block_size, bps)
            channels = [side + right, right]
        else:  # mid/side
            mid = _decode_subframe(bits, block_size, bps)
            side = _decode_subframe(bits, block_size, bps + 1)
            m2 = (mid << 1) | (side & 1)
            channels = [(m2 + side) >> 1, (m2 - side) >> 1]
    else:
        raise FlacError(f"reserved channel assignment {ch_code}")

    bits.align()
    frame_end = bits.pos >> 3
    crc16 = bits.read(16)
    if verify_crc and _crc16(buf[byte_pos:frame_end]) != crc16:
        raise FlacError(f"frame CRC-16 mismatch at byte {byte_pos}")
    return channels, bits.pos >> 3


def decode_flac(data: bytes, verify_crc: bool = False) -> Tuple[np.ndarray, int, int]:
    """FLAC bytes -> (int32 samples (n, channels), sample_rate, bits_per_sample)."""
    pos = 0
    if data[:3] == b"ID3":
        # ID3v2 tag prepended by some taggers: 10-byte header with a
        # 28-bit syncsafe size (+10-byte footer when flagged, ID3v2.4)
        if len(data) < 10:
            raise FlacError("truncated ID3 header")
        size = (
            ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14)
            | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        )
        if data[5] & 0x10:
            size += 10
        pos = 10 + size
    if data[pos:pos + 4] != b"fLaC":
        raise FlacError(
            f"not a native FLAC stream (magic {data[pos:pos + 4]!r}); "
            "Ogg-FLAC/mp3/other containers are unsupported"
        )
    pos += 4

    info = None
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata block header")
        last = data[pos] & 0x80
        btype = data[pos] & 0x7F
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        pos += 4
        if btype == 0:  # STREAMINFO
            block = data[pos:pos + length]
            if len(block) < 34:
                raise FlacError("short STREAMINFO")
            b = _Bits(block)
            b.read(32)  # min/max block size (16+16)
            b.read(48)  # min/max frame size (24+24)
            info = {
                "sample_rate": b.read(20),
                "channels": b.read(3) + 1,
                "bits_per_sample": b.read(5) + 1,
                "total_samples": b.read(36),
            }
        elif btype == 127:
            raise FlacError("invalid metadata block type 127")
        pos += length
        if last:
            break
    if info is None:
        raise FlacError("missing STREAMINFO block")

    n_ch = info["channels"]
    frames: list = []  # list of per-frame [ch0_arr, ch1_arr, ...]
    total = info["total_samples"]
    n = 0
    while pos < len(data) and (total == 0 or n < total):
        frame_channels, pos = _decode_frame(data, pos, info, verify_crc)
        if len(frame_channels) != n_ch:
            raise FlacError("frame channel count != STREAMINFO")
        frames.append(frame_channels)
        n += len(frame_channels[0])
    if total and n > total:  # final partial block padding
        n = total
    if total and n < total:
        raise FlacError(f"stream ends early: {n}/{total} samples")
    out = np.empty((n, n_ch), np.int32)
    for i in range(n_ch):
        col = (np.concatenate([f[i] for f in frames])
               if frames else np.empty(0, np.int64))
        out[:, i] = col[:n]
    return out, info["sample_rate"], info["bits_per_sample"]


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Read a FLAC file -> (float32 in [-1,1] shaped (n,) or (n, channels), sr).

    Mirrors read_wav's output contract so read_wav_file treats both formats
    identically downstream (resample -> normalize -> pad).
    """
    with open(path, "rb") as f:
        data = f.read()
    samples, sr, bps = decode_flac(data)
    scale = float(1 << (bps - 1))
    out = samples.astype(np.float32) / scale
    if out.shape[1] == 1:
        out = out[:, 0]
    return out, sr
