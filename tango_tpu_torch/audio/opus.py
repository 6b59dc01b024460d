"""Ogg Opus ingestion (RFC 7845 container + RFC 6716 packet codec).

A copy of tango_tpu/audio/opus.py for the port. The reference's loader
decodes anything torchaudio handles — explicitly including opus — via its
bundled C codecs (tools/torch_tools.py:43-54).

Split of responsibilities, and why it differs from the sibling decoders:

* The **Ogg Opus container layer is ours**: page demux (reusing the
  CRC-verified lacing machinery from audio/vorbis.py), OpusHead/OpusTags
  header parsing, channel-mapping validation (families 0/1/255), pre-skip
  removal, granule-position end-trim, Q7.8 output-gain scaling, and
  chained-stream handling — all pure python, all pinned by round-trip and
  hand-assembled-stream tests (tests/test_opus.py).
* The **packet codec is the system libopus** (ctypes,
  ``opus_multistream_decode_float``). Unlike wav/flac/mp3/vorbis — where
  this repo carries complete in-repo decoders pinned against C oracles —
  SILK/CELT is not rebuilt here: the codec is defined by large
  normative tables (SILK NLSF/LTP codebooks, CELT band allocation/PVQ
  tables) that live only in RFC 6716's reference source, which the
  repository does not carry, and the installed libopus.so is stripped of
  the symbols that would let us extract them. Binding the
  system codec is exactly the reference's own position (torchaudio binds
  the same system codec family); we refuse loudly at preflight when the
  library is absent rather than degrade.

Granule semantics (RFC 7845 §4.1): a page's granule position counts 48 kHz
samples up to its last decodable sample INCLUDING the pre-skip region, so
the delivered stream is ``decoded[pre_skip : final_granule]`` — end-trim
falls out of the same slice. (The first-page "start clipping beyond
pre-skip" refinement for spliced live captures is out of scope; files a
muxer writes start at granule ≥ page sample count.)
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import List, Tuple

import numpy as np

from tango_tpu_torch.audio.vorbis import _ogg_packets


class OpusError(ValueError):
    pass


_MAX_FRAME = 5760  # 120 ms at 48 kHz — the largest legal opus frame


_lib = None


def _load_libopus():
    """ctypes handle to the system libopus, or raise OpusError loudly."""
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("opus") or "libopus.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise OpusError(
            "opus decode requires the system libopus shared library, which "
            f"could not be loaded ({e}); install libopus0 or transcode the "
            "file to wav/flac/mp3/ogg-vorbis"
        ) from e
    lib.opus_multistream_decoder_create.restype = ctypes.c_void_p
    lib.opus_multistream_decoder_create.argtypes = [
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)]
    lib.opus_multistream_decode_float.restype = ctypes.c_int
    lib.opus_multistream_decode_float.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
    lib.opus_multistream_decoder_destroy.restype = None
    lib.opus_multistream_decoder_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class _Head:
    """Parsed OpusHead (RFC 7845 §5.1)."""

    def __init__(self, pkt: bytes):
        if len(pkt) < 19 or pkt[:8] != b"OpusHead":
            raise OpusError("bad OpusHead packet")
        version = pkt[8]
        if version >> 4 != 0 or version == 0:
            # upper nibble 0 => backwards-compatible per the RFC; 0 is illegal
            raise OpusError(f"unsupported OpusHead version {version}")
        self.channels = pkt[9]
        if self.channels < 1:
            raise OpusError("OpusHead declares zero channels")
        self.pre_skip = int.from_bytes(pkt[10:12], "little")
        self.input_rate = int.from_bytes(pkt[12:16], "little")  # informational
        self.output_gain = int.from_bytes(pkt[16:18], "little", signed=True)
        family = pkt[18]
        if family == 0:
            if self.channels > 2:
                raise OpusError(
                    f"mapping family 0 allows 1-2 channels, got {self.channels}")
            if len(pkt) != 19:
                raise OpusError("mapping family 0 forbids a channel mapping table")
            self.streams = 1
            self.coupled = self.channels - 1
            self.mapping = bytes(range(self.channels))
        else:
            if family == 1 and self.channels > 8:
                raise OpusError(
                    f"mapping family 1 allows 1-8 channels, got {self.channels}")
            if len(pkt) < 21 + self.channels:
                raise OpusError("truncated channel mapping table")
            self.streams = pkt[19]
            self.coupled = pkt[20]
            self.mapping = pkt[21 : 21 + self.channels]
            if not 1 <= self.streams <= 255:
                raise OpusError(f"invalid stream count {self.streams}")
            if self.coupled > self.streams or self.streams + self.coupled > 255:
                raise OpusError(
                    f"invalid coupled count {self.coupled} for {self.streams} streams")
            for m in self.mapping:
                if m != 255 and m >= self.streams + self.coupled:
                    raise OpusError(f"channel mapping index {m} out of range")


def _decode_link(packets: List[bytes], total_granule: int) -> Tuple[np.ndarray, int]:
    """One Ogg chain link's packets -> ((n, ch) float32 at 48 kHz, channels)."""
    if len(packets) < 2:
        raise OpusError("opus stream missing header packets")
    head = _Head(packets[0])
    if packets[1][:8] != b"OpusTags":
        raise OpusError("second opus packet is not OpusTags")
    lib = _load_libopus()
    err = ctypes.c_int(0)
    mapping = (ctypes.c_ubyte * max(head.channels, 1)).from_buffer_copy(
        bytes(head.mapping))
    dec = lib.opus_multistream_decoder_create(
        48000, head.channels, head.streams, head.coupled, mapping,
        ctypes.byref(err))
    if not dec or err.value != 0:
        raise OpusError(f"libopus rejected the stream layout (error {err.value})")
    try:
        buf = np.empty(_MAX_FRAME * head.channels, np.float32)
        buf_p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        chunks: List[np.ndarray] = []
        for pkt in packets[2:]:
            if len(pkt) == 0:
                # zero-length ogg packets are "packet loss" markers no muxer
                # writes; refuse rather than invent concealment audio
                raise OpusError("empty opus audio packet")
            n = lib.opus_multistream_decode_float(
                dec, pkt, len(pkt), buf_p, _MAX_FRAME, 0)
            if n < 0:
                raise OpusError(f"libopus failed to decode a packet (error {n})")
            chunks.append(
                buf[: n * head.channels].reshape(n, head.channels).copy())
    finally:
        lib.opus_multistream_decoder_destroy(dec)
    pcm = (np.concatenate(chunks, axis=0) if chunks
           else np.zeros((0, head.channels), np.float32))
    end = len(pcm)
    if 0 <= total_granule < end:
        end = total_granule
    pcm = pcm[min(head.pre_skip, end) : end]
    if head.output_gain:
        pcm = pcm * np.float32(10.0 ** (head.output_gain / (20.0 * 256.0)))
    return pcm, head.channels


def decode_opus(data: bytes) -> Tuple[np.ndarray, int]:
    """Ogg Opus bytes -> (float32 (n, channels), 48000).

    Opus always decodes at 48 kHz regardless of the encoder's input rate
    (RFC 7845 §5.1: input_sample_rate is informational only). Chained files
    decode link by link like the vorbis path; links must share a channel
    count (a single return value cannot represent a mid-file layout change).
    """
    pos = 0
    all_chunks: List[np.ndarray] = []
    channels = None
    while pos < len(data):
        packets, total_granule, pos = _ogg_packets(
            data, pos, bos_magic=b"OpusHead", err_cls=OpusError)
        pcm, ch = _decode_link(packets, total_granule)
        if channels is None:
            channels = ch
        elif ch != channels:
            raise OpusError(
                f"chained stream changes layout mid-file ({channels}ch -> {ch}ch)")
        all_chunks.append(pcm)
    if channels is None:
        raise OpusError("no opus stream found")
    pcm = np.concatenate(all_chunks, axis=0) if len(all_chunks) > 1 else all_chunks[0]
    return pcm, 48000


def read_opus(path: str) -> Tuple[np.ndarray, int]:
    """Read an Ogg Opus file -> (float32 (n,) or (n, ch) in [-1, 1], 48000) —
    read_wav's output contract (see audio/wav.read_wav)."""
    with open(path, "rb") as f:
        data = f.read()
    pcm, sr = decode_opus(data)
    if pcm.ndim == 2 and pcm.shape[1] == 1:
        pcm = pcm[:, 0]
    return pcm, sr


def libopus_available() -> bool:
    """True when the system libopus can be loaded (manifest preflight gates
    opus manifests on this so a missing codec fails before training starts)."""
    try:
        _load_libopus()
        return True
    except OpusError:
        return False
