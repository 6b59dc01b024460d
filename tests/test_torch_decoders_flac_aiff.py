"""The port's FLAC and AIFF decoders against the JAX package's, on the streams
the JAX tests build (tests/test_flac.py, tests/test_flac_fuzz.py,
tests/test_aiff.py, tests/test_aiff_fuzz.py): the same PCM bit for bit, the
same rate, or the same exception class and message. The port's native FLAC
subframe decoder (C through ctypes, built at first use) is held to its
python path, and to JAX's decode with JAX's native decoder.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest
from hypothesis import given

from tango_tpu.audio import aiff as jaiff
from tango_tpu.audio import flac as jflac
from tango_tpu_torch.audio import aiff as taiff
from tango_tpu_torch.audio import flac as tflac
from tango_tpu_torch.audio import flac_native
from tests._flac_encoder import encode_flac
from tests._torch_decoder_parity import FUZZ, assert_same, mutate, mutations
from tests.test_aiff import _build_aifc, _write_aifc_fixture
from tests.test_flac_fuzz import _streams as flac_fuzz_streams


def _sig(n, seed=0, lo=-2000, hi=2000):
    return np.random.default_rng(seed).integers(lo, hi, size=n).astype(np.int64)


def _smooth(n, seed, scale=1000, period=50):
    t = np.arange(n)
    return (scale * np.sin(t / period) + _sig(n, seed=seed, lo=-20, hi=20)).astype(np.int64)


def _stereo(seed_a, seed_b, n=1500):
    return np.stack([_sig(n, seed=seed_a), _sig(n, seed=seed_b)], axis=1)


def _require_native():
    # decided in the test, not at import: available() builds the library
    if not flac_native.available():
        pytest.skip(f"native FLAC decoder unavailable: {flac_native.build_info}")


# name -> (bytes, verify_crc): the feature matrix of tests/test_flac.py
FLAC_STREAMS = {
    "verbatim_mono_22050": lambda: encode_flac(_sig(3000), sample_rate=22050),
    **{f"fixed_order{o}": (lambda o=o: encode_flac(
        _smooth(2048, o), block_size=512, kind="fixed", order=o, rice_param=6,
        partition_order=2)) for o in range(5)},
    "lpc_rice2_escape": lambda: encode_flac(
        (3000 * np.sin(np.arange(4000) / 30)).astype(np.int64), block_size=1024, kind="lpc",
        lpc_coeffs=[985, -312], lpc_shift=9, lpc_precision=12, rice_param=5,
        partition_order=1, method=1, escape_partitions=(1,)),
    "lpc_order3_mid_side": lambda: encode_flac(
        _stereo(5, 6, 3000), block_size=1024, stereo_mode="mid_side", kind="lpc",
        lpc_coeffs=[900, -200, 50], lpc_shift=9, lpc_precision=12, rice_param=6,
        partition_order=2, method=1, escape_partitions=(3,)),
    "constant": lambda: encode_flac(np.full(900, -137, np.int64), block_size=450,
                                    kind="constant"),
    **{f"stereo_{m}": (lambda m=m: encode_flac(_stereo(1, 2), block_size=512, stereo_mode=m))
       for m in ("independent", "left_side", "right_side", "mid_side")},
    "wasted_bits": lambda: encode_flac(_sig(1000, lo=-100, hi=100) << 3, block_size=500,
                                       wasted=3),
    "wasted_bits_fixed": lambda: encode_flac(_sig(2000, seed=7, lo=-200, hi=200) << 3,
                                             block_size=500, kind="fixed", order=1,
                                             rice_param=5, wasted=3),
    "24bit": lambda: encode_flac(_sig(1200, lo=-(1 << 22), hi=1 << 22), bps=24, block_size=600),
    "8bit_48k": lambda: encode_flac(_sig(700, lo=-128, hi=128), bps=8, sample_rate=48000,
                                    block_size=256),
    "partial_final_block": lambda: encode_flac(_sig(1000), block_size=384),
    "unknown_total": lambda: encode_flac(_sig(1000), block_size=384, total_in_streaminfo=False),
    "id3_prefix": lambda: encode_flac(_sig(500), block_size=500,
                                      id3_prefix=b"ID3\x04\x00\x00\x00\x00\x00\x0a" + b"\x00" * 10),
    "six_channels": lambda: encode_flac(np.stack([_sig(800, seed=c) for c in range(6)], 1),
                                        block_size=400, sample_rate=48000),
}


@pytest.mark.parametrize("verify_crc", [False, True])
@pytest.mark.parametrize("name", sorted(FLAC_STREAMS))
def test_flac_streams_match_jax(name, verify_crc, monkeypatch):
    """Each valid stream: JAX's samples, every subframe on the native path
    (a native error falls back to python, which would hide a fault of the C
    decoder), and the python path's samples."""
    data = FLAC_STREAMS[name]()
    before = dict(tflac.SUBFRAMES)
    out = assert_same(jflac.decode_flac, tflac.decode_flac, data, verify_crc=verify_crc)
    assert out[0] == "ok"
    if flac_native.available():
        assert tflac.SUBFRAMES["python"] == before["python"]
        assert tflac.SUBFRAMES["native"] > before["native"]
    monkeypatch.setattr(tflac, "_native", None)
    python = tflac.decode_flac(data, verify_crc=verify_crc)
    for a, b in zip(out[1], python):
        np.testing.assert_array_equal(a, b)


def _crc_corrupt():
    data = bytearray(encode_flac(_sig(800), block_size=400))
    data[-10] ^= 0x10  # inside the last frame's audio payload
    return bytes(data)


# malformed streams: each must give JAX's outcome, most of them its error
FLAC_MALFORMED = {
    "crc16_corrupt": (_crc_corrupt, True),
    "crc16_corrupt_unchecked": (_crc_corrupt, False),
    "ogg_magic": (lambda: b"OggS" + b"\x00" * 100, False),
    "empty": (lambda: b"", False),
    "magic_only": (lambda: b"fLaC", False),
    "frame_sync_broken": (lambda: (lambda d: d[:42] + bytes([d[42] ^ 0xFF]) + d[43:])(
        encode_flac(_sig(600), block_size=300)), False),
    "streaminfo_rate_zero": (lambda: (lambda d: d[:18] + b"\x00\x00" + bytes([d[20] & 0x0F])
                                      + d[21:])(encode_flac(_sig(600), block_size=300)), False),
    **{f"truncated_{int(100 * f)}pct": (lambda f=f: (lambda d: d[:int(len(d) * f)])(
        encode_flac(_stereo(3, 4, 1200), block_size=256, stereo_mode="left_side")), False)
       for f in (0.02, 0.1, 0.3, 0.6, 0.9, 0.99)},
}


@pytest.mark.parametrize("name", sorted(FLAC_MALFORMED))
def test_flac_malformed_matches_jax(name):
    make, verify = FLAC_MALFORMED[name]
    assert_same(jflac.decode_flac, tflac.decode_flac, make(), verify_crc=verify)


def test_flac_order_exceeding_block_size_rejected():
    """An LPC subframe of order 32 in a 16-sample block: both packages'
    subframe decoders refuse it, on the native path and the python path."""
    buf = bytes([0x7E]) + b"\x00" * 64
    assert_same(lambda: jflac._decode_subframe(jflac._Bits(buf), 16, 16),
                lambda: tflac._decode_subframe(tflac._Bits(buf), 16, 16))
    _require_native()
    data, err = flac_native.decode_subframe(buf, 0, 16, 16)
    assert data is None and err < 0


def test_flac_native_path_is_taken_and_matches_python(monkeypatch):
    """The native decoder builds at first use into the repository's build/
    and decodes every subframe of a valid stream; the python path gives the
    same samples, and so does JAX."""
    _require_native()
    assert "error" not in flac_native.build_info
    assert flac_native.build_info["path"].endswith(".so")
    data = FLAC_STREAMS["lpc_order3_mid_side"]()
    before = dict(tflac.SUBFRAMES)
    native = tflac.decode_flac(data)
    assert tflac.SUBFRAMES["python"] == before["python"]
    assert tflac.SUBFRAMES["native"] > before["native"]
    monkeypatch.setattr(tflac, "_native", None)
    python = tflac.decode_flac(data)
    assert tflac.SUBFRAMES["python"] > before["python"]
    for a, b in zip(native, python):
        np.testing.assert_array_equal(a, b)
    assert jflac._native is not None  # JAX's own native decoder, so both paths are compared
    np.testing.assert_array_equal(native[0], jflac.decode_flac(data)[0])


def test_flac_native_unavailable_falls_back(monkeypatch, tmp_path):
    """No compiler: available() is false, build_info carries the error, and
    decode_flac takes the python path with the same result."""
    monkeypatch.setattr(flac_native, "_LIB", None)
    monkeypatch.setattr(flac_native, "_tried", False)
    monkeypatch.setattr(flac_native, "build_info", {})
    monkeypatch.setattr(flac_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++, cc or gcc
    assert not flac_native.available()
    assert "error" in flac_native.build_info
    data = FLAC_STREAMS["stereo_mid_side"]()
    before = dict(tflac.SUBFRAMES)
    assert_same(jflac.decode_flac, tflac.decode_flac, data)
    assert tflac.SUBFRAMES["native"] == before["native"]


@pytest.mark.parametrize("stream", range(6))
def test_flac_fuzz_streams_both_paths(stream, monkeypatch):
    """tests/test_flac_fuzz.py's base streams, truncated at five points:
    the port's native path, its python path and JAX give one outcome."""
    base = flac_fuzz_streams()[stream]
    for frac in (0.1, 0.3, 0.6, 0.9, 0.99, 1.0):
        data = base[:int(len(base) * frac)]
        native = assert_same(jflac.decode_flac, tflac.decode_flac, data)
        monkeypatch.setattr(tflac, "_native", None)
        python = assert_same(jflac.decode_flac, tflac.decode_flac, data)
        monkeypatch.undo()
        assert native[0] == python[0]


_FUZZ_FLAC = flac_fuzz_streams()[2]  # LPC, rice partitions


@FUZZ
@given(mutations(len(_FUZZ_FLAC)))
def test_flac_fuzz_parity(m):
    assert_same(jflac.decode_flac, tflac.decode_flac, mutate(_FUZZ_FLAC, *m))


# ------------------------------------------------------------------ AIFF


def _pcm(n, ch, seed, dtype=np.int16):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, size=(n, ch)).astype(dtype)


def _aifc_file(tmp_path, name, data, rate, comptype=b"NONE"):
    path = tmp_path / name
    _write_aifc_fixture(path, data, rate, comptype=comptype)
    return path.read_bytes()


AIFF_HAND = {
    "sowt": lambda: _build_aifc(np.array([[-32768, 32767], [1, -2], [12345, -12345]], np.int16)
                                .astype("<i2").tobytes(), 2, 3, 16, 48000, comp=b"sowt"),
    **{f"float_{c.decode()}": (lambda c=c, dt=dt: _build_aifc(
        np.array([[0.25, -1.0], [0.5, 0.999], [-0.0625, 0.0]]).astype(dt).tobytes(), 2, 3,
        32 if dt == ">f4" else 64, 44100, comp=c))
       for c, dt in ((b"fl32", ">f4"), (b"FL32", ">f4"), (b"fl64", ">f8"), (b"FL64", ">f8"))},
    "pcm24": lambda: _build_aifc(b"".join(int(v & 0xFFFFFF).to_bytes(3, "big") for v in
                                          (-(1 << 23), (1 << 23) - 1, 1, -1, -123456)),
                                 1, 5, 24, 96000),
    "pcm12_in_two_bytes": lambda: _build_aifc(
        (np.array([-2048, 2047, -1, 1, 0], np.int64) << 4).astype(">i2").tobytes(), 1, 5, 12,
        11025),
    "ssnd_offset": lambda: _build_aifc(np.array([100, -100], ">i2").tobytes(), 1, 2, 16, 8000,
                                       ssnd_offset=6),
    "plain_aiff_form": lambda: _build_aifc(_pcm(300, 2, 9).astype(">i2").tobytes(), 2, 300, 16,
                                           22050, form=b"AIFF"),
    **{f"rate_{r}": (lambda r=r: _build_aifc(b"\x00\x00", 1, 1, 16, r))
       for r in (8000, 11025, 22050, 44100, 96000, 192000)},
    # the error paths of tests/test_aiff.py
    "compressed_ima4": lambda: _build_aifc(b"\x00" * 34, 1, 1, 16, 8000, comp=b"ima4"),
    "truncated_ssnd": lambda: _build_aifc(np.zeros(100, ">i2").tobytes(), 1, 200, 16, 8000),
    "missing_comm": lambda: (lambda body: b"FORM" + struct.pack(">L", 4 + len(body)) + b"AIFF"
                             + body)(b"SSND" + struct.pack(">L", 8) + struct.pack(">LL", 0, 0)),
    "wave_form": lambda: b"FORM\x00\x00\x00\x04WAVE",
    "rate_below_half": lambda: _build_aifc(b"\x00\x00", 1, 1, 16, 0.25),
    "zero_channels": lambda: _build_aifc(b"", 0, 0, 16, 8000),
    "header_only": lambda: _build_aifc(b"\x00" * 40, 1, 20, 16, 8000)[:30],
}


@pytest.mark.parametrize("name", sorted(AIFF_HAND))
def test_aiff_hand_assembled_match_jax(name):
    assert_same(jaiff.decode_aiff, taiff.decode_aiff, AIFF_HAND[name]())


@pytest.mark.parametrize("ch,rate,suffix,width,comp", [
    (1, 16000, ".aiff", 2, b"NONE"), (2, 44100, ".aiff", 2, b"NONE"),
    (2, 8000, ".aifc", 2, b"NONE"), (3, 22050, ".aifc", 2, b"NONE"),
    (2, 32000, ".aiff", 1, b"NONE"), (2, 32000, ".aiff", 4, b"NONE"),
    (2, 8000, ".aifc", 2, b"ulaw"), (2, 8000, ".aifc", 2, b"alaw"),
    (2, 8000, ".aifc", 2, b"ULAW"), (2, 8000, ".aifc", 2, b"ALAW"),
])
def test_aiff_stdlib_written_match_jax(tmp_path, ch, rate, suffix, width, comp):
    """Files the stdlib `aifc` writes (AIFF and AIFF-C, 8/16/32-bit, G.711)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import aifc

    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    data = _pcm(401, ch, seed=ch * 7 + rate + width, dtype=dtype)
    path = tmp_path / f"x{suffix}"
    if width == 2:
        try:
            _write_aifc_fixture(path, data, rate, comptype=comp)
        except aifc.Error:
            pytest.skip(f"stdlib aifc cannot write {comp!r} on this build")
    else:
        f = aifc.open(str(path), "wb")
        f.setnchannels(ch)
        f.setsampwidth(width)
        f.setframerate(rate)
        f.writeframes(data.astype(f">i{width}").tobytes())
        f.close()
    out = assert_same(jaiff.decode_aiff, taiff.decode_aiff, path.read_bytes())
    assert out[0] == "ok" and out[1][1] == rate
    assert_same(jaiff.read_aiff, taiff.read_aiff, str(path))


_FUZZ_AIFF = _build_aifc((np.random.default_rng(0).standard_normal((500, 2)) * 8000)
                         .astype(">i2").tobytes(), 2, 500, 16, 22050, b"NONE", b"AIFC")


@FUZZ
@given(mutations(len(_FUZZ_AIFF)))
def test_aiff_fuzz_parity(m):
    assert_same(jaiff.decode_aiff, taiff.decode_aiff, mutate(_FUZZ_AIFF, *m))


@FUZZ
@given(mutations(64, max_flips=6))
def test_aiff_fuzz_header_parity(m):
    """Flips confined to the first 64 bytes: the FORM, COMM and SSND
    headers, where the sizes, channels and the 80-bit rate live."""
    assert_same(jaiff.decode_aiff, taiff.decode_aiff,
                mutate(_FUZZ_AIFF[:64], *m) + _FUZZ_AIFF[64:])
