"""The port's Ogg Vorbis and Ogg Opus decoders against the JAX package's, on
the streams the JAX tests build: libvorbisenc streams
(tests/_vorbis_oracle.py, as tests/test_vorbis.py and
tests/test_vorbis_fuzz.py), hand-assembled Vorbis streams for floor 0, the
residue types and the codebook corners libvorbisenc never emits
(tests/_vorbis_assembler.py, as tests/test_vorbis_assembled.py), and Ogg Opus
streams muxed by the in-repo writer over the system libopus
(tests/_opus_fixtures.py, as tests/test_opus.py). The same PCM bit for bit
and the same rate, or the same exception class and message. The Vorbis
clips are short: both decoders are pure python at ~0.1 s a second of audio.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given
from hypothesis import strategies as st

from tango_tpu.audio import opus as jopus
from tango_tpu.audio import vorbis as jvorbis
from tango_tpu_torch.audio import opus as topus
from tango_tpu_torch.audio import vorbis as tvorbis
from tests._torch_decoder_parity import FUZZ, assert_same, mutate, mutations
from tests.test_vorbis import _signal
from tests.test_vorbis_assembled import FLOOR0_CASES, _books, _entries, _spec
from tests.test_vorbis_fuzz import _page_spans, _restamp_crc


def _encoder():
    try:
        from tests._vorbis_oracle import encode_vorbis
    except OSError:
        pytest.skip("system libvorbis not available")
    return encode_vorbis


def same_vorbis(data: bytes):
    return assert_same(jvorbis.decode_vorbis, tvorbis.decode_vorbis, data)


# ------------------------------------------------------- libvorbisenc streams

# nch, n, sr, kind, quality, managed_kbps: tests/test_vorbis.py's CASES, cut short
VORBIS_CASES = [
    (2, 6000, 44100, "tone+noise", 0.4, None),
    (2, 6000, 44100, "noise", 0.0, None),
    (2, 6000, 16000, "sweep", 0.5, None),
    (1, 4000, 8000, "tone+noise", 0.1, None),
    (2, 6000, 48000, "sweep", -0.1, None),
    (2, 5000, 22050, "impulses", 0.3, None),
    (2, 5000, 44100, "silence", 0.4, None),
    (6, 3000, 44100, "tone+noise", 0.4, None),
    (2, 6000, 44100, "tone+noise", None, 64),
    (1, 4000, 11025, "noise", 1.0, None),
    (3, 4000, 24000, "sweep", 0.7, None),
]


@pytest.mark.parametrize("case", range(len(VORBIS_CASES)))
def test_vorbis_libvorbisenc_streams_match_jax(case):
    nch, n, sr, kind, q, kbps = VORBIS_CASES[case]
    data = _encoder()(_signal(nch, n, sr, kind, case), sr, quality=0.4 if q is None else q,
                      managed_kbps=kbps)
    out = same_vorbis(data)
    assert out[0] == "ok" and out[1][0].shape == (n, nch)  # granule trimming


@pytest.mark.parametrize("n", [100, 700, 2048])
def test_vorbis_granule_trim_short_streams(n):
    same_vorbis(_encoder()(_signal(1, n, 16000, "noise", n), 16000, quality=0.2))


def test_vorbis_chained_streams():
    enc = _encoder()
    a = _signal(1, 3000, 16000, "tone+noise", 30)
    b = _signal(1, 2000, 16000, "noise", 31)
    chained = enc(a, 16000, quality=0.3, serial=111) + enc(b, 16000, quality=0.5, serial=222)
    out = same_vorbis(chained)
    assert out[0] == "ok" and out[1][0].shape == (5000, 1)
    stereo = enc(_signal(2, 2000, 16000, "noise", 32), 16000, quality=0.3, serial=333)
    out = same_vorbis(enc(a, 16000, quality=0.3, serial=111) + stereo)
    assert out[:2] == ("raise", "VorbisError")


def _good():
    return _encoder()(_signal(1, 4000, 16000, "noise", 5), 16000, quality=0.2)


VORBIS_MALFORMED = {
    "not_ogg": lambda g: b"NotOggData" + g[10:],
    "page_crc": lambda g: g[:200] + bytes([g[200] ^ 0xFF]) + g[201:],
    "truncated_half": lambda g: g[:len(g) // 2 + 3],
    "magic_only": lambda g: g[:4],
    "empty": lambda g: b"",
    "headers_only": lambda g: g[:_page_spans(g)[1][1]],
    "no_setup": lambda g: g[:_page_spans(g)[0][1]],
    "truncated_last_page": lambda g: g[:-7],
}


@pytest.mark.parametrize("name", sorted(VORBIS_MALFORMED))
def test_vorbis_malformed_matches_jax(name):
    same_vorbis(VORBIS_MALFORMED[name](_good()))


# --------------------------------------------------- hand-assembled streams


def _assembled(kind, rtype=0):
    from tests._vorbis_assembler import BookSpec, StreamSpec, assemble

    rng = np.random.RandomState({"residue0": 0, "residue2": 1, "ordered": 2, "single": 3,
                                 "two_pass": 4, "begin_end": 5, "unvoiced": 6}.get(kind, 7))
    pcl = [[i % 2 for i in range(16)]]
    if kind == "residue2":
        spec = _spec(StreamSpec, _books(BookSpec), channels=2, residue_type=2, residue_end=256,
                     coupling=[(0, 1)])
        pcl = [[(i // 3) % 2 for i in range(32)]]
        return assemble(spec, [spec.audio_packet([[60, 50, 30, 40], [55, 45, 20, 35]], pcl,
                                                 [_entries(rng, pcl[0])])] * 4)
    if kind == "unvoiced":
        spec = _spec(StreamSpec, _books(BookSpec), channels=2, residue_type=1)
        pcl = [[i % 2 for i in range(16)], [0] * 16]
        return assemble(spec, [spec.audio_packet([[60, 50, 30, 40], None], pcl,
                                                 [_entries(rng, pcl[0]), []])] * 4)
    if kind == "two_pass":
        spec = _spec(StreamSpec, _books(BookSpec), residue_classifications=1,
                     residue_books=[[2, 3] + [-1] * 6])
        pcl = [[0] * 16]
        ents = _entries(rng, [0] * 16) + _entries(rng, [1] * 16)
        return assemble(spec, [spec.audio_packet([[60, 50, 30, 40]], pcl, [ents])] * 4)
    if kind == "begin_end":
        spec = _spec(StreamSpec, _books(BookSpec), residue_begin=16, residue_end=112)
        pcl = [[i % 2 for i in range(12)]]
        return assemble(spec, [spec.audio_packet([[60, 50, 30, 40]], pcl,
                                                 [_entries(rng, pcl[0])])] * 4)
    single = kind == "single"
    spec = _spec(StreamSpec, _books(BookSpec, floor_ordered=kind == "ordered", single=single),
                 residue_type=rtype)
    pk = spec.audio_packet([[60, 50, 30, 40]], pcl, [_entries(rng, pcl[0], single=single)])
    if kind == "eop":  # every truncation of the third packet
        return [assemble(spec, [pk, pk, pk[:cut], pk]) for cut in range(1, len(pk) + 1)]
    return assemble(spec, [pk] * 4)


@pytest.mark.parametrize("kind", ["residue0", "residue2", "ordered", "single", "two_pass",
                                  "begin_end", "unvoiced"])
def test_vorbis_assembled_match_jax(kind):
    out = same_vorbis(_assembled(kind))
    assert out[0] == "ok"


@pytest.mark.parametrize("rtype", [0, 1])
def test_vorbis_eop_truncation_every_cut(rtype):
    for data in _assembled("eop", rtype):
        same_vorbis(data)


def _floor0(case, amp_override=None):
    from tests._vorbis_assembler import BookSpec, StreamSpec, assemble
    from tests._vorbis_assembler import pack_float as pf

    _, order, bark, f0rate, bs, amp, ents = case
    rng = np.random.RandomState(40 + FLOOR0_CASES.index(case))
    books = [
        BookSpec(dims=4, lengths=[4] * 16, lookup_type=1, min_val=pf(0.12), delta=pf(0.18),
                 value_bits=2, multiplicands=[0, 1], sequence_p=1),
        BookSpec(dims=2, lengths=[2] * 4),
        BookSpec(dims=4, lengths=[4] * 16, lookup_type=1, min_val=pf(-0.5), delta=pf(0.25),
                 value_bits=1, multiplicands=[0, 1]),
    ]
    spec = StreamSpec(channels=1, rate=16000, bs0=bs, bs1=bs, books=books, floor_type=0,
                      floor_book=0, floor0_order=order, floor0_rate=f0rate,
                      floor0_bark_size=bark, floor0_amp_bits=6, floor0_amp_offset=10,
                      residue_type=1, residue_begin=0, residue_end=bs // 2, residue_psize=8,
                      residue_classifications=2, residue_classbook=1,
                      residue_books=[[2] + [-1] * 7, [2] + [-1] * 7])
    ptr = (bs // 2) // 8
    pcl = [[i % 2 for i in range(ptr)]]
    vent = [int(rng.randint(16)) for _ in range(ptr * 2)]
    floor = None if amp_override == 0 else (amp if amp_override is None else amp_override, ents)
    return assemble(spec, [spec.audio_packet([floor], pcl, [vent])] * 4)


@pytest.mark.parametrize("case", FLOOR0_CASES, ids=[c[0] for c in FLOOR0_CASES])
def test_vorbis_floor0_match_jax(case):
    """Floor type 0 (LSP), which no encoder emits; also at an amplitude
    past the well-conditioned range tests/test_vorbis_assembled.py keeps to,
    where the curve overflows: the port still gives JAX's numbers."""
    out = same_vorbis(_floor0(case))
    assert out[0] == "ok"
    same_vorbis(_floor0(case, amp_override=40))


def test_vorbis_floor0_unvoiced():
    out = same_vorbis(_floor0(FLOOR0_CASES[0], amp_override=0))
    assert out[0] == "ok" and np.abs(out[1][0]).max() == 0


def _fuzz_base():
    from tests._vorbis_oracle import encode_vorbis

    return encode_vorbis(_signal(1, 3000, 16000, "tone+noise", 4), 16000, quality=0.2)


try:
    _FUZZ_OGG = _fuzz_base()
except OSError:  # no system libvorbis: the fuzz skips below
    _FUZZ_OGG = None


@st.composite
def _page_mutations(draw):
    """Byte flips inside one page's body or header fields, the page's CRC
    re-stamped so the Vorbis parsers see the corruption, and a truncation."""
    spans = _page_spans(_FUZZ_OGG)
    s, e, nsegs = spans[draw(st.integers(0, len(spans) - 1))]
    flips = draw(st.lists(st.tuples(st.integers(s + 4, e - 1), st.integers(1, 255)),
                          min_size=1, max_size=6))
    cut = draw(st.one_of(st.none(), st.integers(4, len(_FUZZ_OGG))))
    return s, e, flips, cut


@pytest.mark.skipif(_FUZZ_OGG is None, reason="system libvorbis not available")
@FUZZ
@given(_page_mutations())
def test_vorbis_fuzz_parity_crc_restamped(m):
    s, e, flips, cut = m
    buf = bytearray(_FUZZ_OGG)
    for pos, mask in flips:
        if not 22 <= pos - s < 26:  # the CRC field itself is re-stamped
            buf[pos] ^= mask
    _restamp_crc(buf, s, e)
    same_vorbis(bytes(buf[:cut] if cut is not None else buf))


@pytest.mark.skipif(_FUZZ_OGG is None, reason="system libvorbis not available")
@FUZZ
@given(mutations(len(_FUZZ_OGG) if _FUZZ_OGG else 1))
def test_vorbis_fuzz_parity_raw(m):
    same_vorbis(mutate(_FUZZ_OGG, *m))


# --------------------------------------------------------------- Ogg Opus

needs_libopus = pytest.mark.skipif(not jopus.libopus_available(),
                                   reason="system libopus not loadable")


def _sig(seconds=0.1, freq=440.0, seed=0, ch=1):
    n = int(48000 * seconds)
    t = np.arange(n) / 48000.0
    base = 0.4 * np.sin(2 * np.pi * freq * t) + 0.05 * np.random.default_rng(seed).standard_normal(n)
    if ch == 1:
        return base.astype(np.float32)
    return np.stack([base * (0.9 - 0.1 * i) for i in range(ch)], axis=1).astype(np.float32)


def _surround():
    t = np.arange(4800) / 48000.0
    chans = [0.3 * np.sin(2 * np.pi * f * t) for f in (440, 550, 660, 220, 330)]
    chans.insert(3, 0.3 * np.sin(2 * np.pi * 60.0 * t))
    return np.stack(chans, axis=1).astype(np.float32)


def _opus_streams():
    from tests._opus_fixtures import encode_opus, ogg_wrap, opus_head

    good = encode_opus(_sig(0.05), bitrate=128000)
    pkts, _, _ = jopus._ogg_packets(good, 0, bos_magic=b"OpusHead", err_cls=jopus.OpusError)
    grans = [0, 0] + [960 * (i + 1) for i in range(len(pkts) - 2)]

    def rebuild(head=None, tags=None):
        p = list(pkts)
        if head is not None:
            p[0] = head
        if tags is not None:
            p[1] = tags
        return ogg_wrap(p, grans)

    empty = list(pkts)
    empty.insert(3, b"")
    look = int.from_bytes(good[good.index(b"OpusHead") + 10:][:2], "little")
    return {
        "mono": lambda: encode_opus(_sig(0.1), bitrate=192000),
        "stereo": lambda: encode_opus(_sig(0.1, ch=2), bitrate=256000),
        "surround_family1": lambda: encode_opus(_surround(), bitrate=768000),
        "gain_q8": lambda: encode_opus(_sig(0.1), bitrate=192000, gain_q8=-1542),
        "frame_2_5ms": lambda: encode_opus(_sig(0.05), bitrate=128000, frame=120),
        "frame_60ms": lambda: encode_opus(_sig(0.12), bitrate=128000, frame=2880),
        "final_granule_short": lambda: encode_opus(_sig(0.1), bitrate=128000,
                                                   final_granule=look + 1000),
        "pre_skip_past_end": lambda: encode_opus(_sig(0.04), bitrate=128000, pre_skip=65535),
        "granules_unset": lambda: ogg_wrap(pkts, [-1] * len(pkts)),
        "chained": lambda: (encode_opus(_sig(0.06, seed=1), bitrate=128000, serial=1)
                            + encode_opus(_sig(0.05, freq=880, seed=2), bitrate=128000,
                                          serial=2)),
        "chained_layout_change": lambda: (encode_opus(_sig(0.05), bitrate=128000, serial=1)
                                          + encode_opus(_sig(0.05, ch=2), bitrate=128000,
                                                        serial=2)),
        "version_1f": lambda: rebuild(head=opus_head(1, 312, version=0x1F)),
        "version_0": lambda: rebuild(head=opus_head(1, 312, version=0)),
        "version_2": lambda: rebuild(head=opus_head(1, 312, version=2)),
        "family0_three_channels": lambda: rebuild(head=opus_head(3, 312)),
        "trailing_mapping_byte": lambda: rebuild(head=opus_head(1, 312) + b"\x00"),
        "bad_tags": lambda: rebuild(tags=b"NotTags!"),
        "short_head": lambda: rebuild(head=b"OpusHeadX"),
        "mapping_out_of_range": lambda: rebuild(head=opus_head(
            2, 312, family=1, streams=1, coupled=0, mapping=bytes([0, 7]))),
        "silent_channel_mapping": lambda: rebuild(head=opus_head(
            1, 312, family=1, streams=1, coupled=0, mapping=bytes([255]))),
        "empty_audio_packet": lambda: ogg_wrap(empty, [0] * len(empty)),
        "truncated": lambda: good[:len(good) // 2],
        "page_crc": lambda: good[:60] + bytes([good[60] ^ 0x40]) + good[61:],
        "no_opus_stream": lambda: good[:4],
    }


OPUS_NAMES = ["mono", "stereo", "surround_family1", "gain_q8", "frame_2_5ms", "frame_60ms",
              "final_granule_short", "pre_skip_past_end", "granules_unset", "chained",
              "chained_layout_change", "version_1f", "version_0", "version_2",
              "family0_three_channels", "trailing_mapping_byte", "bad_tags", "short_head",
              "mapping_out_of_range", "silent_channel_mapping", "empty_audio_packet",
              "truncated", "page_crc", "no_opus_stream"]


@needs_libopus
@pytest.mark.parametrize("name", OPUS_NAMES)
def test_opus_streams_match_jax(name):
    assert_same(jopus.decode_opus, topus.decode_opus, _opus_streams()[name]())


@needs_libopus
def test_opus_fuzz_parity():
    from tests._opus_fixtures import encode_opus

    base = encode_opus(_sig(0.06, seed=3), bitrate=96000)

    @FUZZ
    @given(mutations(len(base)))
    def check(m):
        assert_same(jopus.decode_opus, topus.decode_opus, mutate(base, *m))

    check()


def test_opus_missing_library_is_loud(monkeypatch):
    """Without a loadable libopus both packages raise OpusError and report
    the library unavailable."""
    for mod in (jopus, topus):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod.ctypes, "CDLL",
                            lambda *a, **k: (_ for _ in ()).throw(OSError("no lib")))
    assert_same(jopus._load_libopus, topus._load_libopus)
    assert not jopus.libopus_available() and not topus.libopus_available()
