"""The port's MPEG audio decoder (Layers I, II and III) against the JAX
package's, on the streams the JAX tests build: Layer III from the in-repo
encoder (tests/_mp3_encoder.py, as tests/test_mp3.py and
tests/test_mp3_fuzz.py use it), Layers I and II from the bitstream assembler
(tests/_mpeg12_assembler.py, as tests/test_mpeg12.py). The same PCM bit for
bit and the same rate, or the same exception class and message.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given

from tango_tpu.audio import mp3 as jmp3
from tango_tpu.audio import mp3_tables as T
from tango_tpu_torch.audio import mp3 as tmp3
from tests import _mpeg12_assembler as A
from tests._mp3_encoder import GranuleSpec, encode_frame, encode_stream
from tests._torch_decoder_parity import FUZZ, assert_same, mutate, mutations
from tests.test_mp3 import (_WIDE, _intensity_frames, _lsf_scalefacs, _rand_spec,
                            _simple_stream, _stereo_frames)
from tests.test_mp3_fuzz import _streams as mp3_fuzz_streams
from tests.test_mpeg12 import PROFILES, to_free_format


def same(data: bytes, **kw):
    return assert_same(jmp3.decode_mp3, tmp3.decode_mp3, data, **kw)


# ------------------------------------------------------------- Layer III


def _every_table():
    rng = np.random.default_rng(0)
    limits = {1: 1, 2: 2, 3: 2, 5: 3, 6: 3, 7: 5, 8: 5, 9: 5, 10: 7, 11: 7, 12: 7, 13: 15, 15: 15}
    for t, lb in T.LINBITS.items():
        limits[t] = 15 + (1 << lb) - 1
    tables = sorted(limits)
    frames = []
    for i in range(0, len(tables), 2):
        gs = []
        for t in tables[i:i + 2]:
            cap = min(limits[t], 4000)
            s = np.zeros(576, np.int64)
            s[:64] = rng.integers(-cap, cap + 1, 64)
            s[0], s[1] = cap, -cap
            gs.append(GranuleSpec(spectrum=s, table_select=(t, t, t), global_gain=120,
                                  region0_count=2, region1_count=2))
        while len(gs) < 2:
            gs.append(GranuleSpec(spectrum=np.zeros(576, np.int64)))
        frames.append([[gs[0]], [gs[1]]])
    return encode_stream(frames, sr=44100, version="1", mode=3, bitrate=320)


def _scfsi():
    rng = np.random.default_rng(1)
    sfl = [int(rng.integers(0, 4)) for _ in range(21)]
    frames = []
    for _ in range(3):
        gs = [GranuleSpec(spectrum=_rand_spec(rng, 5, 180), global_gain=150, scalefac_compress=9,
                          scalefac_l=list(sfl), preflag=1, scalefac_scale=1, **_WIDE)
              for _ in range(2)]
        frames.append([[gs[0]], [gs[1]]])
    return encode_stream(frames, sr=44100, version="1", mode=3, bitrate=256,
                         scfsi=[[1, 0, 1, 0]])


def _block_types():
    rng = np.random.default_rng(2)
    frames = []
    for bt in (1, 2, 3, 0, 2, 0):
        if bt == 2:
            g0 = GranuleSpec(spectrum=_rand_spec(rng, 5, 150), block_type=2,
                             table_select=(9, 9, 9), global_gain=150, subblock_gain=(1, 0, 2),
                             scalefac_compress=13,
                             scalefac_s=[[int(rng.integers(0, 4)) for _ in range(3)]
                                         for _ in range(12)])
            g1 = GranuleSpec(spectrum=_rand_spec(rng, 3, 100), block_type=2,
                             table_select=(5, 5, 5), global_gain=148, scalefac_compress=13,
                             scalefac_s=[[1, 0, 2]] * 12)
        else:
            g0 = GranuleSpec(spectrum=_rand_spec(rng, 5, 150), block_type=bt, global_gain=150,
                             **_WIDE)
            g1 = GranuleSpec(spectrum=_rand_spec(rng, 3, 100), block_type=bt,
                             table_select=(5, 5, 5), region0_count=8, region1_count=7,
                             global_gain=148)
        frames.append([[g0], [g1]])
    return encode_stream(frames, sr=44100, version="1", mode=3, bitrate=320)


def _mixed_blocks():
    rng = np.random.default_rng(3)
    frames = []
    for _ in range(3):
        g0 = GranuleSpec(spectrum=_rand_spec(rng, 5, 150), block_type=2, mixed=True,
                         table_select=(9, 9, 9), global_gain=150,
                         scalefac_l=[int(rng.integers(0, 4)) for _ in range(8)] + [0] * 13,
                         scalefac_s=[[0, 0, 0]] * 3
                         + [[int(rng.integers(0, 4)) for _ in range(3)] for _ in range(9)],
                         scalefac_compress=13, subblock_gain=(0, 1, 0))
        g1 = GranuleSpec(spectrum=_rand_spec(rng, 3, 80), table_select=(5, 5, 5),
                         region0_count=8, region1_count=7, global_gain=148)
        frames.append([[g0], [g1]])
    return encode_stream(frames, sr=44100, version="1", mode=3, bitrate=320)


def _lsf_classes():
    rng = np.random.default_rng(7)
    frames = []
    for sc in (181, 445, 507, 300):
        sfl = _lsf_scalefacs(rng, sc) + [0] * 21
        frames.append([[GranuleSpec(spectrum=_rand_spec(rng, 5, 150), global_gain=150,
                                    scalefac_compress=sc, scalefac_l=sfl[:21], **_WIDE)]])
    return encode_stream(frames, sr=22050, version="2", mode=3, bitrate=160)


def _lsf_short():
    rng = np.random.default_rng(8)
    frames = []
    for _ in range(3):
        flat = _lsf_scalefacs(rng, 181, block_type=2)
        frames.append([[GranuleSpec(spectrum=_rand_spec(rng, 5, 120), block_type=2,
                                    table_select=(9, 9, 9), global_gain=150,
                                    scalefac_compress=181,
                                    scalefac_s=[flat[i * 3:i * 3 + 3] for i in range(12)],
                                    subblock_gain=(0, 1, 0))]])
    return encode_stream(frames, sr=22050, version="2", mode=3, bitrate=160)


def _mpeg25_8k():
    rng = np.random.default_rng(9)
    frames = [[[GranuleSpec(spectrum=_rand_spec(rng, 5, 140), block_type=bt,
                            table_select=(9, 9, 9), region0_count=8, region1_count=7,
                            global_gain=150)]] for bt in (0, 1, 2, 3, 0)]
    return encode_stream(frames, sr=8000, version="2.5", mode=3, bitrate=64)


def _rate(sr, ver, br):
    rng = np.random.default_rng(sr)
    frames = []
    for _ in range(2):
        g0 = GranuleSpec(spectrum=_rand_spec(rng, 5, 120), global_gain=150, **_WIDE)
        if ver == "1":
            frames.append([[g0], [GranuleSpec(spectrum=_rand_spec(rng, 3, 80),
                                              table_select=(5, 5, 5), region0_count=8,
                                              region1_count=7, global_gain=148)]])
        else:
            frames.append([[g0]])
    return encode_stream(frames, sr=sr, version=ver, mode=3, bitrate=br)


def _count1_overrun(ext):
    rng = np.random.default_rng(6)
    frames = []
    for tail in ([1, 0, 1, 1], [1, 1, 0, 0], [1, 0, 1, 1, 0, 1, 0, 0]):
        row = []
        for _gr in range(2):
            left = GranuleSpec(spectrum=_rand_spec(rng, 5, 300), global_gain=150, **_WIDE)
            rs = np.zeros(576, np.int64)
            rs[0:48] = rng.integers(-3, 4, 48)
            rs[46] = rs[47] = 2
            rs[50:50 + len(tail)] = tail
            right = GranuleSpec(spectrum=rs, global_gain=150, scalefac_compress=15,
                                scalefac_l=[2 if b >= 10 else 0 for b in range(21)], **_WIDE)
            row.append([left, right])
        frames.append(row)
    return encode_stream(frames, sr=44100, version="1", mode=1, mode_ext=ext, bitrate=320)


def _xing():
    base = _simple_stream(nframes=2)
    xing = bytearray(base[:144 * 320000 // 44100])
    xing[21:25] = b"Xing"  # after the header and mono MPEG-1 side info
    return bytes(xing) + base


def _junk_resync():
    base = _simple_stream()
    fb = 144 * 320000 // 44100
    return base[:fb] + b"\x01\x02\x03" + base[fb:]


def _rate_change():
    zero = GranuleSpec(spectrum=np.zeros(576, np.int64))
    return _simple_stream() + encode_frame([[zero], [zero]], sr=48000, version="1", mode=3,
                                           bitrate=320)


LAYER3 = {
    "every_huffman_table": _every_table,
    "scfsi_preflag_scalefac_scale": _scfsi,
    "block_types_mpeg1": _block_types,
    "mixed_blocks": _mixed_blocks,
    "stereo_lr": lambda: encode_stream(_stereo_frames(np.random.default_rng(4)), sr=44100,
                                       version="1", mode=0, bitrate=320),
    "stereo_ms": lambda: encode_stream(_stereo_frames(np.random.default_rng(4)), sr=44100,
                                       version="1", mode=1, mode_ext=2, bitrate=320),
    "intensity": lambda: encode_stream(_intensity_frames(np.random.default_rng(5)), sr=44100,
                                       version="1", mode=1, mode_ext=1, bitrate=320),
    "intensity_ms": lambda: encode_stream(_intensity_frames(np.random.default_rng(5)),
                                          sr=44100, version="1", mode=1, mode_ext=3,
                                          bitrate=320),
    "count1_overrun_is": lambda: _count1_overrun(1),
    "count1_overrun_is_ms": lambda: _count1_overrun(3),
    "lsf_scalefac_classes": _lsf_classes,
    "lsf_short_blocks": _lsf_short,
    "mpeg25_8k_block_types": _mpeg25_8k,
    **{f"rate_{sr}": (lambda sr=sr, ver=ver, br=br: _rate(sr, ver, br))
       for sr, ver, br in ((48000, "1", 320), (32000, "1", 256), (24000, "2", 160),
                           (16000, "2", 96), (12000, "2.5", 64), (11025, "2.5", 64))},
    "id3_tag": lambda: b"ID3\x04\x00\x00\x00\x00\x00\x0a" + b"\x00" * 10 + _simple_stream(),
    "junk_between_frames": _junk_resync,
    "xing_first_frame": _xing,
    "free_format_layer3": lambda: to_free_format(_simple_stream(nframes=4)),
    # malformed
    "truncated_final_frame": lambda: _simple_stream(nframes=2)[:-100],
    "truncated_mid_side_info": lambda: _simple_stream(nframes=2)[:20],
    "no_decodable_frame": lambda: b"\x00" * 64,
    "bogus_layer2_header": lambda: bytes([0xFF, 0xE0 | (3 << 3) | (2 << 1) | 1, 0x90, 0xC0])
    + b"\x00" * 400,
    "mid_stream_rate_change": _rate_change,
    "all_ff": lambda: b"\xff" * 4096,
    "sync_spam": lambda: b"\xff\xfb" + b"\x00" * 4094,
    "random_bytes": lambda: bytes(np.random.default_rng(42).integers(0, 256, 4096,
                                                                     dtype=np.uint8)),
}


@pytest.mark.parametrize("name", sorted(LAYER3))
def test_layer3_matches_jax(name):
    same(LAYER3[name]())


def test_layer3_max_samples():
    data = _simple_stream(nframes=4)
    for cap in (1, 1152, 2000, 10**6):
        same(data, max_samples=cap)


# --------------------------------------------------------- Layers I and II


@pytest.mark.parametrize("profile", PROFILES, ids=lambda p: "-".join(map(str, p)))
def test_layers_1_2_profiles_match_jax(profile):
    layer, ver, sr, br, mode, mode_ext = profile
    rng = np.random.default_rng(PROFILES.index(profile))
    data = A.assemble_stream(rng, layer=layer, version=ver, sr=sr, bitrate=br, mode=mode,
                             mode_ext=mode_ext, nframes=5)
    out = same(data)
    assert out[0] == "ok" and out[1][1] == sr


def _padded(layer, br):
    rng = np.random.default_rng(3 + layer)
    build = A.assemble_l1_frame if layer == 1 else A.assemble_l2_frame
    return b"".join(build(rng, A.make_header(layer, "1", 44100, br, 3, padding=i % 2))
                    for i in range(6))


def _crc_frames(layer, br):
    hdr = A.make_header(layer, "1", 44100, br, 3, protection=True)
    build = A.assemble_l1_frame if layer == 1 else A.assemble_l2_frame
    return build(np.random.default_rng(6), hdr) * 4


def _forbidden_alloc():
    hdr = A.make_header(1, "1", 44100, 384, 3)
    w = A.BitWriter()
    w.write(15, 4)
    for _ in range(31):
        w.write(0, 4)
    return hdr + w.to_bytes(jmp3._FrameHeader(hdr).frame_bytes - 4)


def _free_cbr_change():
    rng = np.random.default_rng(14)
    cbr = A.assemble_stream(rng, layer=2, version="1", sr=44100, bitrate=128, mode=3, nframes=2)
    free = to_free_format(A.assemble_stream(rng, layer=2, version="1", sr=44100, bitrate=64,
                                            mode=3, nframes=4))
    return free + cbr


def _layer_change():
    rng = np.random.default_rng(9)
    return (A.assemble_stream(rng, layer=2, version="1", sr=44100, bitrate=192, mode=3, nframes=2)
            + A.assemble_stream(rng, layer=1, version="1", sr=44100, bitrate=192, mode=3,
                                nframes=2))


def _unmeasurable_free():
    hdr = A.make_header(2, "1", 44100, 128, 3)
    return bytes([hdr[0], hdr[1], hdr[2] & 0x0F, hdr[3]]) + b"\x00" * 2000


LAYERS12 = {
    **{f"density_{d}_layer{layer}": (lambda d=d, layer=layer: A.assemble_stream(
        np.random.default_rng(7 + layer), layer=layer, version="1", sr=44100,
        bitrate=384 if layer == 2 else 448, mode=0, nframes=3, density=d))
       for d in (0.0, 1.0) for layer in (1, 2)},
    "padded_layer1": lambda: _padded(1, 384),
    "padded_layer2": lambda: _padded(2, 192),
    "crc_protected_layer1": lambda: _crc_frames(1, 384),
    "crc_protected_layer2": lambda: _crc_frames(2, 192),
    **{f"free_format_l{layer}_{sr}": (lambda layer=layer, ver=ver, sr=sr, br=br, mode=mode:
                                      to_free_format(A.assemble_stream(
                                          np.random.default_rng(layer * 100 + sr % 97),
                                          layer=layer, version=ver, sr=sr, bitrate=br,
                                          mode=mode, nframes=5)))
       for layer, ver, sr, br, mode in ((2, "1", 44100, 128, 0), (2, "1", 48000, 112, 0),
                                        (1, "1", 44100, 384, 0), (2, "2", 22050, 64, 3))},
    "id3_tagged_layer1": lambda: b"ID3\x04\x00\x00\x00\x00\x00\x0a" + b"\x00" * 10
    + A.assemble_stream(np.random.default_rng(12), layer=1, version="1", sr=32000,
                        bitrate=256, mode=3, nframes=4),
    # malformed
    "free_format_unmeasurable": _unmeasurable_free,
    "free_then_cbr": _free_cbr_change,
    "forbidden_l1_allocation_15": _forbidden_alloc,
    "layer_change": _layer_change,
    **{f"mpeg25_layer{layer}": (lambda layer=layer: bytes(
        [0xFF, 0xE0 | ((4 - layer) << 1) | 1, 8 << 4, 3 << 6]) + b"\x00" * 400)
       for layer in (1, 2)},
    **{f"truncated_layer{layer}_{cut}": (lambda layer=layer, cut=cut: A.assemble_stream(
        np.random.default_rng(20 + layer), layer=layer, version="1", sr=44100, bitrate=192,
        mode=0, nframes=3)[:cut]) for layer in (1, 2) for cut in (3, 30, 700)},
}


@pytest.mark.parametrize("name", sorted(LAYERS12))
def test_layers_1_2_streams_match_jax(name):
    same(LAYERS12[name]())


def test_frame_header_parse_matches_jax():
    """The header parser on every version, layer and bitrate code."""
    for b1 in range(0xE0, 0x100):
        for b2 in range(0, 256, 5):
            hdr = bytes([0xFF, b1, b2, 0x40])
            assert_same(lambda h: vars(jmp3._FrameHeader(h)), lambda h: vars(tmp3._FrameHeader(h)),
                        hdr)


# ------------------------------------------------------------------ fuzz

_FUZZ_STREAMS = mp3_fuzz_streams()


@pytest.mark.parametrize("stream", [0, 3, 4, 6], ids=["mono_v1", "ms_v2", "l2_stereo",
                                                      "l2_free"])
def test_mpeg_fuzz_parity(stream):
    """tests/test_mp3_fuzz.py's base streams under hypothesis-drawn byte
    flips and truncations: the same outcome in both packages."""
    base = _FUZZ_STREAMS[stream]

    @FUZZ
    @given(mutations(len(base)))
    def check(m):
        assert_same(jmp3.decode_mp3, tmp3.decode_mp3, mutate(base, *m), max_samples=16000)

    check()
