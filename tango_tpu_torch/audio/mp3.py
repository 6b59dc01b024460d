"""MPEG audio decoder (Layers I, II and III), a copy of
tango_tpu/audio/mp3.py for the port.

The reference reads mp3 manifests through torchaudio
(tools/torch_tools.py:43-54); the port decodes them itself, in python and
numpy. This module decodes:

  * MPEG-1, MPEG-2 and MPEG-2.5 Layer III (all sample rates 8-48 kHz),
    CBR and VBR streams, mono/stereo/joint (MS + intensity) modes
  * ID3v2 prefix tags, optional frame CRCs (skipped), the bit reservoir
    (main_data_begin back-pointers), Xing/Info first-frame headers
  * long/short/mixed windows, all Huffman tables incl. ESC/linbits,
    count1 quads, scalefactor preemphasis, LSF scalefactor layout

  * MPEG-1/2 Layers I and II (subband PCM: all five allocation tables,
    grouped quantizers, scfsi reuse, joint-stereo bound sharing) — pinned
    against libmpg123 through a direct ctypes float oracle
    (tests/test_mpeg12.py) on in-repo-assembled streams

  * free-format streams (bitrate index 0, all layers): the constant frame
    size is measured from the sync spacing like mpg123 does, with a
    next-next-frame grid check against spurious payload syncs; Layer II
    free format selects allocation table 0 (mpg123's translate[..][0],
    behaviorally verified in tests/test_mpeg12.py)

Correctness evidence (tests/test_mp3.py, on the JAX package's copy; the
port's is held to it by tests/test_torch_decoders.py): output is pinned
against the INDEPENDENT system decoder (libmpg123) on real-world LSF files and on streams produced by the in-repo encoder
(tests/_mp3_encoder.py) that exercise the MPEG-1 paths, every Huffman
table, block type and stereo mode. Three implementation choices that the
ISO text leaves genuinely ambiguous were pinned EMPIRICALLY against
libmpg123 by linear regression (the polyphase output is linear in the
V-fifo, so the synthesis operator is recoverable from any real stream;
residual ~1e-9 = int16 quantization noise):

  * window-switching huffman region boundary: region1 starts at
    long_band[8] for block types 1/3 (36 samples at MPEG-1 rates,
    54 at 16-24 kHz LSF rates), and at sample 36 for short blocks;
  * short-block layout: after the ISO reorder each 18-line subband
    group is coefficient-major ((c, w) -> line c*3 + w), and the 12-IMDCT
    consumes it as spec[w][c] = group[c*3 + w];
  * the synthesis window: D[i] = s(i) * m(i) with m the INTWINBASE
    half-window (signs as stored) mirrored around tap 256 and s the
    (+,+,-,-) sign pattern repeating per 32-tap block.

Numerics: spectra requantize in f64; the IMDCT and polyphase synthesis run
as batched numpy matrix products over whole granules, so the python path
decodes faster than realtime; the training loader overlaps decode with
device compute via its prefetch thread either way.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from tango_tpu_torch.audio import mp3_tables as T


class Mp3Error(ValueError):
    pass


# ----------------------------------------------------------------- bit reader


class _Bits:
    """MSB-first bit reader over bytes (same scheme as audio/flac._Bits)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos_bits: int = 0):
        self.buf = buf
        self.pos = pos_bits

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        start = p >> 3
        end = (p + n + 7) >> 3
        if end > len(self.buf):
            raise Mp3Error("truncated mp3 stream")
        chunk = int.from_bytes(self.buf[start:end], "big")
        return (chunk >> (end * 8 - (p + n))) & ((1 << n) - 1)

    def bit(self) -> int:
        p = self.pos
        byte_i = p >> 3
        if byte_i >= len(self.buf):
            raise Mp3Error("truncated mp3 stream")
        self.pos = p + 1
        return (self.buf[byte_i] >> (7 - (p & 7))) & 1


# ------------------------------------------------------- header / frame walk


class _FrameHeader:
    __slots__ = ("version", "sample_rate", "bitrate", "padding", "mode",
                 "mode_ext", "protection", "frame_bytes", "lsf", "sr_index",
                 "layer")

    def __init__(self, b: bytes):
        if len(b) < 4 or b[0] != 0xFF or (b[1] & 0xE0) != 0xE0:
            raise Mp3Error("bad frame sync")
        ver_code = (b[1] >> 3) & 3
        layer_code = (b[1] >> 1) & 3
        if ver_code == 1:
            raise Mp3Error("reserved MPEG version")
        if layer_code == 0:
            raise Mp3Error("reserved MPEG layer")
        self.layer = 4 - layer_code  # header code 3/2/1 -> Layer I/II/III
        self.version = {0: "2.5", 2: "2", 3: "1"}[ver_code]
        self.lsf = self.version != "1"
        if self.version == "2.5" and self.layer != 3:
            # 11172/13818 define Layers I/II only at MPEG-1/2 rates; 2.5 is
            # the Layer III-only low-rate extension
            raise Mp3Error(f"MPEG-2.5 Layer {'I' * self.layer} does not exist")
        self.protection = (b[1] & 1) == 0  # 0 => 16-bit CRC follows header
        br_idx = (b[2] >> 4) & 0xF
        if br_idx == 0xF:
            raise Mp3Error("invalid bitrate index 15")
        brtab = {(1, False): T.BITRATES_V1_L1, (1, True): T.BITRATES_V2_L1,
                 (2, False): T.BITRATES_V1_L2, (2, True): T.BITRATES_V2_L2,
                 (3, False): T.BITRATES_V1_L3, (3, True): T.BITRATES_V2_L3}
        # index 0 = free format: constant frame size discovered by the
        # walker from the sync spacing (frame_bytes stays None here)
        self.bitrate = brtab[(self.layer, self.lsf)][br_idx] * 1000
        self.sr_index = (b[2] >> 2) & 3
        if self.sr_index == 3:
            raise Mp3Error("invalid sample rate index 3")
        self.sample_rate = T.SAMPLE_RATES[self.version][self.sr_index]
        self.padding = (b[2] >> 1) & 1
        self.mode = (b[3] >> 6) & 3  # 0 stereo, 1 joint, 2 dual, 3 mono
        self.mode_ext = (b[3] >> 4) & 3
        if self.bitrate == 0:
            self.frame_bytes = None  # free format: walker measures the size
        elif self.layer == 1:
            self.frame_bytes = (12 * self.bitrate // self.sample_rate
                                + self.padding) * 4
        else:
            coef = 144 if (self.layer == 2 or not self.lsf) else 72
            self.frame_bytes = coef * self.bitrate // self.sample_rate + self.padding

    @property
    def channels(self) -> int:
        return 1 if self.mode == 3 else 2

    @property
    def granules(self) -> int:
        return 1 if self.lsf else 2

    @property
    def ms_stereo(self) -> bool:
        return self.mode == 1 and bool(self.mode_ext & 2)

    @property
    def intensity_stereo(self) -> bool:
        return self.mode == 1 and bool(self.mode_ext & 1)


# ------------------------------------------------------------------ side info


class _Granule:
    __slots__ = ("part2_3_length", "big_values", "global_gain",
                 "scalefac_compress", "window_switching", "block_type",
                 "mixed_block", "table_select", "subblock_gain",
                 "region0_count", "region1_count", "preflag",
                 "scalefac_scale", "count1table_select",
                 # filled during decode:
                 "scalefac_l", "scalefac_s", "part2_bits")


def _read_side_info(bits: _Bits, h: _FrameHeader):
    nch = h.channels
    if not h.lsf:
        main_data_begin = bits.read(9)
        bits.read(5 if nch == 1 else 3)  # private bits
        scfsi = [[bits.bit() for _ in range(4)] for _ in range(nch)]
        ngr = 2
    else:
        main_data_begin = bits.read(8)
        bits.read(1 if nch == 1 else 2)
        scfsi = [[0, 0, 0, 0] for _ in range(nch)]
        ngr = 1

    granules = [[None] * nch for _ in range(ngr)]
    for gr in range(ngr):
        for ch in range(nch):
            g = _Granule()
            g.part2_3_length = bits.read(12)
            g.big_values = bits.read(9)
            if g.big_values > 288:
                raise Mp3Error(f"big_values {g.big_values} > 288")
            g.global_gain = bits.read(8)
            g.scalefac_compress = bits.read(9 if h.lsf else 4)
            g.window_switching = bits.bit()
            if g.window_switching:
                g.block_type = bits.read(2)
                if g.block_type == 0:
                    raise Mp3Error("block_type 0 with window switching")
                g.mixed_block = bits.bit()
                g.table_select = [bits.read(5), bits.read(5), 0]
                g.subblock_gain = [bits.read(3) for _ in range(3)]
                g.region0_count = 0  # implicit; see _decode_huffman
                g.region1_count = 0
            else:
                g.block_type = 0
                g.mixed_block = 0
                g.table_select = [bits.read(5) for _ in range(3)]
                g.subblock_gain = [0, 0, 0]
                g.region0_count = bits.read(4)
                g.region1_count = bits.read(3)
            if not h.lsf:
                g.preflag = bits.bit()
            else:
                g.preflag = 0  # derived from scalefac_compress during decode
            g.scalefac_scale = bits.bit()
            g.count1table_select = bits.bit()
            granules[gr][ch] = g
    return main_data_begin, scfsi, granules


# --------------------------------------------------------------- scalefactors


def _read_scalefactors_v1(bits: _Bits, g: _Granule, scfsi, prev: _Granule | None, gr: int):
    """MPEG-1 scalefactors (ISO 11172-3 2.4.2.7): slen1/2 split at band 11
    for long blocks (scfsi groups 0-5/6-10/11-15/16-20 reused from granule 0
    when the channel's scfsi bit is set), bands 0-5/6-11 for short."""
    start = bits.pos
    slen1 = T.SLEN1[g.scalefac_compress]
    slen2 = T.SLEN2[g.scalefac_compress]
    if g.block_type == 2:
        sfs = []
        nl = 0
        if g.mixed_block:
            nl = 8
        long_sf = [bits.read(slen1) for _ in range(nl)]
        first_short = 3 if g.mixed_block else 0
        for sfb in range(first_short, 12):
            slen = slen1 if sfb < 6 else slen2
            sfs.append([bits.read(slen) for _ in range(3)])
        g.scalefac_l = long_sf + [0] * (22 - len(long_sf))
        g.scalefac_s = ([[0, 0, 0]] * first_short) + sfs + [[0, 0, 0]]
    else:
        groups = ((0, 6, slen1), (6, 11, slen1), (11, 16, slen2), (16, 21, slen2))
        sf = [0] * 22
        for gi, (lo, hi, slen) in enumerate(groups):
            if gr == 1 and scfsi[gi]:
                for sfb in range(lo, hi):
                    sf[sfb] = prev.scalefac_l[sfb]
            else:
                for sfb in range(lo, hi):
                    sf[sfb] = bits.read(slen)
        g.scalefac_l = sf
        g.scalefac_s = [[0, 0, 0]] * 13
    g.part2_bits = bits.pos - start


def _lsf_slen_and_class(g: _Granule, is_intensity_ch: bool):
    """LSF scalefactor layout (ISO 13818-3 2.4.3.2): four bit-lengths + a
    row of NR_OF_SFB_BLOCK selected by the scalefac_compress range."""
    sc = g.scalefac_compress
    if not is_intensity_ch:
        if sc < 400:
            slen = ((sc >> 4) // 5, (sc >> 4) % 5, (sc >> 2) & 3, sc & 3)
            row = 0
        elif sc < 500:
            v = sc - 400
            slen = ((v >> 2) // 5, (v >> 2) % 5, v & 3, 0)
            row = 1
        else:
            v = sc - 500
            slen = (v // 3, v % 3, 0, 0)
            row = 2
            g.preflag = 1
    else:
        isc = sc >> 1
        if isc < 180:
            slen = (isc // 36, (isc % 36) // 6, isc % 6, 0)
            row = 3
        elif isc < 244:
            v = isc - 180
            slen = ((v >> 4) & 3, (v >> 2) & 3, v & 3, 0)
            row = 4
        else:
            v = isc - 244
            slen = (v // 3, v % 3, 0, 0)
            row = 5
    if g.block_type == 2:
        blk = 2 if g.mixed_block else 1
    else:
        blk = 0
    return slen, T.NR_OF_SFB_BLOCK[row][blk]


def _read_scalefactors_lsf(bits: _Bits, g: _Granule, is_intensity_ch: bool):
    start = bits.pos
    slen, nr = _lsf_slen_and_class(g, is_intensity_ch)
    raw = []
    for n, sl in zip(nr, slen):
        raw.extend(bits.read(sl) for _ in range(n))
    if g.block_type == 2:
        if g.mixed_block:
            # 6 long bands then short triplets from band 3
            g.scalefac_l = raw[:6] + [0] * 16
            rest = raw[6:]
            g.scalefac_s = [[0, 0, 0]] * 3 + [
                rest[i * 3:i * 3 + 3] for i in range(len(rest) // 3)
            ]
        else:
            g.scalefac_l = [0] * 22
            g.scalefac_s = [raw[i * 3:i * 3 + 3] for i in range(len(raw) // 3)]
        while len(g.scalefac_s) < 13:
            g.scalefac_s.append([0, 0, 0])
    else:
        g.scalefac_l = raw + [0] * (22 - len(raw))
        g.scalefac_s = [[0, 0, 0]] * 13
    g.part2_bits = bits.pos - start


# ------------------------------------------------------------- huffman decode


def _build_decoders():
    """code-string maps -> {(nbits, codeint): (x, y)} for bit-serial decode."""
    big = {}
    for tid, codes in T.HUFFMAN_CODES.items():
        big[tid] = {(len(c), int(c, 2)): xy for c, xy in codes.items()}
    quads = []
    for q in (T.QUAD_A, T.QUAD_B):
        quads.append({(len(c), int(c, 2)): v for c, v in q.items()})
    return big, quads


_BIG_DECODERS, _QUAD_DECODERS = _build_decoders()
_MAXLEN = {tid: max(n for n, _ in d) for tid, d in _BIG_DECODERS.items()}


def _huffman_symbol(bits: _Bits, dec, maxlen):
    acc = 0
    n = 0
    while n < maxlen:
        acc = (acc << 1) | bits.bit()
        n += 1
        hit = dec.get((n, acc))
        if hit is not None:
            return hit
    raise Mp3Error("invalid Huffman code")


def _decode_huffman(bits: _Bits, g: _Granule, h: _FrameHeader, end_pos: int):
    """Spectral integers is[576] + the count1 region extent."""
    sr = h.sample_rate
    long_band = T.SFB_LONG[sr]
    # region boundaries in samples; the window-switching split was pinned
    # empirically against libmpg123 (see module docstring): long_band[8]
    # for block types 1/3 (and the mixed-block long head), 36 for short
    if g.window_switching:
        if g.block_type == 2 and not g.mixed_block:
            region1_start = 36
        else:
            region1_start = long_band[8]
        region2_start = 576
    else:
        r0 = min(g.region0_count + 1, 22)
        r1 = min(g.region0_count + 1 + g.region1_count + 1, 22)
        region1_start = long_band[r0]
        region2_start = long_band[r1]

    is_ = [0] * 576
    pos = 0
    nbig = g.big_values * 2
    while pos < nbig:
        if pos < region1_start:
            tsel = g.table_select[0]
        elif pos < region2_start:
            tsel = g.table_select[1]
        else:
            tsel = g.table_select[2]
        if tsel in (0, 4, 14):
            if tsel != 0:
                raise Mp3Error(f"reserved Huffman table {tsel}")
            is_[pos] = 0
            is_[pos + 1] = 0
            pos += 2
            continue
        base = T.TABLE_ALIAS.get(tsel, tsel)
        linbits = T.LINBITS.get(tsel, 0)
        x, y = _huffman_symbol(bits, _BIG_DECODERS[base], _MAXLEN[base])
        if x == 15 and linbits:
            x += bits.read(linbits)
        if x and bits.bit():
            x = -x
        if y == 15 and linbits:
            y += bits.read(linbits)
        if y and bits.bit():
            y = -y
        is_[pos] = x
        is_[pos + 1] = y
        pos += 2

    # count1 region: quads until the granule's bit budget is exhausted
    qdec = _QUAD_DECODERS[g.count1table_select]
    qmax = 6 if g.count1table_select == 0 else 4
    while bits.pos < end_pos and pos <= 572:
        v, w, x, y = _huffman_symbol(bits, qdec, qmax)
        if v and bits.bit():
            v = -v
        if w and bits.bit():
            w = -w
        if x and bits.bit():
            x = -x
        if y and bits.bit():
            y = -y
        # the final quad may legitimately overrun the bit budget by design
        # (ISO: discard and stop); only commit when it fit
        if bits.pos > end_pos:
            break
        is_[pos] = v
        is_[pos + 1] = w
        is_[pos + 2] = x
        is_[pos + 3] = y
        pos += 4
    bits.pos = end_pos
    return np.asarray(is_, np.float64), pos


# ------------------------------------------------------------- requantization


def _band_spans_long(sr):
    b = T.SFB_LONG[sr]
    return [(b[i], b[i + 1]) for i in range(22)]


def _band_spans_short(sr):
    b = T.SFB_SHORT[sr]
    return [(b[i], b[i + 1]) for i in range(13)]


def _requantize(is_, g: _Granule, h: _FrameHeader):
    """|is|^(4/3) with global/subblock gain and scalefactor scaling
    (ISO 11172-3 2.4.3.4). Vectorized: build the per-line exponent then one
    power call."""
    sr = h.sample_rate
    xr_exp = np.zeros(576, np.float64)  # power-of-two exponent per line
    sf_mult = 0.5 * (1 + g.scalefac_scale)
    gg = g.global_gain - 210

    if g.block_type == 2:
        spans = _band_spans_short(sr)
        nlong = 0
        if g.mixed_block:
            nlong = T.SFB_LONG[sr][8 if not h.lsf else 6]
            for sfb, (lo, hi) in enumerate(_band_spans_long(sr)):
                if lo >= nlong:
                    break
                pre = T.PRETAB[sfb] if g.preflag else 0
                xr_exp[lo:hi] = 0.25 * gg - sf_mult * (g.scalefac_l[sfb] + pre)
        # short bands: lines are stored band-major window-interleaved per band
        # (w0 band, w1 band, w2 band, next band ...)
        first_short = 3 if g.mixed_block else 0
        pos_base = nlong
        for sfb in range(first_short, 13):
            lo, hi = spans[sfb]
            width = hi - lo
            for w in range(3):
                start = pos_base
                pos_base += width
                if start >= 576:
                    break
                e = (0.25 * (gg - 8 * g.subblock_gain[w])
                     - sf_mult * g.scalefac_s[min(sfb, len(g.scalefac_s) - 1)][w])
                xr_exp[start:start + width] = e
    else:
        for sfb, (lo, hi) in enumerate(_band_spans_long(sr)):
            pre = T.PRETAB[sfb] if g.preflag else 0
            xr_exp[lo:hi] = 0.25 * gg - sf_mult * (g.scalefac_l[sfb] + pre)

    xr = np.sign(is_) * np.abs(is_) ** (4.0 / 3.0) * np.exp2(xr_exp)
    return xr


# -------------------------------------------------------------------- stereo


def _stereo_process(xr, g_r: _Granule, h: _FrameHeader, nonzero_r: int):
    """MS and intensity stereo (ISO 2.4.3.4.9). xr: (2, 576) in-place.

    nonzero_r must be the right channel's last-nonzero-line extent (NOT the
    huffman positional extent): libmpg123 starts the intensity zone at the
    first scalefactor band at/after the last nonzero value, so trailing
    all-zero count1 quads do not push the zone out (pinned empirically,
    tests/test_mp3.py). With MS also enabled, intensity bands split the
    PRE-MS left value (equivalently sqrt(2) x the MS mid) — also pinned."""
    sr = h.sample_rate
    pre_left = xr[0].copy()
    if h.ms_stereo:
        m = xr[0].copy()
        s = xr[1].copy()
        inv = 1.0 / math.sqrt(2.0)
        xr[0] = (m + s) * inv
        xr[1] = (m - s) * inv
    if not h.intensity_stereo:
        return
    if h.ms_stereo:
        xr_src = pre_left
    else:
        xr_src = None  # band values read from xr[0] at apply time
    # intensity: bands at/above the right channel's rzero bound take the
    # left channel's magnitude split by is_pos (the right's scalefactor)
    if g_r.block_type == 2:
        spans = _band_spans_short(sr)
        widths = [hi - lo for lo, hi in spans]
        first_short = 3 if g_r.mixed_block else 0
        nlong = 0
        if g_r.mixed_block:
            nlong = T.SFB_LONG[sr][8 if not h.lsf else 6]
        pos = nlong
        for sfb in range(first_short, 13):
            width = widths[sfb]
            for w in range(3):
                start = pos
                pos += width
                if start < nonzero_r or start >= 576:
                    continue
                is_pos = g_r.scalefac_s[sfb][w]
                _apply_intensity(xr, start, min(start + width, 576), is_pos, h, g_r, xr_src)
        if g_r.mixed_block and nonzero_r < nlong:
            for sfb, (lo, hi) in enumerate(_band_spans_long(sr)):
                if lo >= nlong:
                    break
                if lo < nonzero_r:
                    continue
                _apply_intensity(xr, lo, hi, g_r.scalefac_l[sfb], h, g_r, xr_src)
    else:
        for sfb, (lo, hi) in enumerate(_band_spans_long(sr)):
            if lo < nonzero_r:
                continue
            _apply_intensity(xr, lo, min(hi, 576), g_r.scalefac_l[sfb], h, g_r, xr_src)


def _apply_intensity(xr, lo, hi, is_pos, h: _FrameHeader, g_r: _Granule,
                     xr_src=None):
    if not h.lsf:
        if is_pos == 7:
            return  # illegal position: leave the band as-is (MS result)
        t = math.tan(is_pos * math.pi / 12.0)
        l_ratio = t / (1.0 + t)
        r_ratio = 1.0 / (1.0 + t)
    else:
        # LSF intensity (13818-3): ratios are powers of 2^(-io*(is_pos+1)/2)
        if is_pos == 0:
            l_ratio, r_ratio = 1.0, 1.0
        else:
            io = 1 / math.sqrt(2.0) if (g_r.scalefac_compress & 1) else 0.5
            k = io ** ((is_pos + 1) // 2)
            if is_pos & 1:
                l_ratio, r_ratio = k, 1.0
            else:
                l_ratio, r_ratio = 1.0, k
    band = (xr_src[lo:hi] if xr_src is not None else xr[0, lo:hi]).copy()
    xr[0, lo:hi] = band * l_ratio
    xr[1, lo:hi] = band * r_ratio


# -------------------------------------------------------- reorder / antialias


def _reorder_short(xr, g: _Granule, h: _FrameHeader):
    """Short-block lines arrive band-major window-interleaved; the reorder
    makes each 3-window group coefficient-major: within a band of width W,
    dst[c*3 + w] = src[w*W + c] (pinned against libmpg123 — module
    docstring)."""
    sr = h.sample_rate
    spans = _band_spans_short(sr)
    out = xr.copy()
    nlong = 0
    first_short = 3 if g.mixed_block else 0
    if g.mixed_block:
        nlong = T.SFB_LONG[sr][8 if not h.lsf else 6]
    pos = nlong
    for sfb in range(first_short, 13):
        lo, hi = spans[sfb]
        width = hi - lo
        if pos + 3 * width > 576:
            width = max((576 - pos) // 3, 0)
        if width == 0:
            break
        block = xr[pos:pos + 3 * width].reshape(3, width)
        out[pos:pos + 3 * width] = block.T.reshape(-1)
        pos += 3 * width
    return out


_ALIAS_CS = np.array([1.0 / math.sqrt(1.0 + c * c) for c in T.ALIAS_C])
_ALIAS_CA = np.array([c / math.sqrt(1.0 + c * c) for c in T.ALIAS_C])


def _antialias(xr, g: _Granule):
    """Butterflies across subband boundaries (ISO 2.4.3.4.10.1). Applied to
    long blocks (and the long part of mixed blocks)."""
    if g.block_type == 2 and not g.mixed_block:
        return xr
    sblim = 2 if (g.block_type == 2 and g.mixed_block) else 32
    x = xr.reshape(32, 18)
    up = x[0:sblim - 1, 18 - 8:].copy()[:, ::-1]  # last 8 lines, reversed
    dn = x[1:sblim, :8].copy()
    x[0:sblim - 1, 10:] = (up * _ALIAS_CS - dn * _ALIAS_CA)[:, ::-1]
    x[1:sblim, :8] = dn * _ALIAS_CS + up * _ALIAS_CA
    return x.reshape(576)


# ------------------------------------------------------------ IMDCT + windows


def _imdct_matrices():
    n36 = np.zeros((36, 18))
    for i in range(36):
        for k in range(18):
            n36[i, k] = math.cos(math.pi / 72.0 * (2 * i + 1 + 18) * (2 * k + 1))
    n12 = np.zeros((12, 6))
    for i in range(12):
        for k in range(6):
            n12[i, k] = math.cos(math.pi / 24.0 * (2 * i + 1 + 6) * (2 * k + 1))
    win = np.zeros((4, 36))
    for i in range(36):
        win[0, i] = math.sin(math.pi / 36.0 * (i + 0.5))
    for i in range(18):
        win[1, i] = math.sin(math.pi / 36.0 * (i + 0.5))
    win[1, 18:24] = 1.0
    for i in range(24, 30):
        win[1, i] = math.sin(math.pi / 12.0 * (i - 18 + 0.5))
    # win[1, 30:] = 0
    for i in range(6, 12):
        win[3, i] = math.sin(math.pi / 12.0 * (i - 6 + 0.5))
    win[3, 12:18] = 1.0
    for i in range(18, 36):
        win[3, i] = math.sin(math.pi / 36.0 * (i + 0.5))
    win12 = np.array([math.sin(math.pi / 12.0 * (i + 0.5)) for i in range(12)])
    return n36, n12, win, win12


_N36, _N12, _WIN, _WIN12 = _imdct_matrices()
# windowed IMDCT banks: time = WN[bt] @ spec  per subband
_WN_LONG = {bt: _N36 * _WIN[bt][:, None] for bt in (0, 1, 3)}


def _imdct_granule(xr, g: _Granule, h: _FrameHeader, overlap):
    """576 spectral lines -> 32 subbands x 18 time samples, with 50%
    overlap-add state per subband (ISO 2.4.3.4.10.2-3)."""
    x = xr.reshape(32, 18)
    out = np.empty((32, 18))
    long_sb = 32
    if g.block_type == 2:
        long_sb = 2 if g.mixed_block else 0
    # long (or mixed-long) subbands in one matmul
    if long_sb:
        bt = g.block_type if g.block_type != 2 else 0
        wn = _WN_LONG[bt]
        raw = x[:long_sb] @ wn.T  # (sb, 36)
        out[:long_sb] = raw[:, :18] + overlap[:long_sb]
        overlap[:long_sb] = raw[:, 18:]
    if long_sb < 32:
        xs = x[long_sb:]  # (nsb, 18): coefficient-major (c, w) after reorder
        spec = xs.reshape(-1, 6, 3).transpose(0, 2, 1)  # (nsb, w, c)
        raw12 = spec @ _N12.T  # (nsb, 3, 12)
        raw12 = raw12 * _WIN12
        stacked = np.zeros((xs.shape[0], 36))
        for w in range(3):
            stacked[:, 6 + 6 * w:18 + 6 * w] += raw12[:, w]
        out[long_sb:] = stacked[:, :18] + overlap[long_sb:]
        overlap[long_sb:] = stacked[:, 18:]
    # frequency inversion: odd subbands negate odd time samples
    out[1::2, 1::2] *= -1.0
    return out


# --------------------------------------------------------- synthesis filterbank


def _synthesis_matrices():
    n = np.zeros((64, 32))
    for i in range(64):
        for k in range(32):
            n[i, k] = math.cos((16 + i) * (2 * k + 1) * math.pi / 64.0)
    # D[i] = s(i) * m(i): m = INTWINBASE (signed, ISO Table 3-B.3 halved
    # window x 65536) mirrored around tap 256; s = (+,+,-,-) per 32-tap
    # block. Recovered exactly from libmpg123 output by linear regression
    # (residual ~2e-9); see the module docstring.
    half = np.asarray(T.INTWINBASE, np.float64) / 65536.0
    mirror = np.concatenate([half[:257], half[255:0:-1]])
    blocksign = np.where((np.arange(512) // 32) % 4 < 2, 1.0, -1.0)
    return n, mirror * blocksign


_SYN_N, _SYN_D = _synthesis_matrices()
_IE = 15 - 2 * np.arange(8)  # even-block fifo offsets (see _Synth.run)


class _Synth:
    """Per-channel polyphase synthesis (ISO 11172-3 Annex A, Figure A.2),
    vectorized over a whole granule: V history rows -> U gather -> windowed
    sum. State is the 15 newest V rows (newest first)."""

    __slots__ = ("vhist",)

    def __init__(self):
        self.vhist = np.zeros((15, 64))

    def run(self, sb_samples):
        """sb_samples (nt, 32) -> nt*32 PCM samples."""
        nt = sb_samples.shape[0]
        vg = sb_samples @ _SYN_N.T  # (nt, 64)
        # rows oldest..newest; v[t] lives at full[15 + t]
        full = np.concatenate([self.vhist[::-1], vg], axis=0)
        tt = np.arange(nt)[:, None]
        ie = tt + _IE[None, :]  # (nt, 8): fifo rows t, t-2, ... t-14
        u = np.empty((nt, 8, 2, 32))
        u[:, :, 0, :] = full[ie, :32]
        u[:, :, 1, :] = full[ie - 1, 32:]
        w = u.reshape(nt, 512) * _SYN_D
        out = w.reshape(nt, 16, 32).sum(axis=1)
        self.vhist = full[:-16:-1]  # newest 15 rows, newest first
        return out.reshape(-1)


# ----------------------------------------------------- Layers I and II
# (11172-3 2.4.2.1-2.4.3.3 + the 13818-3 LSF Layer II table). Subband codes
# requantize as s'' = C * (s''' + D) with s''' the codeword after MSB
# inversion read as a two's-complement fraction; scaled samples feed the
# same polyphase synthesis as Layer III.


def _l2_table_select(h: "_FrameHeader") -> int:
    """Which of the five allocation tables a Layer II frame uses (the dist10
    pick_table rule on bitrate-per-channel + rate; LSF always table 4)."""
    if h.lsf:
        return 4
    if h.bitrate == 0:
        return 0  # free format: mpg123's translate[][][0] (verified by test)
    bpc = h.bitrate // 1000 // h.channels
    if (h.sample_rate == 48000 and bpc >= 56) or (56 <= bpc <= 80):
        return 0
    if h.sample_rate != 48000 and bpc >= 96:
        return 1
    if h.sample_rate != 32000 and bpc <= 48:
        return 2
    return 3


def _dequant_l12(code: int, steps: int) -> float:
    """s'' = (2c - steps + 1) / steps — the uniform requantization map (see
    mp3_tables.L2_QUANT for why this, not a literal C/D table read)."""
    return (2 * code - steps + 1) / steps


def _read_l2_frame(frame: bytes, h: "_FrameHeader") -> np.ndarray:
    """-> (nch, 36, 32) scaled subband samples."""
    nch = h.channels
    bits = _Bits(frame, (4 + (2 if h.protection else 0)) * 8)
    table = T.L2_ALLOC_TABLES[_l2_table_select(h)]
    sblimit = len(table)
    joint = h.mode == 1
    bound = min((h.mode_ext + 1) * 4, sblimit) if joint else sblimit

    alloc = [[0] * sblimit for _ in range(nch)]
    for sb in range(sblimit):
        nbal = (len(table[sb]) + 1).bit_length() - 1
        if sb >= bound:
            a = bits.read(nbal)
            for ch in range(nch):
                alloc[ch][sb] = a
        else:
            for ch in range(nch):
                alloc[ch][sb] = bits.read(nbal)

    scfsi = [[0] * sblimit for _ in range(nch)]
    for sb in range(sblimit):
        for ch in range(nch):
            if alloc[ch][sb]:
                scfsi[ch][sb] = bits.read(2)

    SF = T.L12_SCALEFACTORS
    sf = [[(0.0, 0.0, 0.0)] * sblimit for _ in range(nch)]
    for sb in range(sblimit):
        for ch in range(nch):
            if not alloc[ch][sb]:
                continue
            pat = scfsi[ch][sb]
            if pat == 0:
                t = (SF[bits.read(6)], SF[bits.read(6)], SF[bits.read(6)])
            elif pat == 1:
                a, b = SF[bits.read(6)], SF[bits.read(6)]
                t = (a, a, b)
            elif pat == 2:
                a = SF[bits.read(6)]
                t = (a, a, a)
            else:
                a, b = SF[bits.read(6)], SF[bits.read(6)]
                t = (a, b, b)
            sf[ch][sb] = t

    out = np.zeros((nch, 36, 32))
    for gr in range(12):
        part = gr >> 2
        t0 = gr * 3
        for sb in range(sblimit):
            shared = sb >= bound
            for ch in range(nch):
                if shared and ch == 1:
                    continue  # decoded with ch 0 below
                a = alloc[ch][sb]
                if not a:
                    continue
                steps = table[sb][a - 1]
                nb, grouped = T.L2_QUANT[steps]
                if grouped:
                    c = bits.read(nb)
                    if c >= steps ** 3:
                        # undefined codeword: libmpg123 indexes past its
                        # degroup table (UB) — refuse loudly instead
                        raise Mp3Error(
                            f"Layer II grouped code {c} >= {steps}^3")
                    codes = (c % steps, (c // steps) % steps,
                             c // (steps * steps))
                else:
                    codes = (bits.read(nb), bits.read(nb), bits.read(nb))
                vals = [_dequant_l12(c, steps) for c in codes]
                chans = range(nch) if shared else (ch,)
                for ch2 in chans:
                    s = sf[ch2][sb][part]
                    out[ch2, t0, sb] = s * vals[0]
                    out[ch2, t0 + 1, sb] = s * vals[1]
                    out[ch2, t0 + 2, sb] = s * vals[2]
    return out


def _read_l1_frame(frame: bytes, h: "_FrameHeader") -> np.ndarray:
    """-> (nch, 12, 32) scaled subband samples."""
    nch = h.channels
    bits = _Bits(frame, (4 + (2 if h.protection else 0)) * 8)
    joint = h.mode == 1
    bound = min((h.mode_ext + 1) * 4, 32) if joint else 32

    alloc = [[0] * 32 for _ in range(nch)]
    for sb in range(32):
        if sb >= bound:
            a = bits.read(4)
            alloc[0][sb] = alloc[1][sb] = a
        else:
            for ch in range(nch):
                alloc[ch][sb] = bits.read(4)
    for ch in range(nch):
        if 15 in alloc[ch]:
            raise Mp3Error("forbidden Layer I allocation 15")

    SF = T.L12_SCALEFACTORS
    sf = [[0.0] * 32 for _ in range(nch)]
    for sb in range(32):
        for ch in range(nch):
            if alloc[ch][sb]:
                sf[ch][sb] = SF[bits.read(6)]

    out = np.zeros((nch, 12, 32))
    for s in range(12):
        for sb in range(32):
            for ch in range(nch):
                if sb >= bound and ch == 1:
                    continue
                a = alloc[ch][sb]
                if not a:
                    continue
                nb = a + 1
                code = bits.read(nb)
                v = _dequant_l12(code, (1 << nb) - 1)
                if sb >= bound:
                    out[0, s, sb] = sf[0][sb] * v
                    if nch == 2:
                        out[1, s, sb] = sf[1][sb] * v
                else:
                    out[ch, s, sb] = sf[ch][sb] * v
    return out


class _L12State:
    """Layer I/II decoder state: just the per-channel synthesis FIFOs (no
    bit reservoir, no IMDCT overlap)."""

    def __init__(self, nch):
        self.nch = nch
        self.synth = [_Synth() for _ in range(nch)]

    def decode_frame(self, frame: bytes, h: "_FrameHeader"):
        sb = (_read_l1_frame if h.layer == 1 else _read_l2_frame)(frame, h)
        nt = sb.shape[1]
        pcm = np.empty((nt * 32, self.nch))
        for ch in range(self.nch):
            pcm[:, ch] = self.synth[ch].run(sb[ch])
        return pcm


# ------------------------------------------------------------------ top level


def _skip_id3(data: bytes, pos: int) -> int:
    if data[pos:pos + 3] == b"ID3":
        if len(data) < pos + 10:
            raise Mp3Error("truncated ID3 header")
        size = (((data[pos + 6] & 0x7F) << 21) | ((data[pos + 7] & 0x7F) << 14)
                | ((data[pos + 8] & 0x7F) << 7) | (data[pos + 9] & 0x7F))
        if data[pos + 5] & 0x10:
            size += 10
        pos += 10 + size
    return pos


_FREE_FORMAT_MAX = 4096  # > mpg123's MAXFRAMESIZE (3456): generous cap


def _measure_free_format(data: bytes, pos: int, h: _FrameHeader) -> int:
    """Free format (bitrate index 0, 11172-3 2.4.2.3): the frame size is
    constant but not derivable from the header — measure the spacing to the
    next matching sync, verifying one further frame lands on that grid so a
    spurious 0xFF pattern inside the payload can't masquerade as the size."""
    slot = 4 if h.layer == 1 else 1

    def matches(q: int):
        if q + 4 > len(data) or data[q] != 0xFF:
            return None
        try:
            h2 = _FrameHeader(data[q:q + 4])
        except Mp3Error:
            return None
        ok = (h2.bitrate == 0 and h2.layer == h.layer
              and h2.version == h.version and h2.sr_index == h.sr_index
              and h2.channels == h.channels)
        return h2 if ok else None

    q = pos + 4
    while q < min(pos + _FREE_FORMAT_MAX, len(data) - 4):
        h2 = matches(q)
        if h2 is not None:
            base = q - pos - h.padding * slot
            # verify: the frame after q starts on the same grid (or the
            # stream ends inside/at it)
            q2 = q + base + h2.padding * slot
            if q2 + 4 > len(data) or matches(q2) is not None:
                return base
        q += 1
    raise Mp3Error("free-format stream: could not measure the frame size "
                   f"(no matching sync within {_FREE_FORMAT_MAX} bytes)")


def _is_xing_frame(frame: bytes, h: _FrameHeader) -> bool:
    """Xing/Info VBR headers occupy the first frame's payload; real decoders
    skip that frame's audio (it decodes to silence anyway, but skipping keeps
    sample alignment with mpg123 output)."""
    off = 4 + (2 if h.protection else 0)
    if not h.lsf:
        off += 17 if h.channels == 1 else 32
    else:
        off += 9 if h.channels == 1 else 17
    tag = frame[off:off + 4]
    return tag in (b"Xing", b"Info") or frame[4 + (2 if h.protection else 0):].startswith(b"VBRI")


def decode_mp3(data: bytes, max_samples: int | None = None) -> Tuple[np.ndarray, int]:
    """mp3 bytes -> (float32 (n, channels) in [-1, 1], sample_rate)."""
    pos = _skip_id3(data, 0)
    state = None
    sr = None
    nch = None
    layer = None
    free_base = None   # free-format frame size sans padding slot
    free_first = False
    first_audio_frame = True
    out_chunks = []

    while pos + 4 <= len(data):
        # resync: tolerate junk between frames (tag padding etc.)
        if not (data[pos] == 0xFF and (data[pos + 1] & 0xE0) == 0xE0):
            nxt = data.find(b"\xff", pos + 1)
            if nxt == -1:
                break
            pos = nxt
            continue
        try:
            h = _FrameHeader(data[pos:pos + 4])
        except Mp3Error:
            pos += 1
            continue
        if h.frame_bytes is None:  # free format: measure the sync spacing
            if free_base is None:
                free_base = _measure_free_format(data, pos, h)
            slot = 4 if h.layer == 1 else 1
            h.frame_bytes = free_base + h.padding * slot
        if pos + h.frame_bytes > len(data):
            break  # truncated final frame: stop cleanly
        frame = data[pos:pos + h.frame_bytes]
        pos += h.frame_bytes

        if sr is None:
            sr, nch, layer = h.sample_rate, h.channels, h.layer
            free_first = h.bitrate == 0
        elif h.sample_rate != sr or h.channels != nch or h.layer != layer:
            raise Mp3Error("mid-stream sample-rate/channel/layer change")
        elif (h.bitrate == 0) != free_first:
            raise Mp3Error("mid-stream free-format/CBR change")

        if first_audio_frame and h.layer == 3 and _is_xing_frame(frame, h):
            first_audio_frame = False
            continue
        first_audio_frame = False

        if state is None:
            state = _DecoderState(nch) if layer == 3 else _L12State(nch)

        pcm = state.decode_frame(frame, h)
        if pcm is not None:
            out_chunks.append(pcm)
            if max_samples is not None and sum(c.shape[0] for c in out_chunks) >= max_samples:
                break

    if sr is None or not out_chunks:
        raise Mp3Error("no decodable mp3 frames found")
    pcm = np.concatenate(out_chunks, axis=0)
    if max_samples is not None:
        pcm = pcm[:max_samples]
    return pcm.astype(np.float32), sr


class _DecoderState:
    def __init__(self, nch):
        self.nch = nch
        self.reservoir = b""
        self.overlap = [np.zeros((32, 18)) for _ in range(nch)]
        self.synth = [_Synth() for _ in range(nch)]

    def decode_frame(self, frame: bytes, h: _FrameHeader):
        nch = self.nch
        off = 4 + (2 if h.protection else 0)
        if not h.lsf:
            side_len = 17 if nch == 1 else 32
        else:
            side_len = 9 if nch == 1 else 17
        side = frame[off:off + side_len]
        if len(side) < side_len:
            raise Mp3Error("truncated side info")
        bits = _Bits(side)
        main_data_begin, scfsi, granules = _read_side_info(bits, h)

        main = frame[off + side_len:]
        if main_data_begin > len(self.reservoir):
            # reference decoders mute frames whose reservoir back-pointer
            # reaches data we never saw (stream started mid-reservoir)
            self.reservoir = (self.reservoir + main)[-511:]
            return None
        buf = (self.reservoir[len(self.reservoir) - main_data_begin:]
               if main_data_begin else b"") + main
        self.reservoir = (self.reservoir + main)[-511:]

        mb = _Bits(buf)
        ngr = h.granules
        pcm = np.empty((576 * ngr, nch))
        for gr in range(ngr):
            xr_ch = np.zeros((nch, 576))
            nonzero = [576] * nch
            for ch in range(nch):
                g = granules[gr][ch]
                start_pos = mb.pos
                if not h.lsf:
                    _read_scalefactors_v1(mb, g, scfsi[ch],
                                          granules[0][ch] if gr else None, gr)
                else:
                    is_int = h.intensity_stereo and ch == 1
                    _read_scalefactors_lsf(mb, g, is_int)
                end_pos = start_pos + g.part2_3_length
                if g.part2_bits > g.part2_3_length:
                    raise Mp3Error("scalefactors exceed part2_3_length")
                is_, _pos = _decode_huffman(mb, g, h, end_pos)
                # intensity zone bound = last NONZERO line, not the huffman
                # positional extent (trailing all-zero count1 quads do not
                # count) — pinned against libmpg123 in tests/test_mp3.py
                nzi = np.nonzero(is_)[0]
                nonzero[ch] = int(nzi[-1]) + 1 if len(nzi) else 0
                xr_ch[ch] = _requantize(is_, g, h)
            if nch == 2:
                _stereo_process(xr_ch, granules[gr][1], h, nonzero[1])
            for ch in range(nch):
                g = granules[gr][ch]
                xr = xr_ch[ch]
                if g.block_type == 2:
                    xr = _reorder_short(xr, g, h)
                xr = _antialias(xr.copy(), g)
                sb = _imdct_granule(xr, g, h, self.overlap[ch])  # (32, 18)
                pcm[gr * 576:(gr + 1) * 576, ch] = self.synth[ch].run(sb.T)
        return pcm


def read_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Read an mp3 file -> (float32 (n,) or (n, ch) in [-1, 1], sr) —
    read_wav's output contract (see audio/wav.read_wav)."""
    with open(path, "rb") as f:
        data = f.read()
    pcm, sr = decode_mp3(data)
    if pcm.shape[1] == 1:
        pcm = pcm[:, 0]
    return pcm, sr
