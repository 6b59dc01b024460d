"""Ogg Vorbis I decoder in python and numpy, a copy of
tango_tpu/audio/vorbis.py for the port.

The reference reads ogg manifests through torchaudio
(tools/torch_tools.py:43-54); the port decodes them itself. This module
decodes the complete Vorbis I setup + audio machinery as produced by every
libvorbis-era encoder:

  * Ogg page/packet layer: lacing, continued packets, CRC verification,
    multiplexed-stream demux (first Vorbis BOS stream wins), granule-based
    end trimming
  * all three header packets incl. full codebook parsing (ordered/sparse
    length lists, canonical Huffman assignment, lookup type 1/2 VQ lattices)
  * floor type 1 (posts, integer render_line curve, inverse-dB amplitude)
    and the deprecated floor type 0 (LSP bark-map curve)
  * residue types 0, 1, 2 (cascade passes, classword partitions)
  * square-polar channel coupling, long/short/hybrid window overlap-add
    with the exact spec lapping rules, end-of-packet partial-decode
    semantics

Correctness evidence (tests/test_vorbis.py, on the JAX package's copy;
the port's is held to it by tests/test_torch_decoders.py): PCM is pinned
against the INDEPENDENT system decoder (libvorbisfile via ctypes — the
canonical Xiph implementation) on streams produced by libvorbisenc across
rates, channel counts and quality levels (changing codebook/floor/residue
configurations); agreement is bounded by the oracle's int16 output
quantization. tests/test_vorbis_fuzz.py runs a differential mutation fuzz
against the same oracle.

Numerics: floors/residues follow the spec's exact integer algorithms; the
IMDCT runs as cached cos-matrix products in float32 per blocksize (64..8192
are legal; real streams use 256/2048), so decode is numpy-batched per block.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


class VorbisError(ValueError):
    pass


class _EndOfPacket(Exception):
    pass


# ------------------------------------------------------------------ ogg layer

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tab = np.zeros(256, np.uint32)
        for i in range(256):
            r = i << 24
            for _ in range(8):
                r = ((r << 1) ^ 0x04C11DB7) if (r & 0x80000000) else (r << 1)
                r &= 0xFFFFFFFF
            tab[i] = r
        _CRC_TABLE = tab
    return _CRC_TABLE


def _ogg_crc(data: bytes) -> int:
    # non-reflected CRC-32/OGG: poly 0x04c11db7, init 0, no final xor
    tab = _crc_table()
    r = np.uint32(0)
    arr = np.frombuffer(data, np.uint8)
    r = 0
    for b in arr:
        r = ((r << 8) & 0xFFFFFFFF) ^ int(tab[((r >> 24) & 0xFF) ^ int(b)])
    return r


def _ogg_packets(data: bytes, start: int = 0, bos_magic: bytes = b"\x01vorbis",
                 err_cls: type = None):
    """Parse one Ogg chain link -> (packets, total_granule, end_pos).

    Follows the FIRST logical stream whose BOS packet begins with
    `bos_magic` ('\\x01vorbis' by default; audio/opus.py reuses this layer
    with b'OpusHead' — grouped/multiplexed files carry other codecs on other
    serials); raises `err_cls` (VorbisError by default) on structural
    corruption (bad capture, bad CRC, bad version) rather than resyncing.
    `end_pos` is the byte offset past this link's EOS page, where a chained
    file's next link begins (libvorbisfile decodes chains as consecutive
    links — decode_vorbis mirrors that).
    """
    VorbisError = err_cls or globals()["VorbisError"]
    packets: List[bytes] = []
    pos = start
    serial = None
    partial = b""
    continued_open = False
    total_granule = -1
    n = len(data)
    while pos < n:
        if data[pos : pos + 4] != b"OggS":
            raise VorbisError(f"bad ogg capture pattern at byte {pos}")
        if pos + 27 > n:
            raise VorbisError("truncated ogg page header")
        hdr = data[pos : pos + 27]
        if hdr[4] != 0:
            raise VorbisError(f"unsupported ogg version {hdr[4]}")
        htype = hdr[5]
        granule = int.from_bytes(hdr[6:14], "little", signed=True)
        pserial = int.from_bytes(hdr[14:18], "little")
        crc = int.from_bytes(hdr[22:26], "little")
        nsegs = hdr[26]
        seg_table = data[pos + 27 : pos + 27 + nsegs]
        if len(seg_table) < nsegs:
            raise VorbisError("truncated ogg segment table")
        body_len = sum(seg_table)
        body = data[pos + 27 + nsegs : pos + 27 + nsegs + body_len]
        if len(body) < body_len:
            raise VorbisError("truncated ogg page body")
        page = bytearray(data[pos : pos + 27 + nsegs + body_len])
        page[22:26] = b"\x00\x00\x00\x00"
        if _ogg_crc(bytes(page)) != crc:
            raise VorbisError(f"ogg page CRC mismatch at byte {pos}")
        pos += 27 + nsegs + body_len

        if serial is None:
            if not (htype & 0x02):
                raise VorbisError("first ogg page is not a stream start")
            # only follow the requested codec's stream; skip other BOS pages
            if body[: len(bos_magic)] != bos_magic:
                continue
            serial = pserial
        elif pserial != serial:
            continue  # interleaved other-stream page

        if (htype & 0x01) and not continued_open:
            # continuation of a packet we never started (e.g. stream joined
            # mid-way); the spec says discard the continued fragment
            raise VorbisError("ogg continuation without an open packet")
        if not (htype & 0x01) and continued_open:
            raise VorbisError("open packet not continued on next page")

        off = 0
        for i, seg in enumerate(seg_table):
            partial += body[off : off + seg]
            off += seg
            if seg < 255:
                packets.append(partial)
                partial = b""
        if nsegs > 0:  # a zero-packet page leaves any open packet open
            continued_open = seg_table[-1] == 255
        if granule >= 0:
            total_granule = granule
        if htype & 0x04:  # eos page of our stream ends this chain link
            break
    return packets, total_granule, pos


# ------------------------------------------------------------------ bitreader


class _Bits:
    """LSB-first bit reader over one packet (Vorbis I spec section 2)."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = len(data) * 8

    def read(self, k: int) -> int:
        p = self.pos
        if p + k > self.nbits:
            raise _EndOfPacket()
        if k == 0:
            return 0
        b0 = p >> 3
        v = int.from_bytes(self.data[b0 : (p + k + 7) >> 3], "little") >> (p & 7)
        self.pos = p + k
        return v & ((1 << k) - 1)

    def remaining(self) -> int:
        return self.nbits - self.pos


def _ilog(x: int) -> int:
    return x.bit_length() if x > 0 else 0


def _float32_unpack(x: int) -> float:
    mantissa = x & 0x1FFFFF
    exp = (x & 0x7FE00000) >> 21
    if x & 0x80000000:
        mantissa = -mantissa
    return float(mantissa) * (2.0 ** (exp - 788))


def _lookup1_values(entries: int, dims: int) -> int:
    r = int(math.floor(entries ** (1.0 / dims)))
    # guard fp error on the integer root
    while (r + 1) ** dims <= entries:
        r += 1
    while r > 0 and r**dims > entries:
        r -= 1
    return r


# ------------------------------------------------------------------ codebooks

_FAST_BITS = 10


class _Codebook:
    def __init__(self, bits: _Bits):
        if bits.read(24) != 0x564342:
            raise VorbisError("codebook sync lost")
        self.dims = bits.read(16)
        self.entries = bits.read(24)
        if self.entries > (1 << 22):
            # the 24-bit field allows 16M entries; real codebooks are a few
            # thousand. Bound the python-side assignment work loudly.
            raise VorbisError("codebook entry count too large")
        lengths = [-1] * self.entries  # -1 = unused
        if bits.read(1):  # ordered
            cur_len = bits.read(5) + 1
            cur = 0
            while cur < self.entries:
                num = bits.read(_ilog(self.entries - cur))
                if cur + num > self.entries:
                    raise VorbisError("ordered codebook overruns entries")
                for i in range(cur, cur + num):
                    lengths[i] = cur_len
                cur += num
                cur_len += 1
                if cur_len > 32:
                    raise VorbisError("codeword length > 32")
        else:
            sparse = bits.read(1)
            for i in range(self.entries):
                if sparse:
                    if bits.read(1):
                        lengths[i] = bits.read(5) + 1
                else:
                    lengths[i] = bits.read(5) + 1
        self.lengths = lengths
        self._assign_codewords()

        self.lookup_type = bits.read(4)
        self.vectors: Optional[np.ndarray] = None
        if self.lookup_type in (1, 2):
            if self.dims <= 0:
                raise VorbisError("VQ codebook with zero dimensions")
            if self.entries * self.dims > (1 << 26):
                # spec-legal but physically absurd (real books are a few
                # thousand entries x <=8 dims); bound fuzz-crafted setups
                raise VorbisError("codebook lookup table too large")
            min_v = _float32_unpack(bits.read(32))
            delta = _float32_unpack(bits.read(32))
            value_bits = bits.read(4) + 1
            sequence_p = bits.read(1)
            if self.lookup_type == 1:
                count = _lookup1_values(self.entries, self.dims)
                n_mult = count
            else:
                n_mult = self.entries * self.dims
            mult = np.array([bits.read(value_bits) for _ in range(n_mult)],
                            np.float64)
            vec = np.zeros((self.entries, self.dims), np.float64)
            if self.lookup_type == 1:
                if count <= 0 and self.entries > 0:
                    raise VorbisError("lookup1 with zero lattice values")
                idx = np.arange(self.entries)[:, None]
                divs = count ** np.arange(self.dims)[None, :]
                offs = (idx // divs) % max(count, 1)
                vec = mult[offs] * delta + min_v
            else:
                vec = mult.reshape(self.entries, self.dims) * delta + min_v
            if sequence_p:
                vec = np.cumsum(vec, axis=1)
            self.vectors = vec.astype(np.float64)
        elif self.lookup_type != 0:
            raise VorbisError(f"reserved codebook lookup type {self.lookup_type}")

    # canonical codeword assignment (spec 3.2.1); codes kept MSB-aligned in
    # 32 bits like the reference tree-walk, then bit-reversed for the
    # LSB-first fast table
    def _assign_codewords(self):
        used = [i for i, l in enumerate(self.lengths) if l > 0]
        self.single_entry = None
        self.empty = not used
        fast = [None] * (1 << _FAST_BITS)
        slow: Dict[Tuple[int, int], int] = {}
        self.maxlen = 0
        if not used:
            # an empty codebook is legal at setup; using it to decode errors
            self.fast = fast
            self.slow = slow
            return
        if len(used) == 1:
            # single-entry codebook: decoding reads one bit and returns the
            # entry regardless (the tree has one leaf; libvorbis consumes a
            # single bit per decode for this degenerate case)
            self.single_entry = used[0]
            self.fast = fast
            self.slow = slow
            self.maxlen = 1
            return
        available = [0] * 33
        first = used[0]
        l0 = self.lengths[first]
        self._add_code(fast, slow, 0, l0, first)
        self.maxlen = max(self.maxlen, l0)
        for i in range(1, l0 + 1):
            available[i] = 1 << (32 - i)
        for e in used[1:]:
            ln = self.lengths[e]
            z = ln
            while z > 0 and available[z] == 0:
                z -= 1
            if z == 0:
                raise VorbisError("over-specified huffman tree")
            res = available[z]
            available[z] = 0
            self._add_code(fast, slow, res, ln, e)
            self.maxlen = max(self.maxlen, ln)
            if z != ln:
                for y in range(ln, z, -1):
                    if available[y] != 0:
                        raise VorbisError("huffman assignment inconsistency")
                    available[y] = res + (1 << (32 - y))
        if any(a != 0 for a in available):
            raise VorbisError("under-specified huffman tree")
        self.fast = fast
        self.slow = slow

    @staticmethod
    def _rev(v: int, nbits: int) -> int:
        r = 0
        for _ in range(nbits):
            r = (r << 1) | (v & 1)
            v >>= 1
        return r

    def _add_code(self, fast, slow, msb32: int, ln: int, entry: int):
        code = msb32 >> (32 - ln)  # MSB-first codeword of length ln
        rev = self._rev(code, ln)  # LSB-first as read from the stream
        if ln <= _FAST_BITS:
            step = 1 << ln
            for f in range(rev, 1 << _FAST_BITS, step):
                fast[f] = (entry, ln)
        else:
            slow[(ln, code)] = entry

    def decode(self, bits: _Bits) -> int:
        """Huffman-decode one entry number."""
        if self.single_entry is not None:
            bits.read(1)
            return self.single_entry
        if self.empty:
            raise VorbisError("decode from an empty codebook")
        rem = bits.remaining()
        if rem >= _FAST_BITS:
            p = bits.pos
            b0 = p >> 3
            w = int.from_bytes(
                bits.data[b0 : (p + _FAST_BITS + 7) >> 3], "little"
            ) >> (p & 7)
            ent = self.fast[w & ((1 << _FAST_BITS) - 1)]
            if ent is not None:
                bits.pos = p + ent[1]
                return ent[0]
            # long codeword: extend bit by bit through the slow map
            code = self._rev(w & ((1 << _FAST_BITS) - 1), _FAST_BITS)
            ln = _FAST_BITS
            while ln < self.maxlen:
                code = (code << 1) | bits_read1(bits, p + ln)
                ln += 1
                if p + ln > bits.nbits:
                    raise _EndOfPacket()
                e = self.slow.get((ln, code))
                if e is not None:
                    bits.pos = p + ln
                    return e
            raise VorbisError("invalid huffman codeword")
        # near end-of-packet: walk bit by bit (EOP mid-codeword is EOP)
        code = 0
        ln = 0
        while ln < self.maxlen:
            code = (code << 1) | bits.read(1)
            ln += 1
            if ln <= _FAST_BITS:
                ent = self.fast[self._rev(code, ln)]
                if ent is not None and ent[1] == ln:
                    return ent[0]
            e = self.slow.get((ln, code))
            if e is not None:
                return e
        raise VorbisError("invalid huffman codeword")

    def decode_vq(self, bits: _Bits) -> np.ndarray:
        if self.vectors is None:
            raise VorbisError("VQ decode from a lookup-0 codebook")
        return self.vectors[self.decode(bits)]


def bits_read1(bits: _Bits, abspos: int) -> int:
    if abspos >= bits.nbits:
        raise _EndOfPacket()
    return (bits.data[abspos >> 3] >> (abspos & 7)) & 1


# --------------------------------------------------------------------- floor1

_INV_DB = np.exp((np.arange(256) - 255.0) * (0.11512925 * 0.546875)).astype(np.float64)
_RANGES = {1: 256, 2: 128, 3: 86, 4: 64}


class _Floor1:
    def __init__(self, bits: _Bits, n_books: int):
        self.partitions = bits.read(5)
        self.partition_class = [bits.read(4) for _ in range(self.partitions)]
        maxclass = max(self.partition_class) if self.partitions else -1
        self.class_dims = []
        self.class_subs = []
        self.masterbooks = []
        self.subclass_books = []
        for _ in range(maxclass + 1):
            self.class_dims.append(bits.read(3) + 1)
            subs = bits.read(2)
            self.class_subs.append(subs)
            if subs:
                mb = bits.read(8)
                if mb >= n_books:
                    raise VorbisError("floor1 masterbook out of range")
                self.masterbooks.append(mb)
            else:
                self.masterbooks.append(-1)
            row = []
            for _ in range(1 << subs):
                b = bits.read(8) - 1
                if b >= n_books:
                    raise VorbisError("floor1 subclass book out of range")
                row.append(b)
            self.subclass_books.append(row)
        self.multiplier = bits.read(2) + 1
        rangebits = bits.read(4)
        xs = [0, 1 << rangebits]
        for i in range(self.partitions):
            for _ in range(self.class_dims[self.partition_class[i]]):
                xs.append(bits.read(rangebits))
        self.X = xs
        self.values = len(xs)
        if len(set(xs)) != len(xs):
            raise VorbisError("floor1 duplicate X positions")
        # sort order by X (positions are unique per spec)
        self.sortidx = sorted(range(self.values), key=lambda i: xs[i])
        # neighbor tables are static per config
        self.lo_nb = [0] * self.values
        self.hi_nb = [0] * self.values
        for i in range(2, self.values):
            lo, hi = 0, 1
            for j in range(i):
                if xs[lo] < xs[j] < xs[i]:
                    lo = j
                if xs[i] < xs[j] < xs[hi]:
                    hi = j
            self.lo_nb[i], self.hi_nb[i] = lo, hi

    def decode(self, bits: _Bits, books: List[_Codebook]):
        """-> list of Y post values, or None if the channel is unvoiced."""
        if not bits.read(1):
            return None
        rng = _RANGES[self.multiplier]
        ybits = _ilog(rng - 1)
        Y = [0] * self.values
        Y[0] = bits.read(ybits)
        Y[1] = bits.read(ybits)
        off = 2
        for i in range(self.partitions):
            cls = self.partition_class[i]
            cdim = self.class_dims[cls]
            cbits = self.class_subs[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = books[self.masterbooks[cls]].decode(bits)
            for j in range(cdim):
                book = self.subclass_books[cls][cval & csub]
                cval >>= cbits
                Y[off + j] = books[book].decode(bits) if book >= 0 else 0
            off += cdim
        return Y

    @staticmethod
    def _render_point(x0, y0, x1, y1, X):
        dy = y1 - y0
        adx = x1 - x0
        err = abs(dy) * (X - x0)
        off = err // adx
        return y0 - off if dy < 0 else y0 + off

    def curve(self, Y: List[int], n2: int) -> np.ndarray:
        rng = _RANGES[self.multiplier]
        final = [0] * self.values
        step2 = [False] * self.values
        final[0], final[1] = Y[0], Y[1]
        step2[0] = step2[1] = True
        for i in range(2, self.values):
            lo, hi = self.lo_nb[i], self.hi_nb[i]
            pred = self._render_point(self.X[lo], final[lo],
                                      self.X[hi], final[hi], self.X[i])
            val = Y[i]
            highroom = rng - pred
            lowroom = pred
            room = 2 * min(highroom, lowroom)
            if val:
                step2[lo] = step2[hi] = step2[i] = True
                if val >= room:
                    if highroom > lowroom:
                        final[i] = val - lowroom + pred
                    else:
                        final[i] = pred - val + highroom - 1
                else:
                    if val & 1:
                        final[i] = pred - ((val + 1) >> 1)
                    else:
                        final[i] = pred + (val >> 1)
            else:
                step2[i] = False
                final[i] = pred
        # curve synthesis on the 0..255 scale (sorted posts, step2 mask)
        out = np.zeros(n2, np.int64)
        mult = self.multiplier
        srt = self.sortidx
        lx = 0
        ly = min(max(final[srt[0]], 0), rng - 1) * mult
        for k in srt[1:]:
            if not step2[k]:
                continue
            hx = self.X[k]
            hy = min(max(final[k], 0), rng - 1) * mult
            if hx > lx:
                self._render_line(lx, ly, hx, hy, out, n2)
            lx, ly = hx, hy
        if lx < n2:
            # last rendered post and the horizontal extension to n/2
            out[lx:] = ly
        np.clip(out, 0, 255, out=out)
        return _INV_DB[out]

    @staticmethod
    def _render_line(x0, y0, x1, y1, v, n2):
        dy = y1 - y0
        adx = x1 - x0
        base = int(dy / adx)  # C-style truncation toward zero
        sy = base - 1 if dy < 0 else base + 1
        ady = abs(dy) - abs(base) * adx
        x1c = min(x1, n2)
        if x0 < n2:
            v[x0] = y0
        err = 0
        y = y0
        for x in range(x0 + 1, x1c):
            err += ady
            if err >= adx:
                err -= adx
                y += sy
            else:
                y += base
            v[x] = y


# --------------------------------------------------------------------- floor0


class _Floor0:
    """Floor type 0: LSP curve (spec section 6). Deprecated by the spec and
    emitted by no known encoder since 2002; decode parity is pinned against
    libvorbisfile on assembler-crafted streams (tests/test_vorbis_assembled)."""

    def __init__(self, bits: _Bits, n_books: int):
        self.order = bits.read(8)
        self.rate = bits.read(16)
        self.bark_map_size = bits.read(16)
        self.amplitude_bits = bits.read(6)
        self.amplitude_offset = bits.read(8)
        self.num_books = bits.read(4) + 1
        self.book_list = [bits.read(8) for _ in range(self.num_books)]
        if (self.order == 0 or self.rate == 0 or self.bark_map_size == 0
                or any(b >= n_books for b in self.book_list)):
            raise VorbisError("invalid floor0 configuration")
        self._maps: Dict[int, np.ndarray] = {}

    def decode(self, bits: _Bits, books: List[_Codebook]):
        amplitude = bits.read(self.amplitude_bits)
        if amplitude <= 0:
            return None
        booknum = bits.read(_ilog(self.num_books))
        if booknum >= self.num_books:
            return None  # spec: undecodable -> channel unvoiced
        book = books[self.book_list[booknum]]
        if book.vectors is None:
            raise VorbisError("floor0 book without a VQ lookup")
        coeffs: List[float] = []
        last = 0.0
        while len(coeffs) < self.order:
            vec = book.decode_vq(bits)
            coeffs.extend(float(v) + last for v in vec)
            last = coeffs[-1]
        return amplitude, coeffs[: self.order]

    def _map(self, n2: int) -> np.ndarray:
        m = self._maps.get(n2)
        if m is None:

            def bark(x):
                return (13.1 * np.arctan(0.00074 * x)
                        + 2.24 * np.arctan(1.85e-8 * x * x) + 1e-4 * x)

            scale = self.bark_map_size / bark(0.5 * self.rate)
            m = np.floor(bark(0.5 * self.rate / n2 * np.arange(n2))
                         * scale).astype(np.int64)
            m = np.minimum(m, self.bark_map_size - 1)
            self._maps[n2] = m
        return m

    def curve(self, decoded, n2: int) -> np.ndarray:
        amplitude, coeffs = decoded
        mp = self._map(n2)
        cos_c = np.cos(np.asarray(coeffs, np.float64))
        out = np.zeros(n2, np.float64)
        i = 0
        while i < n2:
            w = np.pi * mp[i] / self.bark_map_size
            cw = math.cos(w)
            if self.order & 1:
                p = (1.0 - cw * cw) * float(
                    np.prod(4.0 * (cos_c[1::2] - cw) ** 2))
                q = 0.25 * float(np.prod(4.0 * (cos_c[0::2] - cw) ** 2))
            else:
                p = (1.0 - cw) / 2.0 * float(
                    np.prod(4.0 * (cos_c[1::2] - cw) ** 2))
                q = (1.0 + cw) / 2.0 * float(
                    np.prod(4.0 * (cos_c[0::2] - cw) ** 2))
            denom = ((1 << self.amplitude_bits) - 1) * math.sqrt(p + q)
            if denom > 0:
                x = 0.11512925 * (amplitude * self.amplitude_offset / denom
                                  - self.amplitude_offset)
            else:
                x = 88.0  # libvorbis computes in float32: 1/sqrt(0) -> inf
            # saturate at the float32 ceiling instead of raising (degenerate
            # LSP curves overflow the reference's float fromdB the same way)
            lin = math.exp(min(x, 88.0))
            j = i
            while j < n2 and mp[j] == mp[i]:
                out[j] = lin
                j += 1
            i = j
        return out


# -------------------------------------------------------------------- residue


class _Residue:
    def __init__(self, rtype: int, bits: _Bits, books: List[_Codebook]):
        self.rtype = rtype
        self.begin = bits.read(24)
        self.end = bits.read(24)
        self.psize = bits.read(24) + 1
        self.classifications = bits.read(6) + 1
        self.classbook = bits.read(8)
        if self.classbook >= len(books):
            raise VorbisError("residue classbook out of range")
        cascade = []
        for _ in range(self.classifications):
            low = bits.read(3)
            high = bits.read(5) if bits.read(1) else 0
            cascade.append((high << 3) | low)
        self.cascade = cascade
        self.books: List[List[int]] = []
        for i in range(self.classifications):
            row = []
            for p in range(8):
                if cascade[i] & (1 << p):
                    b = bits.read(8)
                    if (b >= len(books) or books[b].vectors is None
                            or books[b].dims <= 0):
                        raise VorbisError("residue VQ book invalid")
                    row.append(b)
                else:
                    row.append(-1)
            self.books.append(row)
        cb = books[self.classbook]
        if cb.dims <= 0:
            raise VorbisError("residue classbook with zero dimensions")
        v = 1
        for _ in range(cb.dims):  # early-exit product: no bignum pow on
            v *= self.classifications  # crafted 16-bit dims
            if v > cb.entries:
                raise VorbisError("residue classbook too small for classifications")

    def decode(self, bits: _Bits, books: List[_Codebook],
               do_not_decode: List[bool], n2: int) -> np.ndarray:
        """-> (n_vectors, n2) residue vectors (type 2 already deinterleaved
        by the caller — this returns the raw decode layout)."""
        nvec = len(do_not_decode)
        if self.rtype == 2:
            vlen = nvec * n2
            vecs = np.zeros((1, vlen), np.float64)
            dnd = [all(do_not_decode)]
        else:
            vlen = n2
            vecs = np.zeros((nvec, vlen), np.float64)
            dnd = do_not_decode
        limit = min(self.end, vlen)
        begin = min(self.begin, vlen)
        n_read = limit - begin
        if n_read <= 0:
            return vecs
        ptr = n_read // self.psize
        cb = books[self.classbook]
        cwords = cb.dims
        nv = len(dnd)
        classes = [[0] * (ptr + cwords) for _ in range(nv)]
        fmt0 = self.rtype == 0
        try:
            for p in range(8):
                pc = 0
                while pc < ptr:
                    if p == 0:
                        for j in range(nv):
                            if dnd[j]:
                                continue
                            temp = cb.decode(bits)
                            row = classes[j]
                            for i in range(cwords - 1, -1, -1):
                                row[pc + i] = temp % self.classifications
                                temp //= self.classifications
                    i = 0
                    while i < cwords and pc < ptr:
                        off = begin + pc * self.psize
                        for j in range(nv):
                            if dnd[j]:
                                continue
                            vq = self.books[classes[j][pc]][p]
                            if vq < 0:
                                continue
                            book = books[vq]
                            v = vecs[j]
                            dims = book.dims
                            if fmt0:
                                # format 0 decodes the whole partition's
                                # codewords BEFORE adding (libvorbis
                                # decodevs_add): EOP mid-partition drops the
                                # entire partition, unlike format 1's
                                # incremental adds
                                step = self.psize // dims
                                vs = [book.decode_vq(bits) for _ in range(step)]
                                for k in range(step):
                                    v[off + k : off + k + dims * step : step] += vs[k]
                            else:
                                k = 0
                                while k < self.psize:
                                    vec = book.decode_vq(bits)
                                    v[off + k : off + k + dims] += vec
                                    k += dims
                        i += 1
                        pc += 1
        except _EndOfPacket:
            pass  # spec: EOP during residue decode is normal; rest stays 0
        return vecs


# ------------------------------------------------------------- mapping / mode


class _Mapping:
    def __init__(self, bits: _Bits, channels: int, n_floors: int,
                 n_residues: int):
        if bits.read(16) != 0:
            raise VorbisError("nonzero mapping type")
        self.submaps = bits.read(4) + 1 if bits.read(1) else 1
        self.coupling: List[Tuple[int, int]] = []
        if bits.read(1):
            steps = bits.read(8) + 1
            cbits = _ilog(channels - 1)
            for _ in range(steps):
                m = bits.read(cbits)
                a = bits.read(cbits)
                if m == a or m >= channels or a >= channels:
                    raise VorbisError("invalid coupling channels")
                self.coupling.append((m, a))
        if bits.read(2) != 0:
            raise VorbisError("nonzero mapping reserved bits")
        if self.submaps > 1:
            self.mux = [bits.read(4) for _ in range(channels)]
            if any(m >= self.submaps for m in self.mux):
                raise VorbisError("mapping mux out of range")
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(self.submaps):
            bits.read(8)  # unused time config
            f = bits.read(8)
            r = bits.read(8)
            if f >= n_floors or r >= n_residues:
                raise VorbisError("mapping floor/residue out of range")
            self.submap_floor.append(f)
            self.submap_residue.append(r)


class _Mode:
    def __init__(self, bits: _Bits, n_mappings: int):
        self.blockflag = bits.read(1)
        if bits.read(16) != 0:
            raise VorbisError("nonzero mode window type")
        if bits.read(16) != 0:
            raise VorbisError("nonzero mode transform type")
        self.mapping = bits.read(8)
        if self.mapping >= n_mappings:
            raise VorbisError("mode mapping out of range")


# --------------------------------------------------------------- imdct/window

_IMDCT_CACHE: Dict[int, np.ndarray] = {}
_WINDOW_CACHE: Dict[Tuple[int, int, int, int], np.ndarray] = {}


def _imdct_matrix(n: int) -> np.ndarray:
    m = _IMDCT_CACHE.get(n)
    if m is None:
        j = np.arange(n)[:, None].astype(np.float64)
        k = np.arange(n // 2)[None, :].astype(np.float64)
        m = np.cos(np.pi / (2 * n) * (2 * j + 1 + n / 2) * (2 * k + 1))
        # f32 matmul halves memory traffic; the summation error (~1e-6 on
        # O(1) spectra) sits far below the int16 oracle floor the tests pin
        _IMDCT_CACHE[n] = m.astype(np.float32)
    return _IMDCT_CACHE[n]


def _window(n: int, blockflag: int, prevflag: int, nextflag: int,
            n0: int) -> np.ndarray:
    key = (n, blockflag and not prevflag, blockflag and not nextflag, n0)
    w = _WINDOW_CACHE.get(key)
    if w is None:

        def slope(size):
            x = np.arange(size, dtype=np.float64)
            return np.sin(0.5 * np.pi
                          * np.sin(0.5 * np.pi * (x + 0.5) / size) ** 2)

        w = np.zeros(n, np.float64)
        if blockflag and not prevflag:
            ls, lstart = n0 // 2, n // 4 - n0 // 4
        else:
            ls, lstart = n // 2, 0
        if blockflag and not nextflag:
            rs, rstart = n0 // 2, 3 * n // 4 - n0 // 4
        else:
            rs, rstart = n // 2, n // 2
        w[lstart : lstart + ls] = slope(ls)
        w[lstart + ls : rstart] = 1.0
        w[rstart : rstart + rs] = slope(rs)[::-1]
        _WINDOW_CACHE[key] = w
    return w


# --------------------------------------------------------------------- stream


class _VorbisStream:
    def __init__(self, packets: List[bytes]):
        if len(packets) < 3:
            raise VorbisError("fewer than three vorbis header packets")
        self._parse_ident(packets[0])
        self._parse_comment(packets[1])
        self._parse_setup(packets[2])
        self.prev_n: Optional[int] = None
        self.pend: Optional[np.ndarray] = None

    def _parse_ident(self, pkt: bytes):
        if pkt[:7] != b"\x01vorbis":
            raise VorbisError("bad identification header")
        b = _Bits(pkt[7:])
        if b.read(32) != 0:
            raise VorbisError("unsupported vorbis version")
        self.channels = b.read(8)
        self.rate = b.read(32)
        if self.channels == 0 or self.rate == 0:
            raise VorbisError("zero channels or rate")
        b.read(32)  # bitrate max
        b.read(32)  # bitrate nominal
        b.read(32)  # bitrate min
        bs0 = 1 << b.read(4)
        bs1 = 1 << b.read(4)
        if not (64 <= bs0 <= bs1 <= 8192):
            raise VorbisError(f"illegal blocksizes {bs0}/{bs1}")
        if b.read(1) != 1:
            raise VorbisError("identification framing bit unset")
        self.bs0, self.bs1 = bs0, bs1

    @staticmethod
    def _parse_comment(pkt: bytes):
        if pkt[:7] != b"\x03vorbis":
            raise VorbisError("bad comment header")
        # content irrelevant for decode; framing enforced loosely (some
        # taggers truncate) — libvorbisfile requires the packet to parse,
        # so verify the length structure
        b = _Bits(pkt[7:])
        try:
            vlen = b.read(32)
            for _ in range(vlen):
                b.read(8)
            count = b.read(32)
            for _ in range(count):
                ln = b.read(32)
                if ln > b.remaining() // 8:
                    raise _EndOfPacket()
                b.pos += ln * 8
            if b.read(1) != 1:
                raise VorbisError("comment framing bit unset")
        except _EndOfPacket:
            raise VorbisError("truncated comment header") from None

    def _parse_setup(self, pkt: bytes):
        if pkt[:7] != b"\x05vorbis":
            raise VorbisError("bad setup header")
        b = _Bits(pkt[7:])
        try:
            self.books = [_Codebook(b) for _ in range(b.read(8) + 1)]
            for _ in range(b.read(6) + 1):  # time transforms (placeholders)
                if b.read(16) != 0:
                    raise VorbisError("nonzero time transform")
            self.floors = []
            for _ in range(b.read(6) + 1):
                ftype = b.read(16)
                if ftype == 1:
                    self.floors.append(_Floor1(b, len(self.books)))
                elif ftype == 0:
                    self.floors.append(_Floor0(b, len(self.books)))
                else:
                    raise VorbisError(f"reserved floor type {ftype}")
            self.residues = []
            for _ in range(b.read(6) + 1):
                rtype = b.read(16)
                if rtype > 2:
                    raise VorbisError(f"reserved residue type {rtype}")
                self.residues.append(_Residue(rtype, b, self.books))
            self.mappings = [
                _Mapping(b, self.channels, len(self.floors), len(self.residues))
                for _ in range(b.read(6) + 1)
            ]
            self.modes = [_Mode(b, len(self.mappings))
                          for _ in range(b.read(6) + 1)]
            if b.read(1) != 1:
                raise VorbisError("setup framing bit unset")
        except _EndOfPacket:
            raise VorbisError("truncated setup header") from None

    # ------------------------------------------------------------- one packet
    def decode_packet(self, pkt: bytes) -> Optional[np.ndarray]:
        b = _Bits(pkt)
        try:
            if b.read(1) != 0:
                return None  # non-audio packet in the audio section: ignore
            mode = self.modes[b.read(_ilog(len(self.modes) - 1))]
            n = self.bs1 if mode.blockflag else self.bs0
            prevflag = nextflag = 0
            if mode.blockflag:
                prevflag = b.read(1)
                nextflag = b.read(1)
        except _EndOfPacket:
            return None  # EOP in the packet header: drop the packet
        n2 = n // 2
        mapping = self.mappings[mode.mapping]
        ch = self.channels

        # floors
        floor_posts: List[Optional[List[int]]] = [None] * ch
        try:
            for c in range(ch):
                fl = self.floors[mapping.submap_floor[mapping.mux[c]]]
                floor_posts[c] = fl.decode(b, self.books)
        except _EndOfPacket:
            pass  # remaining channels unvoiced

        no_residue = [fp is None for fp in floor_posts]
        # coupling: if either side is voiced both residues decode
        for m, a in mapping.coupling:
            if not (no_residue[m] and no_residue[a]):
                no_residue[m] = no_residue[a] = False

        # residues per submap
        residue_vec = np.zeros((ch, n2), np.float64)
        for s in range(mapping.submaps):
            sub_ch = [c for c in range(ch) if mapping.mux[c] == s]
            if not sub_ch:
                continue
            res = self.residues[mapping.submap_residue[s]]
            dnd = [no_residue[c] for c in sub_ch]
            out = res.decode(b, self.books, dnd, n2)
            if res.rtype == 2:
                inter = out[0]
                for idx, c in enumerate(sub_ch):
                    residue_vec[c] = inter[idx::len(sub_ch)]
            else:
                for idx, c in enumerate(sub_ch):
                    residue_vec[c] = out[idx]

        # inverse coupling (square polar), reverse step order
        for m, a in reversed(mapping.coupling):
            M = residue_vec[m]
            A = residue_vec[a]
            newM = M.copy()
            newA = A.copy()
            pos_m = M > 0
            pa = A > 0
            # M>0, A>0: A' = M - A ; M>0, A<=0: M' = M + A, A' = M
            # M<=0, A>0: A' = M + A ; M<=0, A<=0: M' = M - A, A' = M
            newA[pos_m & pa] = (M - A)[pos_m & pa]
            newM[pos_m & ~pa] = (M + A)[pos_m & ~pa]
            newA[pos_m & ~pa] = M[pos_m & ~pa]
            newA[~pos_m & pa] = (M + A)[~pos_m & pa]
            newM[~pos_m & ~pa] = (M - A)[~pos_m & ~pa]
            newA[~pos_m & ~pa] = M[~pos_m & ~pa]
            residue_vec[m] = newM
            residue_vec[a] = newA

        # floor curve * residue -> spectrum; one batched IMDCT over channels
        imdct = _imdct_matrix(n)
        w = _window(n, mode.blockflag, prevflag, nextflag, self.bs0)
        spectra = np.zeros((n2, ch), np.float32)
        for c in range(ch):
            if floor_posts[c] is None:
                continue
            fl = self.floors[mapping.submap_floor[mapping.mux[c]]]
            spectra[:, c] = fl.curve(floor_posts[c], n2) * residue_vec[c]
        pcm = (imdct @ spectra).astype(np.float64) * w[:, None]

        # lapping: emit [previous center, current center)
        if self.prev_n is None:
            self.prev_n = n
            self.pend = pcm[n2:]
            return None
        np_4 = self.prev_n // 4
        take = np_4 + n // 4
        f = np.zeros((take + n2, ch), np.float64)
        pend = self.pend
        f[: min(len(pend), len(f))] += pend[: len(f)]
        off = np_4 - n // 4
        if off >= 0:
            f[off : off + n] += pcm
        else:
            # current block's leading zero-window region precedes prev center
            f[: n + off] += pcm[-off:]
        self.prev_n = n
        self.pend = f[take:]
        return f[:take]


# ------------------------------------------------------------------- top API


def decode_vorbis(data: bytes) -> Tuple[np.ndarray, int]:
    """Ogg Vorbis bytes -> (float64 (n, channels) in ~[-1, 1], sample_rate).

    Chained files (multiple logical streams concatenated, e.g. icecast
    dumps) decode link by link and concatenate, like libvorbisfile's
    ov_read across links; links must share channels and rate (a single
    (pcm, sr) return cannot represent a mid-file format change — raise
    loudly instead)."""
    pos = 0
    all_chunks: List[np.ndarray] = []
    channels = rate = None
    while pos < len(data):
        packets, total_granule, pos = _ogg_packets(data, pos)
        stream = _VorbisStream(packets)
        if channels is None:
            channels, rate = stream.channels, stream.rate
        elif (stream.channels, stream.rate) != (channels, rate):
            raise VorbisError(
                "chained stream changes format mid-file "
                f"({channels}ch@{rate} -> {stream.channels}ch@{stream.rate})")
        chunks = []
        for pkt in packets[3:]:
            out = stream.decode_packet(pkt)
            if out is not None and len(out):
                chunks.append(out)
        if chunks:
            pcm = np.concatenate(chunks, axis=0)
        else:
            pcm = np.zeros((0, stream.channels), np.float64)
        if 0 <= total_granule < len(pcm):
            pcm = pcm[:total_granule]
        all_chunks.append(pcm)
    if not all_chunks:
        raise VorbisError("no vorbis stream found")
    pcm = np.concatenate(all_chunks, axis=0) if len(all_chunks) > 1 else all_chunks[0]
    return pcm, rate


def read_vorbis(path: str) -> Tuple[np.ndarray, int]:
    """Read an Ogg Vorbis file -> (float32 (n,) or (n, ch) in [-1, 1], sr) —
    read_wav's output contract (see audio/wav.read_wav)."""
    with open(path, "rb") as f:
        data = f.read()
    pcm, sr = decode_vorbis(data)
    pcm = pcm.astype(np.float32)
    if pcm.ndim == 2 and pcm.shape[1] == 1:
        pcm = pcm[:, 0]
    return pcm, sr
