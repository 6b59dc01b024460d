"""The port's audio format sniffing vs the JAX package's, on the same bytes.

Both `sniff_format`s read the same file header; the port keeps its own copy
of the JAX rule (it imports nothing of the JAX package), so this pins the two
together. `read_wav` dispatches on that answer in both packages.
"""

import pytest

from tango_tpu.audio import wav as jwav
from tango_tpu_torch.audio import wav as twav


def _id3(body: bytes, size: int = 20, footer: bool = False) -> bytes:
    """An ID3v2.4 tag of `size` bytes (syncsafe), an optional 10-byte footer,
    then `body`."""
    syncsafe = bytes([(size >> 21) & 0x7F, (size >> 14) & 0x7F, (size >> 7) & 0x7F, size & 0x7F])
    tag = b"ID3" + b"\x04\x00" + (b"\x10" if footer else b"\x00") + syncsafe
    return tag + b"\x00" * (size + (10 if footer else 0)) + body


def _ogg(packet: bytes) -> bytes:
    """One Ogg page header with a single segment holding `packet`."""
    header = b"OggS" + b"\x00" * 22 + bytes([1]) + bytes([len(packet)])
    return header + packet + b"\x00" * 16


HEADERS = {
    "wav": b"RIFF\x24\x00\x00\x00WAVEfmt " + b"\x00" * 40,
    "flac": b"fLaC" + b"\x00" * 60,
    "id3_flac": _id3(b"fLaC" + b"\x00" * 40),
    "id3_footer_flac": _id3(b"fLaC" + b"\x00" * 40, size=300, footer=True),
    "id3_mpeg": _id3(b"\xff\xfb\x90\x00" + b"\x00" * 40),
    "id3_other": _id3(b"RIFF" + b"\x00" * 40),
    "id3_truncated": b"ID3\x04",
    "mpeg": b"\xff\xfb\x90\x00" + b"\x00" * 60,
    "mpeg_reserved_layer": b"\xff\xf1\x90\x00" + b"\x00" * 60,
    "ogg_vorbis": _ogg(b"\x01vorbis" + b"\x00" * 22),
    "ogg_opus": _ogg(b"OpusHead" + b"\x01\x02" + b"\x00" * 9),
    "ogg_other": _ogg(b"\x7fFLAC" + b"\x00" * 20),
    "ogg_truncated": b"OggS" + b"\x00" * 10,
    "aiff": b"FORM\x00\x00\x00\x40AIFFCOMM" + b"\x00" * 40,
    "aifc": b"FORM\x00\x00\x00\x40AIFCFVER" + b"\x00" * 40,
    "iff_other": b"FORM\x00\x00\x00\x408SVXVHDR" + b"\x00" * 40,
    "unknown": b"not audio at all" * 4,
}

EXPECTED = {"wav": "wav", "flac": "flac", "id3_flac": "flac", "id3_footer_flac": "flac",
            "id3_mpeg": "mp3", "mpeg": "mp3", "ogg_vorbis": "ogg", "ogg_opus": "opus",
            "aiff": "aiff", "aifc": "aiff"}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_sniff_format_matches_jax(name, tmp_path):
    path = tmp_path / f"{name}.bin"
    path.write_bytes(HEADERS[name])
    got = twav.sniff_format(str(path))
    assert got == jwav.sniff_format(str(path))
    if name in EXPECTED:
        assert got == EXPECTED[name]
    else:
        assert "unsupported" in got or got.startswith("unknown format")
