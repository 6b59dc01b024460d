"""ctypes loader for the native FLAC subframe decoder (_flac_native.c).

Compiled by the host C compiler at first use (not at import) into
`build/flac_native_<hash of the source>.so` at the repository root, beside
the CUDA kernels' library, so a second process loads it without a build.
Any failure (no compiler, no writable `build/`, a load error) leaves the
decoder unavailable; audio/flac.py then uses its pure-python path, so FLAC
ingestion never hard-depends on a toolchain. `build_info` says what
happened: the library's path, whether it was reused, the build's seconds,
or the error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
import time
from typing import Optional, Tuple

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "_flac_native.c"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_tried = False
# filled at the first use: {"path", "reused", "seconds"} or {"error"}
build_info: dict = {}


def _compile(so_path: pathlib.Path) -> None:
    """Compile the source into so_path, trying g++, cc and gcc in turn; a
    temporary name then an atomic rename, so two processes racing the same
    entry never load a half-written library."""
    errors = []
    for cc in ("g++", "cc", "gcc"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so_path.parent)
        os.close(fd)
        try:
            subprocess.run([cc, "-O2", "-shared", "-fPIC", "-x", "c", str(_SRC), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
            return
        except Exception as e:  # noqa: BLE001 — the next compiler, or give up
            errors.append(f"{cc}: {e}")
            try:
                os.unlink(tmp)
            except OSError:
                pass
    raise RuntimeError("; ".join(errors))


def _build() -> ctypes.CDLL:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = BUILD_DIR / f"flac_native_{tag}.so"
    t0 = time.perf_counter()
    reused = so_path.exists()
    if not reused:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _compile(so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.flac_decode_subframe.restype = ctypes.c_int64
    lib.flac_decode_subframe.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    build_info.update(path=str(so_path), reused=reused, seconds=time.perf_counter() - t0)
    return lib


def available() -> bool:
    """Whether the native decoder loads; builds it on the first call."""
    global _LIB, _tried
    if not _tried:
        with _lock:
            if not _tried:
                try:
                    _LIB = _build()
                except Exception as e:  # noqa: BLE001 — the python path decodes instead
                    build_info["error"] = str(e)
                _tried = True
    return _LIB is not None


def decode_subframe(buf: bytes, pos_bits: int, block_size: int,
                    bps: int) -> Tuple[Optional[np.ndarray], int]:
    """One subframe at pos_bits -> (int64 samples, new bit position).

    Returns (None, negative_error) on any decode error; the caller re-runs
    the pure-python path to produce the precise FlacError.
    """
    out = np.empty(block_size, np.int64)
    ret = _LIB.flac_decode_subframe(
        buf, len(buf), pos_bits, block_size, bps,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if ret < 0:
        return None, int(ret)
    return out, int(ret)
