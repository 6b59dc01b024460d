"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source compiles in its own `nvcc` process, all started
together, and one more `nvcc` links the objects into a shared library with a
plain C interface, loaded with `ctypes` (no PyTorch headers: the build takes
seconds, not minutes). The library lands in `build/` at the repository root
under a name that carries the hash of the sources and flags, so a second run
reuses it. Nothing here runs at import time: the library is built on first
use, from inside a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int)
_SIGNATURES = {
    # x, gamma, beta, y, B, C, HW, G, eps, act, dtype, stream
    "tt_gn_silu_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # x, parts, B, C, HW, G, chunks, dtype, stream
    "tt_gn_stats": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, a, b, y, B, C, HW, act, dtype, stream
    "tt_gn_apply": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, g, gamma, beta, dx, dparam, B, C, HW, G, eps, act, dtype, stream
    "tt_gn_silu_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # x, g, mean, inv, gamma, beta, dparam, sums, done, B, C, HW, G, act, dtype, stream
    "tt_gn_bwd_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, g, mean, inv, gamma, beta, sums, dx, B, C, HW, G, count, act, dtype, stream
    "tt_gn_bwd_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # the two above on their streaming fallbacks alone (a yardstick, on no path)
    "tt_gn_bwd_stats_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tt_gn_bwd_apply_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # q, k, v, o, BH, Sq, Skv, D, qscale, dtype, stream
    "tt_attn_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "tt_attn_fwd_v2": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # the static form's CUDA-core body at any head dim (a yardstick, on no path)
    "tt_attn_fwd_core": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, bias, o, BH, Sq, Skv, D, heads, bias rows, qscale, dtype, stream
    "tt_attn_fwd_bias": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, do, dq, lse, delta, BH, Sq, Skv, D, scale, dtype, stream
    "tt_attn_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, do, lse, delta, dk, dv, BH, Sq, Skv, D, scale, dtype, stream
    "tt_attn_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # x, w, w_scale, y, xq, scale, part, splits, M, N, K, dtype, stream
    "tt_w8a8_gemm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, u, y, v, part, splits, B, Ci, H, W, Co, dtype, stream
    "tt_wino_conv3x3": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # w, u, Co, Ci, dtype, stream
    "tt_wino_weight": [_P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
# filled by load(): {"seconds": build wall time, "reused": bool, "path": str}
build_info: dict = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtango_kernels_{h.hexdigest()[:16]}.so"


def _compile(path: pathlib.Path) -> None:
    """One nvcc per source, all started together (each writes its output to a
    log file, so none blocks on a full pipe), then one nvcc to link."""
    nvcc = _nvcc()
    tmpdir = path.with_suffix(f".{os.getpid()}.d")
    tmpdir.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj, log = tmpdir / f"{src.stem}.o", tmpdir / f"{src.stem}.log"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            with open(log, "w") as f:
                jobs.append((cmd, obj, log, subprocess.Popen(cmd, stdout=f, stderr=f)))
        for cmd, _, log, proc in jobs:
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{log.read_text()}")
        tmp = tmpdir / "lib.so"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(j[1]) for j in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    finally:
        for *_, proc in jobs:  # after a failure, stop the compilers still running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmpdir, ignore_errors=True)


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if no cached copy exists."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        import time

        path = library_path()
        t0 = time.perf_counter()
        reused = path.exists()
        if not reused:
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tt_error_string.argtypes = [ctypes.c_int]
        lib.tt_error_string.restype = ctypes.c_char_p
        build_info.update(seconds=time.perf_counter() - t0, reused=reused, path=str(path))
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.tt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
