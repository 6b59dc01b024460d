#!/usr/bin/env python3
"""Time gn_silu_fwd's cluster body against variants of itself on one CUDA card.

    python3 scripts/gn_fwd_variants.py DETAIL_LOG

DETAIL_LOG is the output of `python3 chip_smoke.py --detail`: its
`kernel_shape` rows of gn_silu_fwd name the (shape, groups, act) that the
paths launched. Each variant below is a copy of csrc/gn_silu.cu with a few
text edits (each must match once), built with nvcc into a library of its
own (all builds started together) and called through its C entry point.
Every variant is held against the plain version at every shape, in bf16
and f32 (atol 2e-5, rtol 1e-4 in f32, 2e-2 in bf16; the streaming variant
must report the streaming body, the others the cluster body), then timed:
device time per call, 10 calls in a CUDA graph, median of 10 replays
(chip_smoke.cuda_ms), in turns, the variants forward and then backward,
the better of the two. Prints one JSON line per (shape, dtype), then the
sums over the shapes by variant and dtype, and the registers and spills
ptxas reports for the cluster body as it is.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import assert_close, cuda_ms  # noqa: E402
from tango_tpu_torch.ops import CLUSTER_LAUNCHED, _build  # noqa: E402
from tango_tpu_torch.ops.gn_silu import gn_fwd_cluster_size, gn_silu_fwd_plain  # noqa: E402

SRC = os.path.join(ROOT, "tango_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "gn_fwd_variants")
PREFETCH = '''  if (tid < 32)
    for (int c = tid; c < nch; c += 32)
      ab[c] = make_float2(gamma[gi * cg + c0 + c], beta[gi * cg + c0 + c]);
'''
# name -> [(text, replacement)]: the cluster body as it is, and one change each
VARIANTS = {
    "cluster": [],
    # the rule refuses every shape: the one-block streaming body
    "streaming": [("int gn_fwd_cluster_size(int esize, int B, int C, int HW, int G) {\n",
                   "int gn_fwd_cluster_size(int esize, int B, int C, int HW, int G) {\n"
                   "  return 0;\n")],
    # the IEEE exponential and division of silu() in the apply pass
    "ieee_silu": [("if (act) v[j] = silu_fast<T>(v[j]);", "if (act) v[j] = silu(v[j]);")],
    # bf16 on the f32 intrinsics too, not tanh.approx
    "no_tanh": [("if constexpr (sizeof(T) == 2) {\n    const float h",
                 "if constexpr (false) {\n    const float h")],
    # gamma and beta loaded after the statistics, not during the copies
    "no_prefetch": [(PREFETCH, ""),
                    ("const float a = inv * ab[c].x;", "const float a = inv * gamma[gi * cg + c0 + c];"),
                    ("ab[c] = make_float2(a, ab[c].y - mean * a);",
                     "ab[c] = make_float2(a, beta[gi * cg + c0 + c] - mean * a);")],
    # R by the CTA target alone, or with another least slice
    "min_slice_0": [("kFwdMinSlice = 16 * 1024;", "kFwdMinSlice = 0;")],
    "min_slice_8k": [("kFwdMinSlice = 16 * 1024;", "kFwdMinSlice = 8 * 1024;")],
    "min_slice_32k": [("kFwdMinSlice = 16 * 1024;", "kFwdMinSlice = 32 * 1024;")],
    "min_ctas_132": [("kFwdMinCtas = 264;", "kFwdMinCtas = 132;")],
}


def build(base: str) -> tuple[dict, str]:
    """Each variant's library (loaded), and ptxas's report on the first."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old[:50]!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        src, lib = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
        with open(src, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", SRC, "-Xptxas", "-v", "-shared",
               "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs, report = {}, ""
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        if name == "cluster":
            report = log
        handle = ctypes.CDLL(lib)
        handle.tt_gn_silu_fwd.argtypes = _build._SIGNATURES["tt_gn_silu_fwd"]
        handle.tt_error_string.argtypes = [ctypes.c_int]
        handle.tt_error_string.restype = ctypes.c_char_p
        libs[name] = handle
    return libs, report


def ptxas_rows(report: str) -> list:
    """(kernel, registers, spill bytes) of gn_fwd_cluster_kernel's instances."""
    rows, kernel = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1) if "gn_fwd_cluster_kernel" in m.group(1) else None
        elif kernel and "spill stores" in line:
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif kernel and "registers" in line:
            rows.append((re.sub(r".*gn_fwd_cluster_kernel", "gn_fwd_cluster_kernel", kernel),
                         int(re.search(r"Used (\d+) registers", line).group(1)), spill))
            kernel = None
    return rows


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("gn_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    shapes = []
    with open(argv[0]) as f:
        for line in f:
            if line.startswith("{") and '"kernel_shape"' in line:
                row = json.loads(line)
                if row["name"] == "gn_silu_fwd" and row.get("dtype", "bf16") == "bf16":
                    shape, groups, act = row["shape"]
                    shapes.append((tuple(shape), groups, act))
    with open(os.path.join(SRC, "gn_silu.cu")) as f:
        libs, report = build(f.read())
    gen = torch.Generator(device="cuda").manual_seed(7)
    totals = {}
    for tag, dt, tol in (("bf16", torch.bfloat16, (2e-2, 2e-2)),
                         ("f32", torch.float32, (2e-5, 1e-4))):
        for shape, groups, act in shapes:
            b, c = shape[:2]
            hw = math.prod(shape[2:])
            x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dt)
            gam = torch.randn(c, generator=gen, device="cuda") * 0.2 + 1.0
            bet = torch.randn(c, generator=gen, device="cuda") * 0.1
            y = torch.empty_like(x)
            ref = gn_silu_fwd_plain(x, gam, bet, groups, 1e-5, act)

            def call(lib):
                return lib.tt_gn_silu_fwd(x.data_ptr(), gam.data_ptr(), bet.data_ptr(),
                                          y.data_ptr(), b, c, hw, groups, 1e-5,
                                          int(act == "silu"), int(dt == torch.bfloat16),
                                          torch.cuda.current_stream().cuda_stream)

            for name, lib in libs.items():
                y.fill_(float("nan"))
                code = call(lib)
                want = 0 if name == "streaming" else CLUSTER_LAUNCHED
                if code != want:
                    raise SystemExit(f"{name} {shape} {tag}: returned {code}")
                assert_close(y, ref, *tol, f"{name} {shape} {tag}")
            times = {}
            for name in list(libs) + list(libs)[::-1]:
                times[name] = min(times.get(name, math.inf), cuda_ms(lambda: call(libs[name])))
            for name, ms in times.items():
                totals.setdefault(tag, {}).setdefault(name, 0.0)
                totals[tag][name] += ms
            print(json.dumps({"shape": shape, "groups": groups, "act": act, "dtype": tag,
                              "cluster_size": gn_fwd_cluster_size(dt, b, c, hw, groups),
                              "us": {k: round(v * 1e3, 3) for k, v in times.items()}}),
                  flush=True)
    print(json.dumps({"total_ms": totals, "shapes": len(shapes),
                      "ptxas": ptxas_rows(report)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
