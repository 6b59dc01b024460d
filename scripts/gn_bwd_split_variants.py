#!/usr/bin/env python3
"""Time the split GroupNorm backward's new bodies against variants of
themselves and against their streaming fallbacks on one CUDA card.

    python3 scripts/gn_bwd_split_variants.py [--parts] [DETAIL_LOG]

The shapes are the slabs of path `sp_train` in chip_smoke.py (SP = 2 over
the long clip's 512 latent frames, batch 1, 32 groups: SP_TRAIN_SLABS),
or, given DETAIL_LOG (the output of `python3 chip_smoke.py --detail`), the
`kernel_shape` rows of gn_bwd_stats there. Each variant below is a copy of
csrc/gn_silu.cu with a few text edits (each must match once), built with
nvcc into a library of its own (all builds started together) and called
through its C entry points: `gn_bwd_stats` variants through tt_gn_bwd_stats,
`gn_bwd_apply` ones through tt_gn_bwd_apply, and the bodies they replaced
(the streaming fallbacks) through the _rows entry points of the unchanged
library, stats with its tickets zeroed for each call as its wrapper did.
Every variant is held against the plain version at every shape, in bf16 and
f32 (chip_smoke's GroupNorm backward limits: atol 2e-4, rtol 1e-3 in f32,
2e-2 in bf16; the new bodies must report theirs), then timed: device time
per call, 10 calls in a CUDA graph, median of 10 replays
(chip_smoke.cuda_ms), in turns, the variants forward and then backward, the
better of the two. Prints one JSON line per (shape, dtype) with the times
in µs and the max abs errors, then the sums over the shapes and the largest
errors by variant and dtype, and the registers and spills ptxas reports for
the new bodies. --parts times gn_bwd_stats' cluster body with parts of it
cut out instead (PARTS: their results are wrong and not checked), to split
a call's time between its launch and syncs, its sums and its exchange.
"""

from __future__ import annotations

import ctypes
import faulthandler
import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import assert_close, cuda_ms, max_err  # noqa: E402
from tango_tpu_torch.ops import CLUSTER_LAUNCHED, FLAT_LAUNCHED, _build  # noqa: E402
from tango_tpu_torch.ops.gn_silu import (  # noqa: E402
    _DTYPES,
    gn_bwd_apply_plain,
    gn_bwd_stats_plain,
)

DEADLINE_S = 420
SRC = os.path.join(ROOT, "tango_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "gn_bwd_split_variants")
# (C, slab rows, F, act) of the sp_train slabs: the full-width UNet's levels
# 0-3 on a 256 x 16 slab of the 512 x 16 latents, halved at each level
SP_TRAIN_SLABS = [(320, 256, 16, "silu"), (320, 256, 16, None), (640, 256, 16, "silu"),
                  (960, 256, 16, "silu"), (320, 128, 8, "silu"), (640, 128, 8, "silu"),
                  (640, 128, 8, None), (960, 128, 8, "silu"), (1280, 128, 8, "silu"),
                  (1920, 128, 8, "silu"), (640, 64, 4, "silu"), (1280, 64, 4, "silu"),
                  (1280, 64, 4, None), (1920, 64, 4, "silu"), (2560, 64, 4, "silu"),
                  (1280, 32, 2, "silu"), (1280, 32, 2, None), (2560, 32, 2, "silu")]
TANH_BF16 = """  if constexpr (sizeof(T) == 2) {
    asm("tanh.approx.f32 %0, %1;\\n" : "=f"(s) : "f"(0.5f * y));"""
NO_TANH = """  if constexpr (false) {
    asm("tanh.approx.f32 %0, %1;\\n" : "=f"(s) : "f"(0.5f * y));"""
STATS_STEP = "slice_sums<T, NT, sizeof(T) / 2>"
STATS_DPRE = "gn_dpre_fast<T>(to_f32(gv[j]), xh, gam[u], bet[u], act)"
# name -> (half, [(text, replacement)]): the new bodies as they are, and one
# change each
VARIANTS = {
    "stats": ("stats", []),
    # 1, 2 or 4 packets of x and of g a lane a step, in both types
    **{f"stats_u{u}": ("stats", [(STATS_STEP, f"slice_sums<T, NT, {u}>")]) for u in (1, 2, 4)},
    # CTAs of 256 threads
    "stats_256": ("stats", [("kBwdStatsThreads = 128;", "kBwdStatsThreads = 256;")]),
    # the IEEE exponential and division of gn_dpre
    "stats_ieee": ("stats", [(STATS_DPRE, STATS_DPRE.replace("gn_dpre_fast<T>", "gn_dpre"))]),
    # bf16 SiLU' on the fast exponential and division, not tanh
    "stats_no_tanh": ("stats", [(TANH_BF16, NO_TANH)]),
    # R by 132 CTAs alone, or another least slice before 264
    "stats_ctas_132": ("stats", [("kStatsMinCtas = 264;", "kStatsMinCtas = 132;")]),
    "stats_slice_8k": ("stats", [("kStatsMinSlice = 16 * 1024;", "kStatsMinSlice = 8 * 1024;")]),
    "stats_slice_32k": ("stats", [("kStatsMinSlice = 16 * 1024;",
                                   "kStatsMinSlice = 32 * 1024;")]),
    "apply": ("apply", []),
    # the IEEE exponential and division of gn_dpre
    "apply_ieee": ("apply", [("gf * dsilu_fast<T>(fmaf(xf, cf.x, cf.y))",
                              "gn_dpre(gf, xf, cf.x, cf.y, 1)")]),
    "apply_no_tanh": ("apply", [(TANH_BF16, NO_TANH)]),
    # one packet a thread, more CTAs
    "apply_k1": ("apply", [("kFlatMaxPackets = 4;", "kFlatMaxPackets = 1;")]),
}


# gn_bwd_stats' cluster body with parts cut out (--parts): the sums, the
# exchange with rank 0, rank 0's tail, and all three (the launch and the
# syncs alone)
SUMS = """  slice_sums<T, NT, sizeof(T) / 2>(x + base, g + base, lo, hi - lo, HW, gamma + gi * cg,
                                   beta + gi * cg, mu, iv, act, sdb, sdg);
"""
PUSH = ("    for (int c = tid; c < cg; c += NT) "
        "push_peer(inbox + rank * cg + c, mbar, 0, sdb[c], sdg[c]);\n")
WAIT = ("    if (rank != 0) return;\n    mbar_wait(mbar, 0);\n", "    if (rank != 0) return;\n")
TAIL = "  // rank 0: each channel's R partials in rank order, then the group's sums\n"
PARTS = {
    "stats": ("stats", []),
    "stats_cut_sums": ("stats", [(SUMS, "")]),
    "stats_cut_exchange": ("stats", [(PUSH, ""), WAIT]),
    "stats_cut_tail": ("stats", [(TAIL, "  return;\n" + TAIL)]),
    "stats_cut_all": ("stats", [(SUMS, ""), (PUSH, ""), WAIT, (TAIL, "  return;\n" + TAIL)]),
}


def build(base: str, variants: dict) -> tuple[dict, str]:
    """Each variant's library (loaded), and ptxas's report on the unchanged
    source."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (_, edits) in variants.items():
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
        if name == "stats":
            report = log
        handle = ctypes.CDLL(lib)
        for entry in ("tt_gn_bwd_stats", "tt_gn_bwd_apply", "tt_gn_bwd_stats_rows",
                      "tt_gn_bwd_apply_rows"):
            getattr(handle, entry).argtypes = _build._SIGNATURES[entry]
        handle.tt_error_string.argtypes = [ctypes.c_int]
        handle.tt_error_string.restype = ctypes.c_char_p
        libs[name] = handle
    return libs, report


def ptxas_rows(report: str) -> list:
    """(kernel, registers, spill bytes) of the new bodies' instances."""
    rows, kernel, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1) if re.search(r"gn_bwd_(stats_cluster|apply_flat)", m.group(1)) \
                else None
        elif kernel and "spill stores" in line:
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif kernel and "registers" in line:
            rows.append((re.sub(r".*(gn_bwd_\w+_kernel)", r"\1", kernel),
                         int(re.search(r"Used (\d+) registers", line).group(1)), spill))
            kernel = None
    return rows


def read_shapes(path: str) -> list:
    shapes = []
    with open(path) as f:
        for line in f:
            if line.startswith("{") and '"kernel_shape"' in line:
                row = json.loads(line)
                if row["name"] == "gn_bwd_stats" and row.get("dtype", "bf16") == "bf16":
                    shape, groups, act = row["shape"]
                    shapes.append((tuple(shape), groups, act))
    return shapes


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("gn_bwd_split_variants: no CUDA device", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)  # a variant that hangs ends the run
    variants = PARTS if "--parts" in argv else VARIANTS
    argv = [a for a in argv if a != "--parts"]
    shapes = read_shapes(argv[0]) if argv else [((1, c, h, w), 32, act)
                                                 for c, h, w, act in SP_TRAIN_SLABS]
    with open(os.path.join(SRC, "gn_silu.cu")) as f:
        libs, report = build(f.read(), variants)
    gen = torch.Generator(device="cuda").manual_seed(7)
    totals, worst_err = {}, {}
    for tag, dt, tol in (("bf16", torch.bfloat16, (2e-2, 2e-2)),
                         ("f32", torch.float32, (2e-4, 1e-3))):
        for shape, groups, act in shapes:
            b, c = shape[:2]
            hw = math.prod(shape[2:])
            count = 2 * b * c * hw // (b * groups)  # a group over SP = 2's two slabs
            x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dt)
            g = torch.randn(shape, generator=gen, device="cuda").to(dt)
            gam = torch.randn(c, generator=gen, device="cuda") * 0.2 + 1.0
            bet = torch.randn(c, generator=gen, device="cuda") * 0.1
            xf = x.float().reshape(b, groups, -1)
            mean = xf.mean(-1).contiguous()
            inv = torch.rsqrt(xf.var(-1, unbiased=False) + 1e-5).contiguous()
            a = int(act == "silu")
            rsums, rdparam = gn_bwd_stats_plain(x, g, mean, inv, gam, bet, act)
            rdx = gn_bwd_apply_plain(x, g, mean, inv, gam, bet, act, rsums, count)
            sums = torch.empty_like(rsums)
            dparam = torch.empty_like(rdparam)
            dx = torch.empty_like(x)
            ptrs = (x.data_ptr(), g.data_ptr(), mean.data_ptr(), inv.data_ptr(),
                    gam.data_ptr(), bet.data_ptr())

            def stats(lib, rows=False):
                done = torch.zeros(b * groups, device="cuda", dtype=torch.int32) if rows else None
                entry = lib.tt_gn_bwd_stats_rows if rows else lib.tt_gn_bwd_stats
                return entry(*ptrs, dparam.data_ptr(), sums.data_ptr(),
                             None if done is None else done.data_ptr(), b, c, hw, groups, a,
                             _DTYPES[dt], torch.cuda.current_stream().cuda_stream)

            def apply(lib, rows=False):
                entry = lib.tt_gn_bwd_apply_rows if rows else lib.tt_gn_bwd_apply
                return entry(*ptrs, rsums.data_ptr(), dx.data_ptr(), b, c, hw, groups,
                             float(count), a, _DTYPES[dt], torch.cuda.current_stream().cuda_stream)

            calls = {name: (lambda lib=libs[name], h=half: (stats if h == "stats" else apply)(lib))
                     for name, (half, _) in variants.items()}
            calls["stats_parent"] = lambda: stats(libs["stats"], rows=True)
            calls["apply_parent"] = lambda: apply(libs["stats"], rows=True)
            errs = {}
            for name, call in calls.items():
                sums.fill_(float("nan"))
                dparam.fill_(float("nan"))
                dx.fill_(float("nan"))
                code = call()
                want = 0 if name.endswith("parent") else (
                    CLUSTER_LAUNCHED if name.startswith("stats") else FLAT_LAUNCHED)
                if code != want:
                    raise SystemExit(f"{name} {shape} {tag}: returned {code}")
                torch.cuda.synchronize()
                what = f"{name} {shape} {act} {tag}"
                if "_cut_" in name:  # a body with parts cut out: its results are wrong
                    errs[name] = float("nan")
                elif name.startswith("stats"):
                    assert_close(sums, rsums, *tol, f"{what} sums")
                    assert_close(dparam, rdparam, *tol, f"{what} dparam")
                    errs[name] = max(max_err(sums, rsums), max_err(dparam, rdparam))
                else:
                    assert_close(dx, rdx, *tol, what)
                    errs[name] = max_err(dx, rdx)
            times = {}
            for name in list(calls) + list(calls)[::-1]:
                times[name] = min(times.get(name, math.inf), cuda_ms(calls[name]))
            for name, ms in times.items():
                totals.setdefault(tag, {}).setdefault(name, 0.0)
                totals[tag][name] += ms
                if "_cut_" not in name:
                    worst = worst_err.setdefault(tag, {})
                    worst[name] = max(worst.get(name, 0.0), errs[name])
            print(json.dumps({"shape": shape, "groups": groups, "act": act, "dtype": tag,
                              "us": {k: round(v * 1e3, 3) for k, v in times.items()},
                              "max_abs_err": errs}), flush=True)
    print(json.dumps({"total_ms": totals, "max_abs_err": worst_err, "shapes": len(shapes),
                      "ptxas": ptxas_rows(report)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
