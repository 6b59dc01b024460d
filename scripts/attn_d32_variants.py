"""Time attn_fwd's tensor-core body at head dim 32 against variants of itself
on one CUDA card.

    python3 scripts/attn_d32_variants.py [--parent DIR]

Each variant is a copy of csrc/attention_tc.cu with a few text edits (each
must match once), built with csrc/attention.cu by nvcc into a library of
its own (all builds started together): a deeper K/V ring (3 or 4 stages
instead of 2), 3 blocks an SM instead of 2 at D = 32 (its __launch_bounds__;
a build that ptxas refuses is reported, not timed), 64-key f32 tiles instead of 32,
and the skewed warpgroup schedule (below). Each is called through its C
entry point tt_attn_fwd, which must report the tensor-core body, and held
against attn_fwd_plain at AudioLDM's four D = 32 shapes (the FiLM UNet's
ds = 2 and ds = 4 levels at CFG batch 6 and 2) and at ragged shapes, in
bf16 (atol 4e-3, rtol 1e-2) and f32 (2e-5, 1e-4); then timed there: device
time per call, 10 calls in a CUDA graph, median of 10 replays
(chip_smoke.cuda_ms), the variants in turns forward and backward, the
better of the two, beside the CUDA-core body of the same library
(tt_attn_fwd_core) and F.scaled_dot_product_attention.

With --parent DIR (a directory holding another tree's csrc/, as `git
archive <commit> tango_tpu_torch/csrc` unpacks it), that tree's two files
are built as one more library, and the head-dim-64 bodies of both are held
to the plain versions and timed in turns: attn_fwd at the serving path's
self-attention shapes (CFG batch 2 and 4; f32 at batch 2, the trainer's),
attn_fwd_v2 at the long clip's (8192 tokens, CFG batch 2) and
attn_fwd_bias at the long prompt's (256 keys, one padding row a batch row,
CFG batch 2), and their SASS compared (cuobjdump -sass, addresses and
constants blanked): instructions in each and lines that differ. Prints one
JSON line per shape and type, then the sums by variant and type, and the
registers and spill bytes ptxas reports for each variant's kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import math
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import assert_close, cuda_ms, nvidia_smi  # noqa: E402
from tango_tpu_torch.ops import TC_LAUNCHED, _build  # noqa: E402
from tango_tpu_torch.ops.flash_attention import (  # noqa: E402
    _qscale,
    attn_fwd_bias_plain,
    attn_fwd_plain,
    attn_fwd_v2_plain,
)

SRC = os.path.join(ROOT, "tango_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "attn_d32_variants")
STAGES = "constexpr int kStages = 2;"
# The skewed schedule of the bf16 body at D = 32 (FlashAttention-3's
# ping-pong through the one barrier a tile): warpgroup 1 runs half a tile
# behind warpgroup 0, so one warpgroup's softmax runs while the other's
# products do; tiles t - 1 and t are in use at step t, so the copies run
# kStages - 2 tiles ahead.
SKEW_FIRST = r"""#define TT_OUT8(i) \
  "=&f"(d[i]), "=&f"(d[i + 1]), "=&f"(d[i + 2]), "=&f"(d[i + 3]), "=&f"(d[i + 4]), \
      "=&f"(d[i + 5]), "=&f"(d[i + 6]), "=&f"(d[i + 7])

// The same for the first k-step, which overwrites d (scale-d 0): d is an
// output only, so the compiler keeps none of its old values alive for it.
__device__ __forceinline__ void wgmma_qk_first(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : TT_OUT8(0), TT_OUT8(8), TT_OUT8(16), TT_OUT8(24), TT_OUT8(32), TT_OUT8(40),
        TT_OUT8(48), TT_OUT8(56)
      : "l"(a), "l"(b), "r"(0));
}

"""
SKEW_LOOP = r"""    // Warpgroup 1 runs half a tile behind warpgroup 0: at step t warpgroup 0
    // issues S of tile t, then takes its softmax and O += P V; warpgroup 1
    // first takes the softmax and P V of tile t - 1, whose S it issued at the
    // end of step t - 1 (left in flight across the barrier), then issues S of
    // tile t. So one warpgroup's softmax runs while the other's products do,
    // with one barrier a step as before. Tiles t - 1 and t are in use at step
    // t, so the copies run kStages - 2 tiles ahead.
    float s[64];
    auto issue_s = [&](int j) {
      const uint64_t dk = smem_desc(sK + (j % kStages) * kT, 16, 8 * kRowBytes, G::kLayout);
      wgmma_fence();
      wgmma_qk_first(s, dq, dk);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, 1);
      wgmma_commit();
    };
    auto finish = [&](int j) {  // S of tile j issued: its softmax and O += P V
      wgmma_wait_all();
      fence_regs(s);
      const int lim = Skv - j * kKeys;
      if (lim < kKeys) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (8 * (i >> 2) + 2 * t4 + (i & 1) >= lim) s[i] = -CUDART_INF_F;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = exp2f(fminf(s[i] - kShift, kClamp));
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        l0 += s[4 * b] + s[4 * b + 1];
        l1 += s[4 * b + 2] + s[4 * b + 3];
      }
      uint32_t p[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        fence_regs(p[kk]);
      }
      fence_regs(acc);
      const uint64_t dv =
          smem_desc(sV + (j % kStages) * kT, 8 * kRowBytes, 8 * kRowBytes, G::kLayout);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_pv(acc, p[kk], dv + kk * (16 * kRowBytes >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    };
    for (int t = 0; t <= n_tiles; ++t) {
      cp_async_wait<kAhead - 1>();
      fence_async_proxy();
      // tile t is in shared memory, visible to wgmma; every thread is done
      // with tile t - 2, whose slot the next copy may refill
      __syncthreads();
      if (t + kAhead < n_tiles) load_kv(t + kAhead);
      cp_async_commit();
      if (wg == 0) {
        if (t < n_tiles) {
          issue_s(t);
          finish(t);
        }
      } else {
        if (t > 0) finish(t - 1);
        if (t < n_tiles) issue_s(t);
      }
    }
  } else {
"""
LOOP_HEAD = """  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j % kStages;
    cp_async_wait<kStages - 2>();"""
LOOP_TAIL = """    wgmma_wait_all();
    fence_regs(acc);
  }

  l0 = quad_sum(l0);"""
SKEW = [
    (STAGES, "constexpr int kStages = 4;"),
    ("// The online (and biased) softmax step on a thread's",
     SKEW_FIRST + "// The online (and biased) softmax step on a thread's"),
    ("  const uint32_t sQ = base, sK = base + kT, sV = sK + kStages * kT;",
     "  const uint32_t sQ = base, sK = base + kT, sV = sK + kStages * kT;\n"
     "  constexpr bool kSkew = MODE == kStatic && D == 32;\n"
     "  constexpr int kAhead = kSkew ? kStages - 2 : kStages - 1;"),
    ("  for (int j = 0; j < kStages - 1; ++j) {\n    if (j < n_tiles) load_kv(j);",
     "  for (int j = 0; j < kAhead; ++j) {\n    if (j < n_tiles) load_kv(j);"),
    (LOOP_HEAD, "  if constexpr (kSkew) {\n" + SKEW_LOOP + LOOP_HEAD),
    (LOOP_TAIL, LOOP_TAIL.replace("  }\n\n", "  }\n  }\n\n")),
]
# name -> [(text, replacement)]: the body as it is, and one change each
VARIANTS = {
    "base": [],
    "stages_3": [(STAGES, "constexpr int kStages = 3;")],
    "stages_4": [(STAGES, "constexpr int kStages = 4;")],
    "blocks_3": [("__global__ void __launch_bounds__(kThreads, kMinBlocks)",
                  "__global__ void __launch_bounds__(kThreads, D == 32 ? 3 : kMinBlocks)")],
    "f32_keys_64": [
        ("  static constexpr int NC = 32;", "  static constexpr int NC = 64;"),
        ('  static_assert(NC == D, "S and P V share the cross-term accumulator");\n', ""),
        ("    float s[NC / 2], e[NC / 2];", "    float s[NC / 2], e[NC / 2], ev[D / 2];"),
        ("mma_tf32x3_rs<NC, D>(acc, e, a, sV);", "mma_tf32x3_rs<NC, D>(acc, ev, a, sV);"),
        ("    fence_regs(e);\n#pragma unroll\n    for (int i = 0; i < D / 2; ++i) acc[i] += e[i];",
         "    fence_regs(ev);\n#pragma unroll\n"
         "    for (int i = 0; i < D / 2; ++i) acc[i] += ev[i];"),
    ],
    "skew": SKEW,
}
# (BH, Sq, Skv): AudioLDM's text_to_audio (CFG batch 6: 8 and 12 heads) and
# style transfer (CFG batch 2), self-attention
PATH_32 = ((48, 1024, 1024), (72, 256, 256), (16, 1024, 1024), (24, 256, 256))
RAGGED_32 = ((6, 200, 333), (2, 300, 77), (1, 128, 128))
# the serving path's D = 64 self-attention: levels 0-2 (5, 10, 20 heads) at CFG
# batch 2 and 4 (f32 at batch 2); the long clip's level 0 (attn_fwd_v2); the
# long prompt's cross-attention to 256 keys (attn_fwd_bias): (form, BH, Sq, Skv)
PATH_64 = {"bf16": (("static", 10, 4096, 4096), ("static", 20, 1024, 1024),
                    ("static", 40, 256, 256), ("static", 20, 4096, 4096),
                    ("static", 40, 1024, 1024), ("static", 80, 256, 256),
                    ("online", 10, 8192, 8192), ("bias", 10, 4096, 256),
                    ("bias", 20, 1024, 256), ("bias", 40, 256, 256)),
           "f32": (("static", 10, 4096, 4096), ("static", 20, 1024, 1024),
                   ("static", 40, 256, 256), ("online", 10, 8192, 8192),
                   ("bias", 10, 4096, 256), ("bias", 20, 1024, 256), ("bias", 40, 256, 256))}
ENTRY = {"static": "tt_attn_fwd", "online": "tt_attn_fwd_v2", "bias": "tt_attn_fwd_bias"}
TOL = {"bf16": (4e-3, 1e-2), "f32": (2e-5, 1e-4)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build(parent: str | None) -> tuple[dict, dict]:
    """Each variant's library (loaded; none where nvcc refused it), and
    ptxas's (registers, spill bytes) of its tensor-core kernels, or the
    error that stopped the build."""
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    with open(os.path.join(SRC, "attention_tc.cu")) as f:
        base = f.read()
    jobs = {}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old[:50]!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        src = os.path.join(OUT, f"{name}_attention_tc.cu")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (SRC, src)
    if parent:
        jobs["parent"] = (parent, os.path.join(parent, "attention_tc.cu"))
    procs = {}
    for name, (inc, tc_src) in jobs.items():
        lib = os.path.join(OUT, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", inc, "-Xptxas", "-v", "-shared",
               "-o", lib, os.path.join(inc, "attention.cu"), tc_src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs, regs = {}, {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            regs[name] = {"error": [l for l in log.splitlines() if "fatal" in l or "error" in l]}
            continue
        regs[name] = ptxas_rows(log)
        handle = ctypes.CDLL(lib)
        for fn in (*ENTRY.values(), "tt_attn_fwd_core"):
            if hasattr(handle, fn):
                getattr(handle, fn).argtypes = _build._SIGNATURES[fn]
        libs[name] = handle
    return libs, regs


def ptxas_rows(report: str) -> dict:
    """{kernel: [registers, spill bytes]} of the tensor-core attention kernels."""
    rows, kernel, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            kernel = name if "attn_tc" in name else None
        elif kernel and "spill stores" in line:
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif kernel and "Used" in line and "registers" in line:
            rows[kernel] = [int(re.search(r"Used (\d+) registers", line).group(1)), spill]
            kernel = None
    return rows


def sass(lib: str) -> dict:
    """{kernel: its instructions} of a library (cuobjdump -sass), each
    instruction with its address and hex constants blanked."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    parts = re.split(r"\n\s+Function : (\S+)\n", out)
    kernels = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        kernels[name] = [re.sub(r"0x[0-9a-f]+", "X", m.group(1)) for m in
                         re.finditer(r"/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", body)]
    return kernels


def sass_diff(parent: str, base: str) -> dict:
    """For each head-dim-64 tensor-core kernel (3 forms, bf16 and f32): the
    instructions in the parent's library and in this tree's, and the lines
    that differ between them."""
    a, b = sass(parent), sass(base)
    out = {}
    for body in ("attn_tc_kernel", "attn_tc_f32_kernel"):
        for mode in range(3):
            la = next(v for k, v in a.items() if f"{body}ILi{mode}EE" in k)
            lb = next(v for k, v in b.items() if f"{body}ILi{mode}ELi64EE" in k)
            diff = difflib.unified_diff(la, lb, lineterm="", n=0)
            out[f"{body}<{mode}, 64>"] = [len(la), len(lb),
                                          sum(1 for x in diff if x[:1] in "+-") - 2 * (la != lb)]
    return out


def call(lib, fn, q, k, v, o, scale, bias=None):
    """The C entry point fn of lib on (BH, S, D) heads; with a bias (B, 1,
    Skv), tt_attn_fwd_bias over BH / B heads a batch row."""
    bh, sq, d = q.shape
    dims = (bh, sq, k.shape[1], d)
    tail = (_qscale(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if bias is None:
        return getattr(lib, fn)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *dims,
                                *tail)
    return getattr(lib, fn)(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                            o.data_ptr(), *dims, bh // bias.shape[0], 1, *tail)


def run_shape(libs, names, bh, sq, skv, d, tag, gen, time_it, core=None, form="static"):
    """Check each of `names` at one shape and type in one form; time them in
    turns if `time_it` (with the CUDA-core body of `core` and sdpa beside)."""
    dt = DTYPES[tag]
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(dt) for s in (sq, skv, skv))
    scale = d**-0.5
    bias = None
    if form == "bias":  # 2 batch rows, the first 40 and 43 keys open
        keep = torch.tensor([40, 43], device="cuda")[:, None, None]
        bias = torch.where(torch.arange(skv, device="cuda") < keep, 0.0, -10000.0)
        ref = attn_fwd_bias_plain(q, k, v, bias, bh // 2, scale)
    else:
        ref = (attn_fwd_plain if form == "static" else attn_fwd_v2_plain)(q, k, v, scale)
    fn = ENTRY[form]
    o = torch.empty_like(q)
    errs = {}
    for name in names:
        o.fill_(float("nan"))
        code = call(libs[name], fn, q, k, v, o, scale, bias)
        want = TC_LAUNCHED if (d == 64 or name != "parent") else 0
        if code != want:
            raise SystemExit(f"{name} {form} {(bh, sq, skv, d)} {tag}: returned {code}, "
                             f"expected {want}")
        errs[name] = assert_close(o, ref, *TOL[tag], f"{name} {form} {(bh, sq, skv, d)} {tag}")
    row = {"form": form, "shape": [bh, sq, skv, d], "dtype": tag, "max_abs_err": errs}
    if time_it:
        times = {}
        for name in list(names) + list(names)[::-1]:
            ms = cuda_ms(lambda: call(libs[name], fn, q, k, v, o, scale, bias))
            times[name] = min(times.get(name, math.inf), ms)
        if core:
            times["core_body"] = cuda_ms(
                lambda: call(libs[core], "tt_attn_fwd_core", q, k, v, o, scale))
        q4, k4, v4 = (t.reshape(1, bh, -1, d) for t in (q, k, v))
        if bias is None:
            times["sdpa"] = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                           scale=scale))
        row["ms"] = times
    print(json.dumps(row), flush=True)
    return row


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a directory holding another tree's csrc/")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_d32_variants: no CUDA device", file=sys.stderr)
        return 2
    parent = os.path.join(args.parent, "tango_tpu_torch", "csrc") if args.parent else None
    libs, regs = build(parent)
    print(json.dumps({"card": nvidia_smi(), "ptxas": regs}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    names = [n for n in VARIANTS if n in libs]
    totals = {}
    for tag in DTYPES:
        for bh, sq, skv in RAGGED_32:
            run_shape(libs, names, bh, sq, skv, 32, tag, gen, False)
        for bh, sq, skv in PATH_32:
            row = run_shape(libs, names, bh, sq, skv, 32, tag, gen, True, core="base")
            for name, ms in row["ms"].items():
                totals.setdefault(f"d32_{tag}", {}).setdefault(name, 0.0)
                totals[f"d32_{tag}"][name] += ms
        if parent:
            for form, bh, sq, skv in PATH_64[tag]:
                row = run_shape(libs, ["parent", "base"], bh, sq, skv, 64, tag, gen, True,
                                form=form)
                for name, ms in row["ms"].items():
                    totals.setdefault(f"d64_{form}_{tag}", {}).setdefault(name, 0.0)
                    totals[f"d64_{form}_{tag}"][name] += ms
    print(json.dumps({"total_ms": totals}), flush=True)
    if parent:
        print(json.dumps({"sass_parent_base": sass_diff(os.path.join(OUT, "parent.so"),
                                                        os.path.join(OUT, "base.so"))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
