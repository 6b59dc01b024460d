#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tango_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --detail   # also one line per kernel shape

Phases, one short JSON line each:
  device   the card's name and power limit;
  build    nvcc of tango_tpu_torch/csrc/*.cu into build/ (or the cached library);
  model    full-width Tango (TANGO_UNET, FLAN-T5-Large encoder, TANGO_VAE,
           TANGO_HIFIGAN, SD-2.1 DDPM) with seeded random bf16 weights;
  warmup   one 1-step generate (first-use costs of cuDNN and cuBLAS);
  slice    generate("a dog barks", steps=10) and a 3-prompt generate_for_batch
           with batch_size=2 (tail padding), launch counters and recorded
           shapes zeroed just before and read just after: every kernel must
           have launched;
  per_eval launches of each kernel in one UNet evaluation;
  kernels  every kernel against its plain PyTorch version at every shape the
           slice launched it at, in f32 (atol 2e-5, rtol 1e-4; the stats
           partial sums rtol 1e-4 alone) and bf16 (GroupNorm atol 2e-2, rtol
           2e-2; attention atol 4e-3, rtol 1e-2), plus the attention
           extreme-logit and underflow cases; kernel, plain and library
           device times per call (bf16 inputs; 10 calls captured in a CUDA
           graph, median of 10 replays between CUDA events), summed over the
           kernel's shapes.
The last three lines are the card's `nvidia-smi` name and power limit, the
`kernels` JSON, and the result line. Any failure exits non-zero before the
result line; so does a card-less machine. The script writes nothing but
build/ and stops itself after 720 s.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

DEADLINE_S = 720
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS = 989e12         # dense tensor-core bf16
F32_FLOPS = 67e12           # f32 outside the tensor cores
PROMPT = "a dog barks"
BATCH_PROMPTS = ["a dog barks", "rain on a tin roof", "an engine idles"]
STEPS = 10
DEVICE = "cuda"


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, per_graph: int = 10) -> float:
    """Device time of one call of `fn`: `per_graph` calls are captured in a CUDA
    graph, so that no host time (Python, the wrapper's checks, the launch
    itself) falls between them; the median over `reps` replays, each between
    two CUDA events, divided by `per_graph`."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def assert_close(out, ref, atol, rtol, what) -> float:
    """Raise unless the kernel's output is finite and within tolerance of
    its plain version's; return the max abs error."""
    ok = ((out.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all().item()
    if not ok or not torch.isfinite(out.float()).all().item():
        raise AssertionError(f"{what}: kernel disagrees with its plain version "
                             f"(max abs err {max_err(out, ref):.3g})")
    return max_err(out, ref)


class KernelCase:
    """One kernel checked and timed at the shapes the census recorded."""

    def __init__(self, name):
        self.name = name
        self.err = {"f32": 0.0, "bf16": 0.0}
        self.ms = self.plain_ms = self.bound = 0.0
        self.library_ms = None
        self.bound_share = {"bytes": 0.0, "operations": 0.0}
        self.detail = []

    @property
    def bound_by(self):
        return max(self.bound_share, key=self.bound_share.get)

    def add_err(self, tag, err):
        self.err[tag] = max(self.err[tag], err)

    def add_time(self, ms, plain_ms, lib_ms, bound, by, shape):
        """Times of one call at one shape; the case's totals are over its shapes."""
        self.ms += ms
        self.plain_ms += plain_ms
        if lib_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + lib_ms
        self.bound += bound
        self.bound_share[by] += bound
        self.detail.append(dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bound, bound_by=by))


def check_kernels(ops, shapes: dict, detail: bool):
    """Hold every kernel against its plain version at `shapes` (kernel name ->
    the argument shapes the main path launched it at) and time it there."""
    from tango_tpu_torch.ops.flash_attention import attn_fwd_plain
    from tango_tpu_torch.ops.gn_silu import gn_apply_plain, gn_silu_fwd_plain, gn_stats_plain

    K = ops.KERNELS
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    dev = DEVICE

    def randn(*shape, dtype=torch.float32, scale=1.0, loc=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + loc).to(dtype)

    cases = {n: KernelCase(n) for n in K}
    tol = {"f32": (2e-5, 1e-4), "bf16": (2e-2, 2e-2)}
    # bf16 attention: outputs of unit-variance q, k, v are ~sqrt(e / Skv), at
    # most ~0.5, and the kernel and its plain version differ by one bf16 step
    # of the output (2e-3 measured, PERF.md); GroupNorm outputs reach ~5
    attn_tol = {"f32": (2e-5, 1e-4), "bf16": (4e-3, 1e-2)}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    for shape, groups, act in sorted(shapes["gn_silu_fwd"], key=str):
        c = shape[1]
        g, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0, loc=0.5)
            out = K["gn_silu_fwd"](x, g, b, groups, 1e-5, act)
            ref = gn_silu_fwd_plain(x, g, b, groups, 1e-5, act)
            cases["gn_silu_fwd"].add_err(tag, assert_close(out, ref, *tol[tag],
                                                           f"gn_silu_fwd {shape} {tag}"))
        n = math.prod(shape)
        gl, bl = g.to(x.dtype), b.to(x.dtype)

        def lib():
            y = F.group_norm(x, groups, gl, bl, 1e-5)
            return F.silu(y) if act == "silu" else y

        cases["gn_silu_fwd"].add_time(
            cuda_ms(lambda: K["gn_silu_fwd"](x, g, b, groups, 1e-5, act)),
            cuda_ms(lambda: gn_silu_fwd_plain(x, g, b, groups, 1e-5, act)),
            cuda_ms(lib), *bound_ms(4 * n + 8 * c, 8 * n, F32_FLOPS), [shape, groups, act])

    for shape, groups, chunks in sorted(shapes["gn_stats"], key=str):
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0, loc=0.5)
            out = K["gn_stats"](x, groups, chunks)
            ref = gn_stats_plain(x, groups, chunks)
            # partial sums of up to ~10^5 terms: relative tolerance only
            cases["gn_stats"].add_err(tag, assert_close(out, ref, 0.0, 1e-4,
                                                        f"gn_stats {shape} {tag}"))
        n = math.prod(shape)
        cases["gn_stats"].add_time(
            cuda_ms(lambda: K["gn_stats"](x, groups, chunks)),
            cuda_ms(lambda: gn_stats_plain(x, groups, chunks)), None,
            *bound_ms(2 * n + 8 * shape[0] * groups * chunks, 3 * n, F32_FLOPS),
            [shape, groups, chunks])

    for shape, act in sorted(shapes["gn_apply"], key=str):
        bsz, c = shape[0], shape[1]
        a, bb = randn(bsz, c, scale=0.3, loc=1.0), randn(bsz, c, scale=0.1)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0)
            out = K["gn_apply"](x, a, bb, act)
            ref = gn_apply_plain(x, a, bb, act)
            cases["gn_apply"].add_err(tag, assert_close(out, ref, *tol[tag],
                                                        f"gn_apply {shape} {tag}"))
        n = math.prod(shape)
        cases["gn_apply"].add_time(
            cuda_ms(lambda: K["gn_apply"](x, a, bb, act)),
            cuda_ms(lambda: gn_apply_plain(x, a, bb, act)), None,
            *bound_ms(4 * n + 16 * bsz * c, 6 * n, F32_FLOPS), [shape, act])

    for qshape, kshape in sorted(shapes["attn_fwd"], key=str):
        bh, sq, d = qshape
        skv = kshape[1]
        scale = d**-0.5
        for tag, dt in dtypes.items():
            q, k, v = (randn(*s, dtype=dt) for s in (qshape, kshape, kshape))
            out = K["attn_fwd"](q, k, v, scale)
            ref = attn_fwd_plain(q, k, v, scale)
            cases["attn_fwd"].add_err(tag, assert_close(out, ref, *attn_tol[tag],
                                                        f"attn_fwd {qshape} {tag}"))
        q4, k4, v4 = (t.reshape(1, bh, -1, d) for t in (q, k, v))
        cases["attn_fwd"].add_time(
            cuda_ms(lambda: K["attn_fwd"](q, k, v, scale)),
            cuda_ms(lambda: attn_fwd_plain(q, k, v, scale)),
            cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)),
            *bound_ms(2 * (2 * bh * sq * d + 2 * bh * skv * d), 4 * bh * sq * skv * d,
                      BF16_FLOPS),
            [qshape, kshape])

    # the extreme-logit window and the underflow row (tests/test_flash_attention.py)
    for tag, dt in dtypes.items():
        for sign, ck0, want_zero in ((1.0, 220.0, False), (-1.0, 220.0, False),
                                     (-1.0, 480.0, True)):
            u = randn(64)
            u = u / u.norm()
            cq = 2.0 + 0.2 * torch.rand(128, 1, generator=gen, device=dev)
            ck = ck0 + 8.0 * torch.rand(256, 1, generator=gen, device=dev)
            q = (cq * u + 0.01 * randn(128, 64))[None].to(dt)
            k = (sign * ck * u + 0.01 * randn(256, 64))[None].to(dt)
            v = randn(1, 256, 64, dtype=dt)
            out = K["attn_fwd"](q, k, v, 0.125)
            ref = attn_fwd_plain(q, k, v, 0.125)
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"attn_fwd extreme logits {sign} {ck0} {tag}: not finite")
            if want_zero:
                if out.abs().max().item() != 0.0:
                    raise AssertionError(f"attn_fwd underflow {tag}: rows are not zero")
            else:
                atol, rtol = (5e-5, 1e-3) if tag == "f32" else attn_tol[tag]
                cases["attn_fwd"].add_err(tag, assert_close(
                    out, ref, atol, rtol, f"attn_fwd extreme logits {sign} {tag}"))

    if detail:
        for case in cases.values():
            for row in case.detail:
                log("kernel_shape", name=case.name, **row)
    return cases


def main(argv) -> int:
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    detail = "--detail" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from tango_tpu_torch import configs as C
    from tango_tpu_torch import ops
    from tango_tpu_torch.ops import _build
    from tango_tpu_torch.pipeline import Tango

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 versions stay f32

    smi = nvidia_smi()
    log("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    _build.load()
    log("build", seconds=round(_build.build_info["seconds"], 3),
        reused=_build.build_info["reused"], library=os.path.basename(_build.build_info["path"]))

    t0 = time.perf_counter()
    tango = Tango.from_components(
        unet_config=C.TANGO_UNET, vae_config=C.TANGO_VAE, t5_config=C.FLAN_T5_LARGE,
        hifigan_config=C.TANGO_HIFIGAN, scheduler_config=C.SD21_SCHEDULER, device=DEVICE,
        init_seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (tango.model.unet, tango.t5, tango.vae, tango.vocoder)
                   for p in m.parameters())
    log("model", seconds=round(time.perf_counter() - t0, 3), params=n_params,
        dtype=str(tango.dtype))

    t0 = time.perf_counter()
    tango.generate("warm up", steps=1, seed=1)
    torch.cuda.synchronize()
    log("warmup", seconds=round(time.perf_counter() - t0, 3))

    # ---- the main path, counted
    checks = {"latents_finite": True, "mel_finite": True}
    sample_times = {}  # CFG batch of the UNet -> [seconds, steps]
    decode, sample = tango.decode, tango.model.sample

    def checked_decode(latents):
        checks["latents_finite"] &= bool(torch.isfinite(latents).all())
        mel, wav = decode(latents)
        checks["mel_finite"] &= bool(torch.isfinite(mel.float()).all())
        return mel, wav

    def timed_sample(*a, **kw):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = sample(*a, **kw)
        torch.cuda.synchronize()
        rec = sample_times.setdefault(2 * out.shape[0], [0.0, 0])
        rec[0] += time.perf_counter() - s0
        rec[1] += kw["num_steps"]
        return out

    tango.decode, tango.model.sample = checked_decode, timed_sample
    ops.reset_counters()
    t0 = time.perf_counter()
    wav = tango.generate(PROMPT, steps=STEPS, guidance=3.0, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    wavs = tango.generate_for_batch(BATCH_PROMPTS, steps=STEPS, batch_size=2, seed=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    shapes = {n: set(fn.shapes) for n, fn in ops.KERNELS.items()}
    tango.decode, tango.model.sample = decode, sample

    expect_len = tango.model.latent_t_size * 4 * 160 + 32  # 4x VAE, x160 vocoder, +32 edge
    outs = [wav] + list(wavs)
    problems = []
    if len(wavs) != len(BATCH_PROMPTS):
        problems.append(f"{len(wavs)} waveforms for {len(BATCH_PROMPTS)} prompts")
    for w in outs:
        if w.dtype.name != "int16" or w.shape != (expect_len,):
            problems.append(f"waveform {w.dtype} {w.shape}, expected int16 ({expect_len},)")
        if int(abs(w.astype("int32")).max()) == 0:
            problems.append("a silent waveform")
    if not (checks["latents_finite"] and checks["mel_finite"]):
        problems.append(f"non-finite values: {checks}")
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        problems.append(f"kernels never launched on the main path: {idle}")
    log("slice", generate_s=round(t1 - t0, 3), generate_for_batch_s=round(t2 - t1, 3),
        ms_per_unet_step={f"cfg_batch_{b}": round(1e3 * s / n, 3)
                          for b, (s, n) in sorted(sample_times.items())},
        launches=launches, shapes={n: len(v) for n, v in shapes.items()}, wav_len=expect_len,
        peak=[int(abs(w.astype("int32")).max()) for w in outs], problems=problems)
    if problems:
        raise AssertionError("; ".join(problems))

    # ---- launches in one UNet evaluation (CFG batch of one prompt)
    unet, m = tango.model.unet, tango.model
    lat = torch.randn(2, m.latent_t_size, m.latent_f_size, unet.cfg.in_channels, device=DEVICE)
    ctx = torch.randn(2, tango.max_text_length, unet.cfg.cross_attention_dim, device=DEVICE,
                      dtype=tango.dtype)
    mask = torch.ones(2, tango.max_text_length, dtype=torch.long, device=DEVICE)
    ops.reset_counters()
    with torch.inference_mode():
        unet(lat, torch.tensor([999, 999], device=DEVICE), ctx, mask)
    torch.cuda.synchronize()
    per_eval = {n: fn.launches for n, fn in ops.KERNELS.items()}
    log("per_eval", launches=per_eval, group_norms=per_eval["gn_silu_fwd"] + per_eval["gn_stats"])

    t0 = time.perf_counter()
    cases = check_kernels(ops, shapes, detail)
    log("kernels", seconds=round(time.perf_counter() - t0, 3),
        total_s=round(time.perf_counter() - t_start, 3),
        **{n: {"err_f32": c.err["f32"], "err_bf16": c.err["bf16"], "ms": c.ms,
               "plain_ms": c.plain_ms, "library_ms": c.library_ms, "bound_ms": c.bound,
               "shapes": len(c.detail)} for n, c in cases.items()})

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": ops.KERNELS[n].source,
         "replaces": ops.KERNELS[n].replaces, "launches": launches[n],
         "max_abs_err": max(c.err.values()), "ms": c.ms, "plain_ms": c.plain_ms,
         "bound_ms": c.bound, "bound_by": c.bound_by, "library_ms": c.library_ms}
        for n, c in cases.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
