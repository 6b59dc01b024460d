#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tango_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --detail   # also one line per kernel shape

Phases, one short JSON line each:
  device   the card's name and power limit;
  build    nvcc of tango_tpu_torch/csrc/*.cu into build/ (or the cached library),
           one nvcc per source, all started together, then one link;
  model    full-width Tango (TANGO_UNET, FLAN-T5-Large encoder, TANGO_VAE,
           TANGO_HIFIGAN, SD-2.1 DDPM) with seeded random bf16 weights;
  warmup   one 1-step generate (first-use costs of cuDNN and cuBLAS);
  slice, long_clip, long_prompt
           the serving paths, each with launch counters and recorded shapes
           zeroed just before it and read just after, and each with its own
           list of kernels that must have launched (PATH_KERNELS):
           slice: generate("a dog barks", steps=10) and a 3-prompt
           generate_for_batch with batch_size=2 (tail padding);
           long_clip: generate(duration=20.0), 512 latent frames, 8192 tokens
           at the UNet's first level, which take attn_fwd_v2;
           long_prompt: generate with max_text_length = 256, whose masked
           cross-attention takes attn_fwd_bias. Each new path is warmed up
           by one uncounted 1-step generate first. On every serving path
           (these, snapshot, int8, int8_conv) each attn_fwd / attn_fwd_v2 /
           attn_fwd_bias launch is bf16 at head dim 64 and must have taken
           the tensor-core body (tc_launches == launches); on every counted
           path (these, snapshot, int8, int8_conv and train) each gn_silu_fwd
           launch must have taken its thread-block-cluster body
           (cluster_launches == launches);
  snapshot, snapshot_cli
           between slice and long_clip: the slice pipeline's weights written
           as a full-width reference-format snapshot under build/ (the main
           bin through the port's save_main_bin, f32 under the reference's
           names; the VAE decoder and the vocoder, weight-normed, under
           AudioLDM's; main, vae (with a ddconfig block), unet and stft
           configs), its bytes and write seconds; Tango(dir) on the card in
           bf16 with the default tokenizer (which must warn) and
           cast_params=True, its cold start in seconds; every UNet, T5 and
           VAE parameter bit-equal to the slice pipeline's and every vocoder
           parameter within one bf16 step (the weight-norm fold; the count
           that differ logged); then path `snapshot`, counted:
           generate("a dog barks", steps=10, seed=0) with the serving path's
           kernels (PATH_KERNELS, the tensor-core and cluster bodies), its
           final latents equal to the slice's first at the same seed (max
           abs difference 0), the waveform's largest int16 difference
           logged; then, uncounted, `python -m tango_tpu_torch.inference`'s
           main on the snapshot (3 prompts, 2 steps, batch 2), which must
           write three non-silent 163872-sample int16 WAVs and one
           summary.jsonl record; the pipeline freed, the phase's seconds
           and the smoke's total_s so far logged. The snapshot's VAE bin
           also holds a seeded random encoder and quant_conv (released
           snapshots ship them; serving skips them, the trainers need them);
  serve_http, train_cli, dpo
           the entry points on the same snapshot, each counted on its own
           (the counters zeroed just before it and read just after; every
           attention launch on its tensor-core body, every gn_silu_fwd and
           gn_silu_bwd on its cluster body), the directory deleted after:
           serve_http: serve.BatchingPredictor(max_batch=4) set up on the
           snapshot (bf16; the load and the two warm-ups timed) behind
           serve_http on 127.0.0.1 at port 0; GET /healthz; 4 concurrent
           unseeded POST /generate at STEPS steps, which must ride one
           predict_batch and one generate_for_batch of batch 4; one seeded
           request, whose WAV must equal generate at that seed sample for
           sample; two bad bodies, 400; every response a non-silent 16 kHz
           mono int16 WAV of the clip's length; the latencies logged.
           train_cli: train/cli.py's main on 8 synthetic WAVs
           (--tango_snapshot and --hf_model the snapshot, batch 2,
           accumulation 2, 2 updates, one epoch, best): the args and one
           epoch record with finite losses, `best` with the UNet's keys and
           not the snapshot's weights, the micro-steps' ms and the peak
           memory logged. dpo: train/dpo_cli.py's main on a 4-row preference
           manifest (batch 2, accumulation 1, 2 epochs, 1 of them SFT-first,
           a 2-row validation file): one sft and one dpo record with finite
           losses and implicit_acc in [0, 1], `last` and `best`, the
           reference UNet bit-equal to the snapshot's after the run, the ms
           a DPO and an SFT micro-step and the peak memory logged;
  tango2_eval
           on the same snapshot, counted as one path: seeded random
           full-width scorers written in their released formats (a
           LAION-CLAP .pt of RoBERTa-base, HTSAT-tiny and both projections,
           the audio side under `module.`; Cnn14 as {"model": sd}; VGGish),
           each converting back bit-equal, and 4 reference WAVs;
           inference_tango2.main with --clap_ckpt, --reference_dir,
           --cnn14_ckpt and --vggish_ckpt (4 prompts, STEPS steps, batch 4,
           the RoBERTa-id fallback tokenizer, which must warn), then
           inference.main with --num_samples 2 --clap_ckpt (batch 2). The
           record must have JAX's keys (TANGO2_RECORD_KEYS, METRIC_KEYS), a
           finite CLAP score in [-1, 1] and finite metrics but IS (NaN below
           10 clips, as in JAX); every tower's weights on the card; each
           re-ranked WAV its group's argmax of the CLAP similarity recomputed
           here; every attention launch on its tensor-core body and every
           gn_silu_fwd on its cluster body. Then, uncounted, the full-width
           text and audio embeddings, HTSAT's latent map, Cnn14's `2048` and
           `logits` and VGGish's embeddings on the card against the same
           modules on the CPU in f32 (CARD_CPU_LIMITS). The seconds of each CLI, the loads,
           the checkpoints' bytes, the peak memory, the metrics and the
           errors logged;
  int8     the int8 W8A8 serving mode: a full-width Tango.from_components(
           quant="all") built from the bf16 model's state dicts (the same
           weights, quantized once on the card), one uncounted 1-step
           warm-up, then a counted generate("a dog barks", steps=10) at CFG
           batch 2 (PATH_KERNELS["int8"], w8a8_matmul included) with its UNet
           step time, w8a8 launches per evaluation and the relative L2 of
           its final latents against the bf16 slice's at the same seed;
           every w8a8_matmul launch (K % 16 == 0 at every int8 shape) must
           have taken the tensor-core body (tc_launches == launches);
  int8_conv
           an uncounted 2-step generate with quant="conv" (the JAX bench's
           default scope: int8 convolutions on torch._int_mm), which must
           launch no w8a8_matmul;
  int8_order
           the int8 quantize order (cast_params), uncounted: from one seeded
           f32 UNet, quant="all" with cast_params False (JAX's
           from_components: the f32 weights quantized) and True (cast to
           bf16 first); the int8 weights and scales that differ, and the
           relative L2 between one 2-step generate's latents in each order;
  per_eval launches of each kernel in one UNet evaluation, bf16 and int8
           (w8a8_matmul once for every quantized Linear: 16 transformers x 9
           projections, each on the tensor-core body), the device time of
           one evaluation of each (torch.profiler: the kernels' own time,
           no host gaps) with the int8 one's W8A8 kernels and the (M, K, N)
           of its GEMMs, and the 3x3 stride-1 convolution shapes of the bf16
           evaluation, recorded by forward hooks, for winograd_conv3x3, which
           no path calls (in JAX neither);
  train_model, train
           the training path: full-width f32 SFT (TANGO_UNET with remat,
           min-SNR 5, uncondition dropout; the TANGO_VAE encoder and the
           FLAN-T5-Large encoder frozen; seeded random weights) on 8 seeded
           synthetic 10.24 s WAVs written under build/: SFTTrainer.fit with
           batch 2, accumulation 2 and max_train_steps 2 (4 micro-steps), one
           validation batch, the best checkpoint loaded back bit-equal and
           deleted. Counters zeroed just before fit and read just after: the
           seven kernels of training, forward and backward, must have
           launched; every f32 attn_fwd (3xTF32), attn_bwd_dq and attn_bwd_dkv
           launch (head dim 64) must have taken its tensor-core body
           (tc_launches == launches), and every gn_silu_fwd and gn_silu_bwd
           launch its thread-block-cluster body (cluster_launches ==
           launches). Every
           loss must be finite, and
           the parameters must change after the 2nd and 4th micro-step only;
  kernels  every kernel against its plain PyTorch version at every shape
           any path launched it at, in f32 and bf16. Forward kernels: f32
           atol 2e-5, rtol 1e-4 (the stats partial sums rtol 1e-4 alone),
           bf16 GroupNorm atol 2e-2, rtol 2e-2 and attention atol 4e-3, rtol
           1e-2, plus the attention extreme-logit cases (the static-shift
           window and its underflow row; v2 past the window) and a fully
           masked batch row for the bias kernel (f32 atol 1e-3 on that row).
           At head dim 64 the forward kernels run tensor-core bodies, all
           three in bf16 and in f32 (3xTF32). Every call is checked at
           every launched shape and must take the body `tc_body` names; the
           tensor-core bodies also at ragged shapes and one 128 x 128 tile
           (TC_SHAPES, in both types) and the biased one at a ragged shape
           with one bias row and with a row a query (BIAS_TC_SHAPES); a
           misaligned view where a tensor-core body runs must raise; both
           types are timed (f32 in the `f32` field), attn_fwd_bias too. f32
           attn_fwd at the training shapes, f32 attn_fwd_v2 at the long
           clip's and f32 attn_fwd_bias at the long prompt's (with a padding
           bias that leaves a quarter of the keys open), with q and k at
           amplitude 3, from two seeds, are held against float64 at 2e-5 /
           1e-4 (phase `fwd_amplitude` logs each one's and its plain
           version's share of the limits).
           Backward kernels: f32 attention atol 1e-4, rtol 1e-3 and GroupNorm
           atol 2e-4, rtol 1e-3, bf16 attention 4e-3 / 1e-2 and GroupNorm
           2e-2 / 2e-2, lse and delta 1e-4 / 1e-3. attn_bwd_dq and
           attn_bwd_dkv run their tensor-core body in f32 and bf16 at head
           dim 64: also checked at a ragged shape (BWD_TC_RAGGED), with q and
           k at amplitude 3 in f32 at the training shapes, in two draws (dq,
           dk, dv against the plain versions and against the same formula in
           float64, at 1e-4 / 1e-3; lse and delta against float64 only:
           there the plain versions' own f32 error reaches ~0.65 of that
           limit; phase `bwd_amplitude` logs all three distances' shares
           and the max-abs and max-rel differences), and against a
           misaligned view, which must raise. gn_silu_fwd at every launched
           shape and gn_silu_bwd at every training shape, in both types,
           each call held to the body `gn_fwd_cluster_size` /
           `gn_bwd_cluster_size` names (all of them the cluster body;
           --detail rows carry each launch's cluster size and CTAs), and
           their streaming bodies at GN_FWD_STREAMING / GN_BWD_STREAMING,
           checked only; gn_silu_fwd's host time per call at HOST_US_SHAPE
           (1000 back-to-back calls, `host_us_per_call`). Then
           one shape past each of the wrappers' old launch limits (LIMIT_*),
           checked, not timed; its gn_silu_fwd and gn_silu_bwd also held to
           their rules.
           Kernel, plain and library device times per call (bf16 inputs, and
           f32 as well for the GroupNorm kernels and the backward kernels;
           10 calls captured in a CUDA graph, median of 10 replays between
           CUDA events), summed over the
           kernel's shapes (--detail: per shape, with TFLOP/s for the
           attention kernels and each shape's share of its bound). The
           library yardsticks: F.group_norm(+F.silu),
           sdpa (with a float mask for the bias kernel), and for the
           backward kernels aten's GroupNorm (and SiLU) backward and the
           attention backward kernels sdpa's autograd runs, called directly.
           w8a8_matmul at every shape the int8 path launched it at and at
           tests/test_quant.py's (300, 320) x (320, 256) (the tensor-core
           body: quantize pass plus s8 wgmma GEMM, timed together), two
           ragged shapes (K % 16 != 0: the __dp4a body) and three ragged
           ones of the tensor-core body (W8A8_TC_RAGGED), checked only: f32
           atol 1e-5 / rtol 1e-5 (the JAX test's), bf16 one bf16 step (1e-2
           / 8e-3); library torch._int_mm on the pre-quantized operands,
           and bf16 F.linear as a note (--detail: per shape, with TOP/s).
           winograd_conv3x3, called directly, at tests/test_winograd.py's
           shapes and at the hooked UNet shapes: both types on the
           tensor-core body (bf16 wgmma, f32 3xTF32), also at a ragged
           shape (WINO_TC_RAGGED, checked only); f32 1e-4 / 1e-4 (the JAX
           test's), bf16 2e-2 / 2e-2; timed as the whole wrapper and, in
           bf16, as the kernel alone, and in f32 beside cuDNN without TF32
           (the `f32` field) (kernel_only_ms: `launch` on a prepared U; with
           --detail both kernels' rows also split one call's device time by
           kernel, `by_kernel_ms`, from torch.profiler), its U kernel
           (`weight_tc`) held within one bf16 step of the torch U in bf16, a
           few ulps in f32; library F.conv2d (cuDNN). Every call of both
           must take the body its rule names. Bounds: int8 operations over 1979 TOP/s or
           bytes; Winograd's 4 multiply-adds an output per input channel
           over the bf16 (or f32) peak, or bytes. f32 attention, forward and
           backward, is bounded at the least the tensor cores can do it in
           within JAX's f32 limits (attn_bound_ms): every product as 3xTF32,
           a third of TF32's rate (so is f32 Winograd); GroupNorm by bytes.
The last three lines are the card's `nvidia-smi` name and power limit, the
`kernels` JSON, and the result line. Any failure exits non-zero before the
result line; so does a card-less machine. The script writes nothing but
build/ (the kernel library, and the snapshot, the training data and
checkpoints, which it deletes) and stops itself after 720 s.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import torch
import torch.nn.functional as F

DEADLINE_S = 720
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS = 989e12         # dense tensor-core bf16
INT8_OPS = 1979e12          # dense tensor-core int8
F32_FLOPS = 67e12           # f32 outside the tensor cores
TF32_FLOPS = 495e12         # dense tensor-core TF32
# f32 products within f32's accuracy, the least the card can do them with:
# 3xTF32, three TF32 products each, the scheme the f32 attention bodies run
# for every product (S = Q K^T, dP = dO V^T, P V, dQ, dK, dV; split bf16 missed
# JAX's limits at amplitude 3 on P V and used most of them on dQ, dK, dV);
# also the bound of the f32 Winograd convolution's products
F32_TC_FLOPS = TF32_FLOPS / 3
TRAIN_WAVS = 8
TRAIN_BATCH = 2
TRAIN_CAPTIONS = ["a dog barks", "rain on a tin roof", "an engine idles", "birds sing"]
PROMPT = "a dog barks"
BATCH_PROMPTS = ["a dog barks", "rain on a tin roof", "an engine idles"]
STEPS = 10
DEVICE = "cuda"
# 20.0 s -> 512 latent frames (25.6 a second, a multiple of 8): 8192 tokens at
# the UNet's first level, over 4096 and a multiple of 512, JAX's rule for the
# blocked-KV kernel. (20.48 s would give 528 frames, 8448 tokens: not a
# multiple of 512, so the static-shift kernel, in JAX as here.)
LONG_CLIP_S = 20.0
LONG_PROMPT_TOKENS = 256
# shapes past the wrappers' old launch limits (phase `kernels`): the UNet's
# two-stage GroupNorm site at 35 prompts (CFG batch 70), past grid.y's 65535
# rows; a GroupNorm of 2^31 elements, the VAE decoder's (B, 128, 1024, 64)
# site at B = 256; attention over 70000 heads, past grid.y's 65535, at head dim 8
LIMIT_ROWS_SHAPE = (70, 960, 256, 16)
LIMIT_GN_SHAPE = (256, 128, 1024, 64)
LIMIT_HEADS = 70000
# gn_silu_fwd's host cost per call: a small bf16 map (the UNet's last level
# at CFG batch 2), where the card is quicker than the host
HOST_US_SHAPE = (2, 1280, 8, 8)
# ragged shapes and one tile for the tensor-core attention body, checked
# only: ((BH, Sq, D), (BH, Skv, D)) for attn_fwd and attn_fwd_v2
TC_SHAPES = {
    "attn_fwd": (((3, 200, 64), (3, 333, 64)), ((1, 128, 64), (1, 128, 64))),
    "attn_fwd_v2": (((2, 8320, 64), (2, 8320, 64)), ((1, 128, 64), (1, 128, 64))),
}
# the backward's tensor-core body (f32 and bf16 at D = 64), checked only: a
# ragged shape ((BH, Sq, D), (BH, Skv, D)), and the amplitude of q and k in
# its large-logit case, drawn from each of two seeds
BWD_TC_RAGGED = ((3, 200, 64), (3, 333, 64))
BWD_TC_AMPLITUDE = 3.0
BWD_TC_AMPLITUDE_SEEDS = (31, 32)
# the same large-logit case for the f32 forward's tensor-core body (3xTF32),
# at the training path's shapes against float64
FWD_TC_AMPLITUDE_SEEDS = (31, 32)
# the biased tensor-core body, checked only: ragged (200 queries, 333 keys: a
# last tile of 77) with one bias row a batch row and with a row a query,
# ((BH, Sq, D), (BH, Skv, D), (B, 1 | Sq, Skv))
BIAS_TC_SHAPES = [((6, 200, 64), (6, 333, 64), (2, 1, 333)),
                  ((6, 200, 64), (6, 333, 64), (2, 200, 333))]
# the serving paths: every attention kernel launch there is bf16 at D = 64
TC_PATHS = ("serve", "snapshot", "serve_http", "long_clip", "long_prompt", "int8", "int8_conv")
# the kernels each counted path must launch
PATH_KERNELS = {
    "serve": ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd"),
    "long_clip": ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd", "attn_fwd_v2"),
    "long_prompt": ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd", "attn_fwd_bias"),
    "train": ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd", "attn_bwd_dq",
              "attn_bwd_dkv", "gn_silu_bwd"),
    "int8": ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd", "w8a8_matmul"),
}
# a generate from a loaded snapshot runs the serving path's kernels
PATH_KERNELS["snapshot"] = PATH_KERNELS["serve"]
# the snapshot phase's batch-generation CLI run over BATCH_PROMPTS: steps, batch size
CLI_STEPS = 2
CLI_BATCH = 2
# phase serve_http: BatchingPredictor's batch, the concurrent unseeded
# requests (one batch of them), the seed of the request served alone
SERVE_BATCH = 4
SERVE_PROMPTS = ["a dog barks", "rain on a tin roof", "an engine idles", "birds sing"]
SERVE_SEED = 7
# the training CLIs run the training path's kernels: train/cli.py (SFT) and
# train/dpo_cli.py (DPO: the policy and the frozen reference UNet)
PATH_KERNELS["serve_http"] = PATH_KERNELS["serve"]
PATH_KERNELS["train_cli"] = PATH_KERNELS["train"]
PATH_KERNELS["dpo"] = PATH_KERNELS["train"]
# phase tango2_eval: Tango 2's CLI over 4 prompts at batch 4 (CFG batch 8),
# the batch CLI's re-ranking of 2 samples a prompt at batch 2; both generate
# through the serving path's kernels
TANGO2_PROMPTS = SERVE_PROMPTS
TANGO2_BATCH = 4
RERANK_SAMPLES = 2
RERANK_BATCH = 2
PATH_KERNELS["tango2_eval"] = PATH_KERNELS["serve"]
# the keys of JAX's Tango 2 record (tango_tpu/inference_tango2.py main, with
# --clap_ckpt and --reference_dir) and of EvaluationHelper's result
TANGO2_RECORD_KEYS = {"model", "num_prompts", "num_steps", "gen_time_s", "x_realtime",
                      "output_dir", "clap_score", "metrics"}
METRIC_KEYS = {"frechet_distance", "frechet_audio_distance", "kl_sigmoid", "kl_softmax", "lsd",
               "psnr", "ssim", "ssim_stft", "is_mean", "is_std", "kid_mean", "kid_std"}
# the scorers on the card against the CPU, both f32. f32 matmuls run without
# TF32 (set below), so the text tower differs at f32 rounding: 1e-4 on its
# unit vectors. f32 convolutions run in TF32 (cuDNN's default), one step
# 2^-10 of an operand: HTSAT has one (the patch embedding) before its f32
# transformer, 5 steps on the unit vectors and of its latent map's largest
# magnitude, 5e-3; Cnn14's 12 and VGGish's 6 chained convolutions, 20 steps
# of the output's largest magnitude, 2e-2
CARD_CPU_LIMITS = {"clap_text": 1e-4, "clap_audio": 5e-3, "htsat": 5e-3, "cnn14": 2e-2,
                   "vggish": 2e-2}
# gn_silu_fwd's streaming body, which every path's shape leaves for the
# cluster body, checked only: a misaligned view (offset one element) of a
# serving shape, a bf16 map whose HW is no whole number of packets, and a
# group too large for 16 CTAs' shared memory (4 MiB of f32); (shape, dtype,
# offset)
GN_FWD_STREAMING = (((2, 320, 256, 16), torch.bfloat16, 1), ((2, 64, 5, 5), torch.bfloat16, 0),
                    ((1, 32, 1024, 1024), torch.float32, 0))
# gn_silu_bwd's streaming body, which every training shape leaves for the
# cluster body, checked only: a group too large for 8 CTAs' shared memory
# (2 MiB of f32 x and g), a misaligned view (offset one element) of a
# training shape, and a bf16 map whose HW is no whole number of packets;
# (shape, dtype, offset)
GN_BWD_STREAMING = (((2, 128, 256, 256), torch.float32, 0), ((2, 320, 256, 16), torch.float32, 1),
                    ((2, 64, 5, 5), torch.bfloat16, 0))
# the JAX tests' shapes: tests/test_quant.py:54-65 (M, K, N) and
# tests/test_winograd.py:21-28, :37-44 (B, H, W, Ci, Co); and ragged GEMMs
# (K not a multiple of 4, M and N not of the 64-wide tiles), checked only
W8A8_TEST_SHAPE = (300, 320, 256)
W8A8_RAGGED = ((37, 70, 24), (5, 3, 8))
# ragged shapes of the tensor-core body (K % 16 == 0), checked only: M and N
# off the 128-wide tiles; rows of y that are not whole 16-byte packets (N =
# 7: the epilogue's direct stores); a split K with N % 4 != 0 (the finishing
# pass one element a thread)
W8A8_TC_RAGGED = ((37, 64, 24), (5, 32, 7), (70, 2560, 6))
WINO_TEST_SHAPES = ((2, 8, 6, 16, 24), (1, 256, 16, 8, 8), (2, 4, 4, 8, 16),
                    (2, 8, 8, 16, 24), (1, 64, 16, 32, 8), (2, 256, 16, 16, 16))
# a ragged shape of the tensor-core Winograd body, checked only: Ci not a
# multiple of 8 (V and U zero-padded to 32 channels), odd Co, a 3 x 4 tile grid
WINO_TC_RAGGED = ((1, 6, 8, 20, 13),)


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


def host_us(fn, calls: int = 1000) -> float:
    """Host µs per call of `fn`: the wall clock over `calls` back-to-back calls
    after a warm one, to the last call's end on the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def device_ms(fn, calls: int) -> dict:
    """Device time of one call of `fn` by kernel (function) name, in ms:
    the kernels' own time in a torch.profiler trace of `calls` calls, so the
    host's gaps between launches are left out. (A trace of one short call
    came back without its kernels, so several calls go into one trace.)"""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+)[<(]", e.key)
            out[name.group(1) if name else e.key] += e.device_time_total / 1e3 / calls
    return dict(out)


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3)


def attn_bound_ms(nbytes: float, flops: float, tag: str) -> tuple[float, str]:
    """bound_ms of an attention kernel's products: in bf16 at BF16_FLOPS, in
    f32 at F32_TC_FLOPS."""
    return bound_ms(nbytes, flops, BF16_FLOPS if tag == "bf16" else F32_TC_FLOPS)


def _larger(t_bytes: float, t_ops: float) -> tuple[float, str]:
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
        # the backward kernels are also timed with f32 inputs, the trainer's type
        self.f32 = None
        # other numbers, summed over the shapes: bf16 F.linear (w8a8_matmul),
        # the kernel alone (winograd_conv3x3), launches that took the
        # tensor-core body in this phase's checks (both)
        self.notes = {}

    @property
    def bound_by(self):
        return max(self.bound_share, key=self.bound_share.get)

    def add_err(self, tag, err):
        self.err[tag] = max(self.err[tag], err)

    def add_time(self, ms, plain_ms, lib_ms, bound, by, shape, flops=None, **extra):
        """Times of one call at one shape; the case's totals are over its
        shapes. `extra` goes into the shape's --detail row only."""
        self.ms += ms
        self.plain_ms += plain_ms
        if lib_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + lib_ms
        self.bound += bound
        self.bound_share[by] += bound
        self.detail.append(dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bound, bound_by=by, **_rates(ms, bound, flops),
                                **extra))

    def add_time_f32(self, ms, plain_ms, lib_ms, bound, by, shape, flops=None, **extra):
        if self.f32 is None:
            self.f32 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0}
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound)):
            self.f32[key] += val
        if lib_ms is not None:
            self.f32["library_ms"] = (self.f32["library_ms"] or 0.0) + lib_ms
        self.detail.append(dict(shape=shape, dtype="f32", ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=bound, bound_by=by,
                                **_rates(ms, bound, flops), **extra))


def _rates(ms, bound, flops):
    """The --detail rates of one shape: the share of its bound that the
    kernel reached and, where the operations are given, TFLOP/s (TOP/s for
    the int8 GEMM)."""
    out = {"bound_share": bound / ms}
    if flops is not None:
        out["tflops"] = flops / ms / 1e9
    return out


def took(case, fn, rule, call, what, body="tc"):
    """Run `call` and raise unless it launched fn's tensor-core body (`body`
    "tc") or cluster body ("cluster") exactly when `rule` says so (counted in
    case.notes["<body>_checked"]); returns the call's result."""
    counter = f"{body}_launches"
    before = getattr(fn, counter)
    out = call()
    if getattr(fn, counter) - before != int(rule):
        raise AssertionError(f"{what}: {'did not take' if rule else 'took'} the {body} body")
    case.notes[f"{body}_checked"] = case.notes.get(f"{body}_checked", 0) + int(rule)
    return out


def expect_misaligned_raises(fn, calls, what):
    """Each of `calls` passes fn a misaligned view where a tensor-core body
    runs: it must raise ValueError (the 16-byte check) before any launch."""
    launches = fn.launches
    for call in calls:
        try:
            call()
        except ValueError as e:
            if "16-byte" not in str(e):
                raise
        else:
            raise AssertionError(f"{what}: took a misaligned view onto the tensor-core body")
    if fn.launches != launches:
        raise AssertionError(f"{what}: a misaligned view launched the kernel")


def sdpa_backward(q, k, v, do, scale):
    """The backward half of scaled_dot_product_attention as one aten call on
    (BH, S, D) heads, its forward run here, outside the timed window:
    FlashAttention-2's backward for bf16, the memory-efficient kernel's for
    f32 (FlashAttention takes no f32); both are kernels sdpa's autograd runs."""
    aten = torch.ops.aten
    q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
    if q.dtype == torch.bfloat16:
        r = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, False, False, scale=scale)
        return lambda: aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, r[0], r[1], r[2], r[3], r[4], r[5], 0.0, False, r[6], r[7],
            scale=scale)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q4, k4, v4, do4))  # (B, S, H, D)
    r = aten._efficient_attention_forward(qt, kt, vt, None, None, None, None, None, 0.0, 0, True,
                                          scale=scale)
    return lambda: aten._efficient_attention_backward(
        dot, qt, kt, vt, None, r[0], None, None, r[4], r[5], r[1], 0.0, r[2], r[3], 0, False,
        scale=scale)


def check_kernels(ops, shapes: dict, train_shapes: dict, detail: bool):
    """Hold every kernel against its plain version at `shapes` (kernel name ->
    the argument shapes the serving and training paths launched it at) and
    time it there; `train_shapes` are the training path's alone."""
    from tango_tpu_torch.ops.flash_attention import (
        attn_bwd_dkv_plain,
        attn_bwd_dq_plain,
        attn_fwd_bias_plain,
        attn_fwd_plain,
        attn_fwd_v2_plain,
        tc_body,
    )
    from tango_tpu_torch.ops.gn_silu import (
        gn_apply_plain,
        gn_bwd_cluster_size,
        gn_fwd_cluster_size,
        gn_silu_bwd_plain,
        gn_silu_fwd_plain,
        gn_stats_plain,
    )

    K = ops.all_kernels()
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

    fwd = K["gn_silu_fwd"]
    for shape, groups, act in sorted(shapes["gn_silu_fwd"], key=str):
        c, n = shape[1], math.prod(shape)
        g, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0, loc=0.5)
            r = gn_fwd_cluster_size(dt, shape[0], c, n // (shape[0] * c), groups)
            out = took(cases["gn_silu_fwd"], fwd, r > 0, lambda: fwd(x, g, b, groups, 1e-5, act),
                       f"gn_silu_fwd {shape} {tag}", body="cluster")
            ref = gn_silu_fwd_plain(x, g, b, groups, 1e-5, act)
            cases["gn_silu_fwd"].add_err(tag, assert_close(out, ref, *tol[tag],
                                                           f"gn_silu_fwd {shape} {tag}"))
            gl, bl = g.to(dt), b.to(dt)

            def lib():
                y = F.group_norm(x, groups, gl, bl, 1e-5)
                return F.silu(y) if act == "silu" else y

            add = cases["gn_silu_fwd"].add_time if tag == "bf16" else \
                cases["gn_silu_fwd"].add_time_f32
            add(cuda_ms(lambda: fwd(x, g, b, groups, 1e-5, act)),
                cuda_ms(lambda: gn_silu_fwd_plain(x, g, b, groups, 1e-5, act)),
                cuda_ms(lib), *bound_ms(2 * x.element_size() * n + 8 * c, 8 * n, F32_FLOPS),
                [shape, groups, act], cluster_size=r, ctas=shape[0] * groups * r)
    x = randn(*HOST_US_SHAPE, dtype=torch.bfloat16)
    g, b = randn(HOST_US_SHAPE[1]), randn(HOST_US_SHAPE[1])
    cases["gn_silu_fwd"].notes["host_us_per_call"] = statistics.median(
        host_us(lambda: fwd(x, g, b, 32, 1e-5, "silu")) for _ in range(5))
    for shape, dt, offset in GN_FWD_STREAMING:
        c, n = shape[1], math.prod(shape)
        g, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        x = randn(n + offset, dtype=dt, scale=2.0, loc=0.5)[offset:].view(shape)
        tag = "f32" if dt == torch.float32 else "bf16"
        what = f"gn_silu_fwd {shape} {tag}, offset {offset}, streaming body"
        out = took(cases["gn_silu_fwd"], fwd, False, lambda: fwd(x, g, b, 32, 1e-5, "silu"),
                   what, body="cluster")
        cases["gn_silu_fwd"].add_err(tag, assert_close(
            out, gn_silu_fwd_plain(x, g, b, 32, 1e-5, "silu"), *tol[tag], what))
        del x, out

    for shape, groups, chunks in sorted(shapes["gn_stats"], key=str):
        n = math.prod(shape)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0, loc=0.5)
            out = K["gn_stats"](x, groups, chunks)
            ref = gn_stats_plain(x, groups, chunks)
            # partial sums of up to ~10^5 terms: relative tolerance only
            cases["gn_stats"].add_err(tag, assert_close(out, ref, 0.0, 1e-4,
                                                        f"gn_stats {shape} {tag}"))
            add = cases["gn_stats"].add_time if tag == "bf16" else cases["gn_stats"].add_time_f32
            add(cuda_ms(lambda: K["gn_stats"](x, groups, chunks)),
                cuda_ms(lambda: gn_stats_plain(x, groups, chunks)), None,
                *bound_ms(x.element_size() * n + 8 * shape[0] * groups * chunks, 3 * n,
                          F32_FLOPS), [shape, groups, chunks])

    for shape, act in sorted(shapes["gn_apply"], key=str):
        bsz, c = shape[0], shape[1]
        a, bb = randn(bsz, c, scale=0.3, loc=1.0), randn(bsz, c, scale=0.1)
        n = math.prod(shape)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0)
            out = K["gn_apply"](x, a, bb, act)
            ref = gn_apply_plain(x, a, bb, act)
            cases["gn_apply"].add_err(tag, assert_close(out, ref, *tol[tag],
                                                        f"gn_apply {shape} {tag}"))
            add = cases["gn_apply"].add_time if tag == "bf16" else cases["gn_apply"].add_time_f32
            add(cuda_ms(lambda: K["gn_apply"](x, a, bb, act)),
                cuda_ms(lambda: gn_apply_plain(x, a, bb, act)), None,
                *bound_ms(2 * x.element_size() * n + 16 * bsz * c, 6 * n, F32_FLOPS),
                [shape, act])

    def attention_fwd(name, plain):
        """attn_fwd or attn_fwd_v2 at every launched shape, in f32 and bf16,
        each checked, held to the body `tc_body` names (every call at head
        dim 64 on a tensor-core body, 3xTF32 in f32) and timed; at
        TC_SHAPES, checked only, in each type that has a tensor-core body."""
        fn = K[name]
        for qshape, kshape in sorted(shapes[name], key=str):
            bh, sq, d = qshape
            skv = kshape[1]
            scale = d**-0.5
            flops = 4 * bh * sq * skv * d  # S = Q K^T, then P V
            for tag, dt in dtypes.items():
                q, k, v = (randn(*s, dtype=dt) for s in (qshape, kshape, kshape))
                what = f"{name} {qshape} {tag}"
                out = took(cases[name], fn, tc_body(dt, d), lambda: fn(q, k, v, scale), what)
                cases[name].add_err(tag, assert_close(out, plain(q, k, v, scale), *attn_tol[tag],
                                                      what))
                q4, k4, v4 = (t.reshape(1, bh, -1, d) for t in (q, k, v))
                add = cases[name].add_time if tag == "bf16" else cases[name].add_time_f32
                add(cuda_ms(lambda: fn(q, k, v, scale)),
                    cuda_ms(lambda: plain(q, k, v, scale)),
                    cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)),
                    *attn_bound_ms(q.element_size() * (2 * bh * sq * d + 2 * bh * skv * d),
                                   flops, tag),
                    [qshape, kshape], flops=flops)
        for qshape, kshape in TC_SHAPES[name]:
            for tag, dt in dtypes.items():
                if not tc_body(dt, qshape[2]):
                    continue
                q, k, v = (randn(*s, dtype=dt) for s in (qshape, kshape, kshape))
                what = f"{name} {qshape} x {kshape[1]} keys {tag}"
                out = took(cases[name], fn, True, lambda: fn(q, k, v, 0.125), what)
                cases[name].add_err(tag, assert_close(out, plain(q, k, v, 0.125), *attn_tol[tag],
                                                      what))

    attention_fwd("attn_fwd", attn_fwd_plain)
    fwd_amplitude_checks(K, cases, "attn_fwd", sorted(train_shapes["attn_fwd"], key=str))

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

    # ---- the long-clip and long-prompt forward kernels
    attention_fwd("attn_fwd_v2", attn_fwd_v2_plain)
    fwd_amplitude_checks(K, cases, "attn_fwd_v2", sorted(shapes["attn_fwd_v2"], key=str))
    fwd_amplitude_checks(K, cases, "attn_fwd_bias", sorted(shapes["attn_fwd_bias"], key=str))

    def bias_case(qshape, kshape, bshape, dt):
        """q, k, v of the shapes, and the padding bias (B, 1 | Sq, Skv) of a
        short prompt in a longer context (the first few keys open, a
        different number in each batch row), with unit noise where each
        query has its own row."""
        bias = padding_bias(bshape, 4)
        if bshape[1] > 1:
            bias += randn(*bshape)
        return [randn(*s, dtype=dt) for s in (qshape, kshape, kshape)] + [bias]

    fn = K["attn_fwd_bias"]
    for qshape, kshape, bshape in sorted(shapes["attn_fwd_bias"], key=str) + BIAS_TC_SHAPES:
        bh, sq, d = qshape
        skv = kshape[1]
        nb, rows = bshape[0], bshape[1]
        heads = bh // nb
        scale = d**-0.5
        timed = (qshape, kshape, bshape) in shapes["attn_fwd_bias"]
        for tag, dt in dtypes.items():
            q, k, v, bias = bias_case(qshape, kshape, bshape, dt)
            what = f"attn_fwd_bias {qshape} {kshape} {bshape} {tag}"
            out = took(cases["attn_fwd_bias"], fn, tc_body(dt, d),
                       lambda: fn(q, k, v, bias, heads, scale), what)
            cases["attn_fwd_bias"].add_err(tag, assert_close(
                out, attn_fwd_bias_plain(q, k, v, bias, heads, scale), *attn_tol[tag], what))
            if not timed:
                continue
            # both types timed (f32 on the 3xTF32 body, in the `f32` field)
            q4, k4, v4 = (t.reshape(nb, heads, -1, d) for t in (q, k, v))
            mask4 = bias[:, None].to(q.dtype)  # sdpa takes a float mask of q's type
            add = cases["attn_fwd_bias"].add_time if tag == "bf16" else \
                cases["attn_fwd_bias"].add_time_f32
            add(cuda_ms(lambda: fn(q, k, v, bias, heads, scale)),
                cuda_ms(lambda: attn_fwd_bias_plain(q, k, v, bias, heads, scale)),
                cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask4,
                                                               scale=scale)),
                *attn_bound_ms(q.element_size() * (2 * bh * sq * d + 2 * bh * skv * d)
                               + 4 * nb * rows * skv, 4 * bh * sq * skv * d, tag),
                [qshape, kshape, bshape], flops=4 * bh * sq * skv * d)

    # misaligned views where a tensor-core forward body runs: must raise
    good16, bias1 = randn(2, 128, 64, dtype=torch.bfloat16), torch.zeros(1, 1, 128, device=dev)
    bad16 = torch.zeros(good16.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(2, 128, 64)
    bad_bias = torch.zeros(129, device=dev)[1:].view(1, 1, 128)
    expect_misaligned_raises(fn, (lambda: fn(bad16, good16, good16, bias1, 2, 0.125),
                                  lambda: fn(good16, good16, good16, bad_bias, 2, 0.125)),
                             "attn_fwd_bias bf16")
    good32 = randn(2, 128, 64)
    bad32 = torch.zeros(good32.numel() + 1, device=dev)[1:].view(2, 128, 64)
    for name in ("attn_fwd", "attn_fwd_v2"):
        expect_misaligned_raises(K[name], (lambda: K[name](good32, bad32, good32, 0.125),),
                                 f"{name} f32")
    expect_misaligned_raises(fn, (lambda: fn(good32, bad32, good32, bias1, 2, 0.125),
                                  lambda: fn(good32, good32, good32, bad_bias, 2, 0.125)),
                             "attn_fwd_bias f32")

    # JAX's extreme-logit case for v2 (row maxes near natural +100, past the
    # static-shift window): the kernel stays exact; and a batch row whose keys
    # are all masked for the bias kernel: finite. The plain version's base-2
    # logits sit near -14427, where an f32 keeps 2^-10 of absolute precision,
    # so its p carries up to ~7e-4 of relative rounding (the f32 kernel takes
    # the row's largest bias off first): atol 1e-3 on that row (the other row
    # at the usual limits).
    for tag, dt in dtypes.items():
        u = randn(64)
        u = u / u.norm()
        cq = 2.0 + 0.2 * torch.rand(128, 1, generator=gen, device=dev)
        ck = 380.0 + 8.0 * torch.rand(256, 1, generator=gen, device=dev)
        q = (cq * u + 0.01 * randn(128, 64))[None].to(dt)
        k = (ck * u + 0.01 * randn(256, 64))[None].to(dt)
        v = randn(1, 256, 64, dtype=dt)
        out = took(cases["attn_fwd_v2"], K["attn_fwd_v2"], tc_body(dt, 64),
                   lambda: K["attn_fwd_v2"](q, k, v, 0.125), f"attn_fwd_v2 extreme logits {tag}")
        ref = attn_fwd_v2_plain(q, k, v, 0.125)
        atol, rtol = (5e-5, 1e-3) if tag == "f32" else attn_tol[tag]
        cases["attn_fwd_v2"].add_err(tag, assert_close(out, ref, atol, rtol,
                                                       f"attn_fwd_v2 extreme logits {tag}"))
        q, k, v = (randn(8, 256, 64, dtype=dt) for _ in range(3))
        bias = torch.zeros(2, 1, 256, device=dev)
        bias[0, :, 5:] = -10000.0
        bias[1] = -10000.0
        out = took(cases["attn_fwd_bias"], fn, tc_body(dt, 64),
                   lambda: fn(q, k, v, bias, 4, 0.125), f"attn_fwd_bias masked rows {tag}")
        ref = attn_fwd_bias_plain(q, k, v, bias, 4, 0.125)
        cases["attn_fwd_bias"].add_err(tag, assert_close(
            out[:4], ref[:4], *attn_tol[tag], f"attn_fwd_bias masked row {tag}"))
        cases["attn_fwd_bias"].notes[f"all_masked_row_err_{tag}"] = assert_close(
            out[4:], ref[4:], 1e-3 if tag == "f32" else attn_tol[tag][0],
            0.0 if tag == "f32" else attn_tol[tag][1], f"attn_fwd_bias all-masked row {tag}")

    # ---- the backward kernels, at the shapes of the training path
    # f32 at the JAX backward tests' limits (tests/test_flash_attention.py:156,
    # tests/test_gn_pallas.py:90); bf16 from the readings in PERF.md: one bf16
    # step of outputs below ~1.2 (attention, 2.0e-3 measured) and below ~4
    # (GroupNorm dx, 7.8e-3 measured). lse and delta are f32 in both types.
    attn_bwd_tol = {"f32": (1e-4, 1e-3), "bf16": (4e-3, 1e-2)}
    gn_bwd_tol = {"f32": (2e-4, 1e-3), "bf16": (2e-2, 2e-2)}
    stat_tol = (1e-4, 1e-3)
    for qshape, kshape in sorted(shapes["attn_bwd_dq"] | shapes["attn_bwd_dkv"], key=str):
        bh, sq, d = qshape
        skv = kshape[1]
        scale = d**-0.5
        for tag, dt in dtypes.items():
            q, k, v = (randn(*s, dtype=dt) for s in (qshape, kshape, kshape))
            do = randn(*qshape, dtype=dt)
            lse, delta = check_bwd(K, cases, q, k, v, do, scale, attn_bwd_tol[tag], stat_tol,
                                   f"{qshape} {kshape} {tag}")

            lib = cuda_ms(sdpa_backward(q, k, v, do, scale))
            isz = q.element_size()
            qkvo = bh * (2 * sq + 2 * skv) * d * isz  # q, k, v, do read
            stats = 2 * 4 * bh * sq                     # lse, delta
            product = 2 * bh * sq * skv * d
            # (name, kernel, plain version, bytes moved, products): dq S, dP
            # and dQ; dkv S^T, dP^T, dV and dK
            timing = [
                ("attn_bwd_dq", lambda: K["attn_bwd_dq"](q, k, v, do, scale),
                 lambda: attn_bwd_dq_plain(q, k, v, do, scale),
                 qkvo + bh * sq * d * isz + stats, 3),
                ("attn_bwd_dkv", lambda: K["attn_bwd_dkv"](q, k, v, do, lse, delta, scale),
                 lambda: attn_bwd_dkv_plain(q, k, v, do, lse, delta, scale),
                 qkvo + stats + 2 * bh * skv * d * isz, 4),
            ]
            for name, kern, plain, nbytes, products in timing:
                add = cases[name].add_time if tag == "bf16" else cases[name].add_time_f32
                add(cuda_ms(kern), cuda_ms(plain), lib,
                    *attn_bound_ms(nbytes, products * product, tag), [qshape, kshape],
                    flops=products * product)
    bwd_tc_checks(K, cases, shapes, randn, attn_bwd_tol, stat_tol)

    bwd = K["gn_silu_bwd"]
    for shape, groups, act in sorted(shapes["gn_silu_bwd"], key=str):
        c = shape[1]
        w, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        n = math.prod(shape)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0, loc=0.5)
            g = randn(*shape, dtype=dt)
            r = gn_bwd_cluster_size(dt, shape[0], c, n // (shape[0] * c), groups)
            out = took(cases["gn_silu_bwd"], bwd, r > 0,
                       lambda: bwd(x, g, w, b, groups, 1e-5, act),
                       f"gn_silu_bwd {shape} {tag}", body="cluster")
            ref = gn_silu_bwd_plain(x, g, w, b, groups, 1e-5, act)
            cases["gn_silu_bwd"].add_err(tag, max(
                assert_close(o, r, *gn_bwd_tol[tag], f"gn_silu_bwd {part} {shape} {tag}")
                for o, r, part in zip(out, ref, ("dx", "dgamma", "dbeta"))))

            # aten's GroupNorm backward (after silu's) from the forward's statistics
            wl, bl = w.to(dt), b.to(dt)
            hw = n // (shape[0] * c)
            y, mean, rstd = torch.ops.aten.native_group_norm(x, wl, bl, shape[0], c, hw, groups,
                                                             1e-5)

            def lib():
                gy = torch.ops.aten.silu_backward(g, y) if act == "silu" else g
                return torch.ops.aten.native_group_norm_backward(
                    gy, x, mean, rstd, wl, shape[0], c, hw, groups, [True, True, True])

            add = cases["gn_silu_bwd"].add_time if tag == "bf16" else \
                cases["gn_silu_bwd"].add_time_f32
            add(cuda_ms(lambda: bwd(x, g, w, b, groups, 1e-5, act)),
                cuda_ms(lambda: gn_silu_bwd_plain(x, g, w, b, groups, 1e-5, act)),
                cuda_ms(lib), *bound_ms(3 * n * x.element_size(), 24 * n, F32_FLOPS),
                [shape, groups, act], cluster_size=r, ctas=shape[0] * groups * r)

    for shape, dt, offset in GN_BWD_STREAMING:
        c, n = shape[1], math.prod(shape)
        w, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        x = randn(n + offset, dtype=dt, scale=2.0, loc=0.5)[offset:].view(shape)
        g = randn(n + offset, dtype=dt)[offset:].view(shape)
        tag = "f32" if dt == torch.float32 else "bf16"
        what = f"gn_silu_bwd {shape} {tag}, offset {offset}, streaming body"
        out = took(cases["gn_silu_bwd"], bwd, False, lambda: bwd(x, g, w, b, 32, 1e-5, "silu"),
                   what, body="cluster")
        ref = gn_silu_bwd_plain(x, g, w, b, 32, 1e-5, "silu")
        cases["gn_silu_bwd"].add_err(tag, max(
            assert_close(o, r, *gn_bwd_tol[tag], f"{what} {part}")
            for o, r, part in zip(out, ref, ("dx", "dgamma", "dbeta"))))
        del x, g, out, ref

    int8_and_winograd(K, cases, shapes, randn, detail)
    limit_checks(K, cases, randn, tol, attn_tol, gn_bwd_tol, attn_bwd_tol)
    if detail:
        for case in cases.values():
            for row in case.detail:
                log("kernel_shape", name=case.name, **row)
    return cases


def check_bwd(K, cases, q, k, v, do, scale, tol, stat_tol, what):
    """attn_bwd_dq, then attn_bwd_dkv on its lse and delta, against their
    plain versions; returns the kernel's lse and delta."""
    from tango_tpu_torch.ops.flash_attention import attn_bwd_dkv_plain, attn_bwd_dq_plain

    tag = "f32" if q.dtype == torch.float32 else "bf16"
    dq, lse, delta = K["attn_bwd_dq"](q, k, v, do, scale)
    rq, rl, rd = attn_bwd_dq_plain(q, k, v, do, scale)
    cases["attn_bwd_dq"].add_err(tag, max(
        assert_close(dq, rq, *tol, f"attn_bwd_dq dq {what}"),
        assert_close(lse, rl, *stat_tol, f"attn_bwd_dq lse {what}"),
        assert_close(delta, rd, *stat_tol, f"attn_bwd_dq delta {what}")))
    dk, dv = K["attn_bwd_dkv"](q, k, v, do, lse, delta, scale)
    rk, rv = attn_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    cases["attn_bwd_dkv"].add_err(tag, max(
        assert_close(dk, rk, *tol, f"attn_bwd_dkv dk {what}"),
        assert_close(dv, rv, *tol, f"attn_bwd_dkv dv {what}")))
    return lse, delta


def attn_bwd_float64(q, k, v, do, scale):
    """(dq, dk, dv, lse, delta) of softmax(q k^T * scale) v in float64: the
    plain versions' formula, exact to f32's eye."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
            torch.matmul(p.transpose(-1, -2), do), lse[..., 0], delta[..., 0])


def bound_ratio(out, ref, atol, rtol) -> float:
    """The largest |out - ref| / (atol + rtol |ref|): at most 1 meets the
    limits."""
    return ((out.double() - ref.double()).abs() / (atol + rtol * ref.double().abs())).max().item()


def max_abs_rel(out, ref, floor) -> dict:
    """max |out - ref| and max |out - ref| / |ref| over the elements with
    |ref| >= floor (below it the limits' absolute term decides)."""
    d = (out.double() - ref.double()).abs()
    big = ref.double().abs() >= floor
    rel = (d[big] / ref.double().abs()[big]).max().item() if big.any() else 0.0
    return {"max_abs": d.max().item(), "max_rel": rel}


def padding_bias(bshape, first):
    """The padding bias (B, rows, Skv) f32 of a short prompt in a longer
    context: 0 on the first `first` + 3i keys of batch row i, -10000 on the
    others, the same for every row."""
    nb, rows, skv = bshape
    keep = torch.arange(nb, device=DEVICE)[:, None, None] * 3 + first
    bias = torch.where(torch.arange(skv, device=DEVICE)[None, None, :] < keep, 0.0, -10000.0)
    return bias.expand(nb, rows, skv).contiguous()


def fwd_amplitude_checks(K, cases, name, launched):
    """The f32 forward's tensor-core body (3xTF32) of attn_fwd, attn_fwd_v2
    or attn_fwd_bias (`name`) with q and k at amplitude BWD_TC_AMPLITUDE at
    the shapes `launched`, drawn from each of FWD_TC_AMPLITUDE_SEEDS (the
    biased form with a padding bias that leaves a quarter of the keys and a
    few more open): held to JAX's f32 forward limits (2e-5 / 1e-4) against
    the same softmax in float64, raising on a miss; the float64 reference is
    taken a few heads at a time (at most 2^28 logits, 2 GB). Phase
    `fwd_amplitude` logs the kernel's and the plain version's share of those
    limits and their max-abs and max-rel differences."""
    from tango_tpu_torch.ops import flash_attention as fa

    plain = getattr(fa, f"{name}_plain")
    tol = (2e-5, 1e-4)
    for seed in FWD_TC_AMPLITUDE_SEEDS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        for qshape, kshape, *bshape in launched:
            q, k = (torch.randn(s, generator=gen, device=DEVICE) * BWD_TC_AMPLITUDE
                    for s in (qshape, kshape))
            v = torch.randn(kshape, generator=gen, device=DEVICE)
            scale = qshape[2] ** -0.5
            args, bias = (q, k, v), None
            if bshape:  # attn_fwd_bias: the heads of a batch row share its bias row
                bias = padding_bias(bshape[0], kshape[1] // 4)
                heads = qshape[0] // bshape[0][0]
                args = (q, k, v, bias, heads)
            what = f"{name} {qshape} q, k at amplitude {BWD_TC_AMPLITUDE} f32, seed {seed}"
            kern = took(cases[name], K[name], True, lambda: K[name](*args, scale), what)
            ref = plain(*args, scale)
            share = {"kernel": 0.0, "plain": 0.0}
            diff = {w: {"max_abs": 0.0, "max_rel": 0.0} for w in share}
            step = max(1, 2**28 // (qshape[1] * kshape[1]))
            for h in range(0, qshape[0], step):
                qd, kd, vd = (t[h:h + step].double() for t in (q, k, v))
                logits = qd @ kd.transpose(-1, -2) * scale
                if bias is not None:
                    logits += bias.double().repeat_interleave(heads, 0)[h:h + step]
                exact = torch.softmax(logits, -1) @ vd
                assert_close(kern[h:h + step], exact, *tol, f"{what}, against float64")
                for who, out in (("kernel", kern), ("plain", ref)):
                    share[who] = max(share[who], bound_ratio(out[h:h + step], exact, *tol))
                    d = max_abs_rel(out[h:h + step], exact, tol[0])
                    diff[who] = {f: max(diff[who][f], d[f]) for f in d}
                del qd, kd, vd, logits, exact
            log("fwd_amplitude", name=name, shape=[qshape, kshape, *bshape],
                amplitude=BWD_TC_AMPLITUDE,
                seed=seed, **{f"{who}_vs_float64": {"share_of_limit": round(share[who], 4),
                                                    **diff[who]} for who in share})
            del kern, ref
            torch.cuda.empty_cache()


def bwd_tc_checks(K, cases, shapes, randn, attn_bwd_tol, stat_tol):
    """The backward's tensor-core body (f32 and bf16 at head dim 64) beyond
    the launched shapes, checked only: a ragged shape in both types; q and k
    at amplitude BWD_TC_AMPLITUDE in f32 at the training shapes, drawn from
    each of BWD_TC_AMPLITUDE_SEEDS (logits three times as large); and a
    misaligned view, which must raise before any launch.

    In the amplitude case dq, dk and dv are held to JAX's limits both
    against their plain versions and against the same formula in float64;
    lse and delta against float64 only: at amplitude 3 the f32 logits of the
    plain versions carry ~5e-5 of rounding, which exp turns into a relative
    error of p, so the plain lse and delta sit up to ~0.65 of JAX's limits
    from the exact values, and a comparison with them adds two errors of
    that size. Phase `bwd_amplitude` logs each distance's share of the
    limits and the max-abs and max-rel differences of dq, dk and dv."""
    from tango_tpu_torch.ops.flash_attention import (
        attn_bwd_dkv_plain,
        attn_bwd_dq_plain,
        tc_body,
    )

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    qshape, kshape = BWD_TC_RAGGED
    for tag, dt in dtypes.items():
        q, do = (randn(*qshape, dtype=dt) for _ in range(2))
        k, v = (randn(*kshape, dtype=dt) for _ in range(2))
        check_bwd(K, cases, q, k, v, do, 0.125, attn_bwd_tol[tag], stat_tol,
                  f"{qshape} x {kshape[1]} keys {tag}")
    names = ("dq", "dk", "dv", "lse", "delta")
    launched = [s for s in sorted(shapes["attn_bwd_dq"], key=str)
                if tc_body(torch.float32, s[0][2])]
    for seed in BWD_TC_AMPLITUDE_SEEDS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        for qshape, kshape in launched:
            q, k = (torch.randn(s, generator=gen, device=DEVICE) * BWD_TC_AMPLITUDE
                    for s in (qshape, kshape))
            v = torch.randn(kshape, generator=gen, device=DEVICE)
            do = torch.randn(qshape, generator=gen, device=DEVICE)
            scale = qshape[2] ** -0.5
            dq, lse, delta = K["attn_bwd_dq"](q, k, v, do, scale)
            kern = (dq, *K["attn_bwd_dkv"](q, k, v, do, lse, delta, scale), lse, delta)
            rq, rl, rd = attn_bwd_dq_plain(q, k, v, do, scale)
            plain = (rq, *attn_bwd_dkv_plain(q, k, v, do, rl, rd, scale), rl, rd)
            exact = attn_bwd_float64(q, k, v, do, scale)
            what = f"{qshape} q, k at amplitude {BWD_TC_AMPLITUDE} f32, seed {seed}"
            # raises on a miss; not added to the kernels line's errors, which
            # are against the plain versions at the path's inputs
            for i, name in enumerate(names):
                tol = attn_bwd_tol["f32"] if i < 3 else stat_tol
                kernel = "attn_bwd_dq" if name in ("dq", "lse", "delta") else "attn_bwd_dkv"
                assert_close(kern[i], exact[i], *tol, f"{kernel} {name} {what}, against float64")
                if i < 3:
                    assert_close(kern[i], plain[i], *tol, f"{kernel} {name} {what}")
            log("bwd_amplitude", shape=[qshape, kshape], amplitude=BWD_TC_AMPLITUDE, seed=seed,
                **{f"{who}_share_of_limit": {
                    n: round(bound_ratio(a, b, *(attn_bwd_tol["f32"] if i < 3 else stat_tol)), 4)
                    for i, (n, a, b) in enumerate(zip(names, x, y))}
                   for who, x, y in (("kernel_vs_float64", kern, exact),
                                     ("plain_vs_float64", plain, exact),
                                     ("kernel_vs_plain", kern, plain))},
                **{f"{who}_differences": {
                    n: max_abs_rel(a, b, attn_bwd_tol["f32"][0])
                    for n, a, b in zip(names[:3], x, y)}
                   for who, x, y in (("kernel_vs_float64", kern, exact),
                                     ("kernel_vs_plain", kern, plain))})
            del kern, plain, exact
            torch.cuda.empty_cache()
    good = randn(1, 128, 64)
    bad = torch.zeros(good.numel() + 1, device=good.device)[1:].view(1, 128, 64)
    lse = torch.zeros(1, 128, device=good.device)
    expect_misaligned_raises(K["attn_bwd_dq"], (lambda: K["attn_bwd_dq"](good, good, bad, good,
                                                                          0.125),), "attn_bwd_dq")
    expect_misaligned_raises(K["attn_bwd_dkv"],
                             (lambda: K["attn_bwd_dkv"](good, good, good, bad, lse, lse, 0.125),),
                             "attn_bwd_dkv")


def int8_and_winograd(K, cases, shapes, randn, detail):
    """w8a8_matmul at the int8 path's shapes and tests/test_quant.py's;
    winograd_conv3x3 (no path calls it) at tests/test_winograd.py's shapes
    and at the UNet's 3x3 stride-1 shapes. Checked in f32 and bf16, timed
    with bf16 inputs (Winograd in f32 too). Each call must take the body its
    rule names (`w8a8_tc_body`, `wino_tc_body`): the tensor-core one at
    every int8-path and UNet shape and for Winograd in both types, the
    CUDA-core one for the ragged GEMMs. Winograd is timed as the whole
    wrapper (U = G w G^T by its kernel, then the convolution: the `ms` of
    the kernels line, as before) and, in bf16, as the kernel alone (`launch`
    on a prepared U), both beside cuDNN. With `detail`, each shape's row
    also splits one call's device time by kernel."""
    from tango_tpu_torch.ops import winograd as wg
    from tango_tpu_torch.ops.int8_gemm import quantize_rows, w8a8_matmul_plain, w8a8_tc_body
    from tango_tpu_torch.ops.quant import int_mm_ok, quantize_weight

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    w8a8_tol = {"f32": (1e-5, 1e-5), "bf16": (1e-2, 8e-3)}
    m, k, n = W8A8_TEST_SHAPE
    gemms = sorted(shapes["w8a8_matmul"] | {((m, k), (n, k))})
    w8a8 = K["w8a8_matmul"]
    for (m, k), (n, _) in gemms:
        case = cases["w8a8_matmul"]
        q, s = quantize_weight(randn(n, k, scale=k**-0.5), out_axis=0)
        for tag, dt in dtypes.items():
            x = randn(m, k, dtype=dt)
            what = f"w8a8_matmul ({m}, {k}, {n}) {tag}"
            out = took(cases["w8a8_matmul"], w8a8, w8a8_tc_body(k), lambda: w8a8(x, q, s), what)
            case.add_err(tag, assert_close(out, w8a8_matmul_plain(x, q, s), *w8a8_tol[tag], what))
        xq, _ = quantize_rows(x)
        lib = cuda_ms(lambda: torch._int_mm(xq, q.t())) if int_mm_ok(m, k, n) else None
        wl = randn(n, k, dtype=x.dtype, scale=k**-0.5)
        linear = cuda_ms(lambda: F.linear(x, wl))
        case.notes["linear_bf16_ms"] = case.notes.get("linear_bf16_ms", 0.0) + linear
        case.add_time(cuda_ms(lambda: w8a8(x, q, s)),
                      cuda_ms(lambda: w8a8_matmul_plain(x, q, s)), lib,
                      *bound_ms(2 * m * k + n * k + 4 * n + 2 * m * n, 2 * m * n * k, INT8_OPS),
                      [[m, k], [n, k]], flops=2 * m * n * k, linear_bf16_ms=linear,
                      **({"by_kernel_ms": device_ms(lambda: w8a8(x, q, s), 20)} if detail else {}))

    for m, k, n in W8A8_RAGGED + W8A8_TC_RAGGED:
        q, s = quantize_weight(randn(n, k, scale=k**-0.5), out_axis=0)
        for tag, dt in dtypes.items():
            x = randn(m, k, dtype=dt)
            what = f"w8a8_matmul ({m}, {k}, {n}) {tag}"
            out = took(cases["w8a8_matmul"], w8a8, w8a8_tc_body(k), lambda: w8a8(x, q, s), what)
            cases["w8a8_matmul"].add_err(tag, assert_close(
                out, w8a8_matmul_plain(x, q, s), *w8a8_tol[tag], what))

    wino_tol = {"f32": (1e-4, 1e-4), "bf16": (2e-2, 2e-2)}
    # the U kernel against its torch version: the same f32 sums of halves (in
    # another order at most), rounded to the type: within a few f32 ulps of
    # |U| <= ~0.1 in f32, one bf16 step in bf16
    u_tol = {"f32": (1e-7, 1e-6), "bf16": (0.0, 2**-7)}
    convs = set(shapes["winograd_conv3x3"])
    convs |= {((b, ci, h, w), (co, ci, 3, 3)) for b, h, w, ci, co in WINO_TEST_SHAPES}
    checked_only = {((b, ci, h, w), (co, ci, 3, 3)) for b, h, w, ci, co in WINO_TC_RAGGED}
    wino = K["winograd_conv3x3"]
    for xshape, wshape in sorted(convs | checked_only):
        case = cases["winograd_conv3x3"]
        b, ci, h, w_ = xshape
        co = wshape[0]
        wt = randn(*wshape, scale=(9 * ci) ** -0.5)
        for tag, dt in dtypes.items():
            x = randn(*xshape, dtype=dt)
            what = f"winograd_conv3x3 {xshape} -> {co} {tag}"
            out = took(case, wino, wg.wino_tc_body(dt), lambda: wino(x, wt), what)
            case.add_err(tag, assert_close(out, wg.winograd_conv3x3_plain(x, wt), *wino_tol[tag],
                                           what))
            u = wg.kernel_weight(wt, dt)
            assert_close(wg.weight_tc(wt, dt), u, *u_tol[tag],
                         f"winograd_conv3x3 U of {wshape} {tag}")
        wl = wt.to(x.dtype)
        if (xshape, wshape) in checked_only:
            continue
        alone = cuda_ms(lambda: wg.launch(x, u, co))
        case.notes["kernel_only_ms"] = case.notes.get("kernel_only_ms", 0.0) + alone
        nbytes = (b * ci * h * w_ + b * co * h * w_ + 16 * ci * co) * x.element_size()
        flops = 2 * 4 * b * h * w_ * co * ci
        case.add_time(cuda_ms(lambda: wino(x, wt)),
                      cuda_ms(lambda: wg.winograd_conv3x3_plain(x, wt)),
                      cuda_ms(lambda: F.conv2d(x, wl, padding=1)),
                      *bound_ms(nbytes, flops, BF16_FLOPS),
                      [list(xshape), list(wshape)], flops=flops, kernel_only_ms=alone,
                      **({"by_kernel_ms": device_ms(lambda: wino(x, wt), 20)} if detail else {}))
        # f32 (the 3xTF32 body) in the `f32` field, beside cuDNN at f32's
        # precision (without TF32, which cuDNN's f32 convolutions use by
        # default), bounded as 3xTF32 products
        x32 = randn(*xshape)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib32 = cuda_ms(lambda: F.conv2d(x32, wt, padding=1))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        case.add_time_f32(cuda_ms(lambda: wino(x32, wt)),
                          cuda_ms(lambda: wg.winograd_conv3x3_plain(x32, wt)), lib32,
                          *bound_ms(2 * nbytes, flops, F32_TC_FLOPS),
                          [list(xshape), list(wshape)], flops=flops)


def limit_checks(K, cases, randn, tol, attn_tol, gn_bwd_tol, attn_bwd_tol):
    """Each kernel at one shape past the launch limits the port's wrappers
    used to have (a grid.y of 65535 rows or heads, 2^31 elements): checked
    against the plain version, not timed (no path launches these shapes)."""
    from tango_tpu_torch.ops.flash_attention import (
        attn_fwd_bias_plain,
        attn_fwd_plain,
        attn_fwd_v2_plain,
    )
    from tango_tpu_torch.ops.gn_silu import (
        gn_apply_plain,
        gn_bwd_cluster_size,
        gn_fwd_cluster_size,
        gn_silu_bwd_plain,
        gn_silu_fwd_plain,
        gn_stats_plain,
        n_chunks,
    )

    bf16 = torch.bfloat16
    # LIMIT_ROWS_SHAPE: gn_apply's B*C rows and gn_stats' B*G*chunks blocks
    nb, c, h, w = LIMIT_ROWS_SHAPE
    x = randn(nb, c, h, w, dtype=bf16, scale=2.0, loc=0.5)
    chunks = n_chunks(h * w)
    cases["gn_stats"].add_err("bf16", assert_close(
        K["gn_stats"](x, 32, chunks), gn_stats_plain(x, 32, chunks), 0.0, 1e-4,
        f"gn_stats {LIMIT_ROWS_SHAPE}"))
    a, b = randn(nb, c, scale=0.3, loc=1.0), randn(nb, c, scale=0.1)
    cases["gn_apply"].add_err("bf16", assert_close(
        K["gn_apply"](x, a, b, "silu"), gn_apply_plain(x, a, b, "silu"), *tol["bf16"],
        f"gn_apply {LIMIT_ROWS_SHAPE}"))
    del x

    # LIMIT_GN_SHAPE in bf16 through the two-stage kernels, and the same bytes
    # as (4B, C, H/4, W) (an 8 MB f32 sample at the full shape) through the
    # single pass and the backward. The plain versions run 16 samples at a
    # time; GroupNorm is per sample.
    nb, c, h, w = LIMIT_GN_SHAPE
    x = randn(nb, c, h, w, dtype=bf16, scale=2.0, loc=0.5)
    chunks = n_chunks(h * w)
    gam, bet = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
    a, b = randn(nb, c, scale=0.3, loc=1.0), randn(nb, c, scale=0.1)

    def sliced(out, plain, n, atol, rtol, what):
        return max(assert_close(out[i:i + 16], plain(i), atol, rtol, what)
                   for i in range(0, n, 16))

    cases["gn_stats"].add_err("bf16", sliced(
        K["gn_stats"](x, 32, chunks), lambda i: gn_stats_plain(x[i:i + 16], 32, chunks), nb,
        0.0, 1e-4, f"gn_stats {LIMIT_GN_SHAPE}"))
    cases["gn_apply"].add_err("bf16", sliced(
        K["gn_apply"](x, a, b, "silu"),
        lambda i: gn_apply_plain(x[i:i + 16], a[i:i + 16], b[i:i + 16], "silu"), nb,
        *tol["bf16"], f"gn_apply {LIMIT_GN_SHAPE}"))
    xs = x.view(4 * nb, c, h // 4, w)
    r = gn_fwd_cluster_size(bf16, *xs.shape[:2], math.prod(xs.shape[2:]), 32)
    y = took(cases["gn_silu_fwd"], K["gn_silu_fwd"], r > 0,
             lambda: K["gn_silu_fwd"](xs, gam, bet, 32, 1e-5, "silu"),
             f"gn_silu_fwd {tuple(xs.shape)}", body="cluster")
    cases["gn_silu_fwd"].add_err("bf16", sliced(
        y, lambda i: gn_silu_fwd_plain(xs[i:i + 16], gam, bet, 32, 1e-5, "silu"), 4 * nb,
        *tol["bf16"], f"gn_silu_fwd {tuple(xs.shape)}"))
    del y
    r = gn_bwd_cluster_size(bf16, *xs.shape[:2], math.prod(xs.shape[2:]), 32)
    dx, dgam, dbet = took(cases["gn_silu_bwd"], K["gn_silu_bwd"], r > 0,
                          lambda: K["gn_silu_bwd"](xs, xs, gam, bet, 32, 1e-5, "silu"),
                          f"gn_silu_bwd {tuple(xs.shape)}", body="cluster")
    parts = [gn_silu_bwd_plain(xs[i:i + 16], xs[i:i + 16], gam, bet, 32, 1e-5, "silu")
             for i in range(0, 4 * nb, 16)]
    what = f"gn_silu_bwd {tuple(xs.shape)}"
    cases["gn_silu_bwd"].add_err("bf16", max(
        assert_close(dx[i * 16:(i + 1) * 16], p[0], *gn_bwd_tol["bf16"], f"{what} dx")
        for i, p in enumerate(parts)))
    # the per-channel sums over B*H*W elements (2^24 at the full shape, up to
    # ~10^7): relative limits, and left out of the absolute error reported
    assert_close(dgam, sum(p[1] for p in parts), 0.0, 1e-3, f"{what} dgamma")
    assert_close(dbet, sum(p[2] for p in parts), 0.0, 1e-3, f"{what} dbeta")
    del x, xs, dx, parts
    torch.cuda.empty_cache()

    # LIMIT_HEADS heads of 64 tokens at head dim 8 (the smallest the kernels
    # take, which no main-path shape uses), f32, every attention kernel
    bh, s, d = LIMIT_HEADS, 64, 8
    q, k, v, do = (randn(bh, s, d) for _ in range(4))
    cases["attn_fwd"].add_err("f32", assert_close(
        K["attn_fwd"](q, k, v, d**-0.5), attn_fwd_plain(q, k, v, d**-0.5), *attn_tol["f32"],
        f"attn_fwd {bh} heads"))
    cases["attn_fwd_v2"].add_err("f32", assert_close(
        K["attn_fwd_v2"](q, k, v, d**-0.5), attn_fwd_v2_plain(q, k, v, d**-0.5),
        *attn_tol["f32"], f"attn_fwd_v2 {bh} heads"))
    bias = torch.where(torch.arange(s, device=q.device) < 40, 0.0, -10000.0)
    bias = bias.expand(bh // 2, 1, s).contiguous()
    cases["attn_fwd_bias"].add_err("f32", assert_close(
        K["attn_fwd_bias"](q, k, v, bias, 2, d**-0.5),
        attn_fwd_bias_plain(q, k, v, bias, 2, d**-0.5), *attn_tol["f32"],
        f"attn_fwd_bias {bh} heads"))
    check_bwd(K, cases, q, k, v, do, d**-0.5, attn_bwd_tol["f32"], (1e-4, 1e-3),
              f"{bh} heads f32")


def cluster_counts(ops) -> dict:
    """Cluster launches of each kernel that has a thread-block-cluster body."""
    return {n: fn.cluster_launches for n, fn in ops.all_kernels().items()
            if hasattr(fn, "cluster_launches")}


def off_cluster(cluster: dict, launches: dict) -> list:
    """A problem for each kernel of `cluster` (its cluster launches) that a
    counted path launched off its cluster body: every path's shape takes it."""
    return [f"{launches[n] - c} of {launches[n]} {n} launches off the cluster body"
            for n, c in cluster.items() if c != launches[n]]


def tc_fields(fn, tc_by_path, cluster_by_path) -> dict:
    """The kernels line's extra fields of the kernels with a tensor-core body
    (`source`): its launches on the counted paths, and the source of the
    CUDA-core body that runs what it does not take (attention: other head
    dims; w8a8_matmul: K % 16 != 0; winograd_conv3x3 has none); of
    gn_silu_fwd and gn_silu_bwd, their launches on the cluster body over the
    counted paths."""
    if hasattr(fn, "cluster_launches"):
        return {"cluster_launches": sum(c.get(fn.__name__, 0) for c in cluster_by_path.values())}
    if not hasattr(fn, "tc_launches"):
        return {}
    fields = {"tc_launches": sum(tc.get(fn.__name__, 0) for tc in tc_by_path.values())}
    if hasattr(fn, "core_source"):  # winograd_conv3x3 has no CUDA-core body
        fields["core_source"] = fn.core_source
    return fields


def int8_order_phase(C, quantized) -> None:
    """The int8 quantize order on the card (`cast_params`): from one seeded
    f32 UNet, quant="all" with cast_params=False (JAX's `from_components`:
    the f32 weights quantized) and True (cast to bf16 first, as `Tango()`).
    Logs the int8 weights that differ between the two, the scales that do,
    and the relative L2 between the latents of one 2-step generate in each
    order (JAX's end-to-end bar for the int8 mode is 0.05)."""
    from tango_tpu_torch.models.unet import UNet2DConditionModel
    from tango_tpu_torch.utils.init import init_random_

    with torch.device("meta"):
        unet = UNet2DConditionModel(C.TANGO_UNET)
    unet = init_random_(unet.to_empty(device=DEVICE), torch.Generator(device=DEVICE).manual_seed(7))
    f32_params = unet.state_dict()
    del unet
    int8, latents = [], []
    for cast in (False, True):
        t = quantized("all", unet_params=f32_params, cast_params=cast)
        sd = t.model.unet.state_dict()
        int8.append({k: v for k, v in sd.items() if v.dtype == torch.int8 or
                     k.endswith("weight_scale")})
        latents.append(t.sample_latents([PROMPT], 2, 3.0, 1, 0).float())
        del t, sd
    del f32_params
    weights = [k for k, v in int8[0].items() if v.dtype == torch.int8]
    flips = sum(int((int8[0][k] != int8[1][k]).sum()) for k in weights)
    total = sum(int8[0][k].numel() for k in weights)
    scales = [k + "_scale" for k in weights]
    rel = ((latents[0] - latents[1]).norm() / latents[0].norm()).item()
    finite = all(bool(torch.isfinite(x).all()) for x in latents)
    log("int8_order", int8_weights=total, flips=flips, flip_share=flips / total,
        scales_differing=sum(int((int8[0][k] != int8[1][k]).sum()) for k in scales),
        scales=sum(int8[0][k].numel() for k in scales),
        max_scale_rel_diff=max(((int8[0][k] - int8[1][k]).abs() / int8[0][k]).max().item()
                               for k in scales),
        latents_rel_l2=rel, jax_bar=0.05, finite=finite)
    if not finite:
        raise AssertionError("int8 quantize order: non-finite latents")
    del int8, latents
    torch.cuda.empty_cache()


def reference_vae_state_dict(vae_sd: dict, vocoder_sd: dict) -> dict:
    """The port's serving VAE (decode side) and HiFi-GAN state dicts under
    AudioLDM's names, f32 on the host, the vocoder under `vocoder.` and
    weight-normed as released (`weight_g` = ||w|| over every dimension but
    0, `weight_v` = w), so that loading folds it. Builds the smoke's test
    snapshot, nothing else."""
    rules = ((r"\b(down|up)_(\d+)_(block|attn)_(\d+)\.", r"\1.\2.\3.\4."),
             (r"\b(down|up)_(\d+)_(downsample|upsample)\.", r"\1.\2.\3."),
             (r"\bmid_(block_1|block_2|attn_1)\.", r"mid.\1."),
             (r"^ups_(\d+)\.", r"ups.\1."),
             (r"^resblocks_(\d+)\.convs([12])_(\d+)\.", r"resblocks.\1.convs\2.\3."))

    def rename(k):
        for rx, rep in rules:
            k = re.sub(rx, rep, k)
        return k

    out = {rename(k): v.detach().to("cpu", torch.float32) for k, v in vae_sd.items()}
    for k, v in vocoder_sd.items():
        w, k = v.detach().to("cpu", torch.float32), "vocoder." + rename(k)
        if k.endswith(".weight"):
            out[k + "_g"] = w.norm(dim=tuple(range(1, w.dim())), keepdim=True)
            out[k + "_v"] = w
        else:
            out[k] = w
    return out


def random_encoder(C, seed: int) -> dict:
    """Seeded random weights of TANGO_VAE's encoder and quant_conv (the
    serving pipeline has none), for the snapshot's VAE bin."""
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.utils.init import init_random_

    with torch.device("meta"):
        vae = AutoencoderKL(C.TANGO_VAE, with_encoder=True)
    vae = init_random_(vae.to_empty(device=DEVICE), torch.Generator(device=DEVICE).manual_seed(seed))
    return {k: v for k, v in vae.state_dict().items() if k.startswith(("encoder.", "quant_conv."))}


def write_snapshot(root: str, C, tango, encoder: dict) -> dict:
    """A full-width reference-format snapshot of pipeline `tango`'s weights
    in `root`: the main bin through the port's `save_main_bin`, the VAE bin
    (the decoder, the `encoder` state dict's encoder and quant_conv, as
    released snapshots ship them, and the vocoder) through
    `reference_vae_state_dict`, and the four JSON configs (the VAE's
    geometry nested in `ddconfig`, as released). Returns bytes and seconds."""
    from tango_tpu_torch.utils.export import save_main_bin

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    save_main_bin(os.path.join(root, "pytorch_model_main.bin"), tango.model.unet.state_dict(),
                  tango.t5.state_dict())
    torch.save(reference_vae_state_dict({**tango.vae.state_dict(), **encoder},
                                        tango.vocoder.state_dict()),
               os.path.join(root, "pytorch_model_vae.bin"))
    vae = C.TANGO_VAE.to_dict()
    unet = {k: v for k, v in C.TANGO_UNET.to_dict().items() if not k.startswith("quant_")}
    configs = {
        "main_config.json": {"text_encoder_name": "google/flan-t5-large",
                             "scheduler_name": "stabilityai/stable-diffusion-2-1",
                             "unet_model_config_path": "unet_config.json"},
        "vae_config.json": {"embed_dim": vae.pop("embed_dim"),
                            "scale_factor": vae.pop("scale_factor"), "ddconfig": vae},
        "unet_config.json": {"_class_name": "UNet2DConditionModel", "act_fn": "silu", **unet},
        "stft_config.json": C.TANGO_STFT.to_dict(),
    }
    for name, cfg in configs.items():
        with open(os.path.join(root, name), "w") as f:
            json.dump(cfg, f, indent=2)
    seconds = time.perf_counter() - t0
    sizes = {n: os.path.getsize(os.path.join(root, n)) for n in sorted(os.listdir(root))}
    return {"write_s": round(seconds, 3), "bytes": sum(sizes.values()),
            "bin_bytes": {n: b for n, b in sizes.items() if n.endswith(".bin")}}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step at each element of x (8 significand bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0**-126)))
    return torch.exp2(e - 7)


def compare_loaded(tango, loaded) -> dict:
    """The loaded pipeline's parameters against the pipeline it was written
    from: the UNet, T5 and VAE bit-equal (bf16 -> f32 -> bf16 is exact), the
    vocoder within one bf16 step (the weight-norm fold). Raises otherwise."""
    out, problems = {}, []
    for name in ("unet", "t5", "vae", "vocoder"):
        a = (tango.model.unet if name == "unet" else getattr(tango, name)).state_dict()
        b = (loaded.model.unet if name == "unet" else getattr(loaded, name)).state_dict()
        if set(a) != set(b):
            problems.append(f"{name}: keys differ")
            continue
        differ = sum(int((a[k] != b[k]).sum()) for k in a)
        worst = max(((a[k].float() - b[k].float()).abs() / bf16_ulp(a[k])).max().item()
                    for k in a)
        out[name] = {"tensors": len(a), "elements": sum(v.numel() for v in a.values()),
                     "differ": differ, "max_ulps": worst}
        if name != "vocoder" and differ:
            problems.append(f"{name}: {differ} elements differ")
        if worst > 1.0:
            problems.append(f"{name}: {worst} bf16 steps off")
    if problems:
        raise AssertionError(f"loaded snapshot: {'; '.join(problems)} ({out})")
    return out


def cli_phase(root: str, snapshot: str, wav_len: int) -> dict:
    """`tango_tpu_torch.inference.main` on the snapshot, in `root` (its
    summary.jsonl goes to the working directory): 3 prompts, 2 steps, batch
    2; three non-silent int16 WAVs of wav_len samples and one record."""
    import wave

    import numpy as np

    from tango_tpu_torch import inference

    os.makedirs(root, exist_ok=True)
    manifest = os.path.join(root, "prompts.json")
    with open(manifest, "w") as f:
        f.write("".join(json.dumps({"location": f"x{i}.wav", "captions": c}) + "\n"
                        for i, c in enumerate(BATCH_PROMPTS)))
    out_dir = os.path.join(root, "out")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        inference.main(["--model", snapshot, "--test_file", manifest, "--output_dir", out_dir,
                        "--num_steps", str(CLI_STEPS), "--batch_size", str(CLI_BATCH)])
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    problems, peaks = [], []
    for i in range(len(BATCH_PROMPTS)):
        with wave.open(os.path.join(out_dir, f"output_{i}.wav")) as w:
            if (w.getsampwidth(), w.getnchannels(), w.getframerate()) != (2, 1, 16000):
                problems.append(f"output_{i}.wav is not 16 kHz mono int16")
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        peaks.append(int(np.abs(pcm.astype(np.int32)).max()) if pcm.size else 0)
        if pcm.size != wav_len or peaks[-1] == 0:
            problems.append(f"output_{i}.wav: {pcm.size} samples, peak {peaks[-1]}")
    with open(os.path.join(root, "summary.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if len(records) != 1 or records[0]["num_prompts"] != len(BATCH_PROMPTS):
        problems.append(f"summary.jsonl: {records}")
    if problems:
        raise AssertionError("inference CLI: " + "; ".join(problems))
    return {"cli_s": round(seconds, 3), "cli_x_realtime": records[0]["x_realtime"],
            "cli_peaks": peaks}


def write_wavs(root: str, n: int, seconds: float, seed: int) -> str:
    """`n` seeded synthetic 16 kHz WAVs (a few partials and noise) and their
    JSON-lines manifest under `root`; returns the manifest's path."""
    import numpy as np

    from tango_tpu_torch.audio.wav import write_wav

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    rows = []
    for i in range(n):
        f0 = rng.uniform(80.0, 800.0)
        wav = sum(rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3))
                  for h in (1, 2, 3))
        wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.2, 2.0) * t))
        wav = wav + 0.02 * rng.standard_normal(t.shape)
        path = os.path.join(root, f"clip{i}.wav")
        write_wav(path, wav.astype(np.float32))
        rows.append({"dataset": "smoke", "location": path, "captions": TRAIN_CAPTIONS[i % 4]})
    manifest = os.path.join(root, "train.json")
    with open(manifest, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


def read_counters(ops) -> tuple[dict, dict, dict, dict]:
    """Every kernel's launches and launched shapes, and the tensor-core and
    cluster launches of the kernels with such bodies."""
    kernels = ops.all_kernels()
    return ({n: fn.launches for n, fn in kernels.items()},
            {n: set(fn.shapes) for n, fn in kernels.items()},
            {n: fn.tc_launches for n, fn in kernels.items() if hasattr(fn, "tc_launches")},
            cluster_counts(ops))


def body_problems(path: str, launches: dict, tc: dict, cluster: dict) -> list:
    """A training path's launch problems: a kernel of PATH_KERNELS[path] that
    never launched; a D = 64 attention launch (all of them, forward and
    backward, f32) off its tensor-core body; a GroupNorm off its cluster body."""
    problems = []
    idle = [n for n in PATH_KERNELS[path] if launches[n] == 0]
    if idle:
        problems.append(f"kernels never launched on the {path} path: {idle}")
    off = {n: (launches[n], tc[n]) for n in tc if tc[n] != launches[n]}
    if off:
        problems.append(f"launches off the tensor-core body (launches, tensor-core): {off}")
    return problems + off_cluster(cluster, launches)


def wav_samples(body: bytes):
    """A WAV response's int16 samples; raises unless it is 16 kHz mono int16."""
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(body)) as w:
        fmt = (w.getsampwidth(), w.getnchannels(), w.getframerate())
        if fmt != (2, 1, 16000):
            raise AssertionError(f"response WAV (width, channels, rate) {fmt}: expected "
                                 "16 kHz mono int16")
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def http(port: int, path: str, body: bytes | None = None, timeout: float = 300.0):
    """One request to the server on 127.0.0.1 -> (status, content type, body,
    seconds); a POST when `body` is given."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            out = (r.status, r.headers["Content-Type"], r.read())
    except urllib.error.HTTPError as e:
        out = (e.code, e.headers["Content-Type"], e.read())
    return (*out, time.perf_counter() - t0)


def serve_http_phase(snap_dir: str, counted, instrument, expect_len: int):
    """`serve.BatchingPredictor(max_batch=4)` set up on the snapshot (bf16 on
    the card; the load and the two warm-ups timed), `serve_http` on
    127.0.0.1 at port 0 in a thread. Counted as path `serve_http`: GET
    /healthz, 4 concurrent unseeded POST /generate at STEPS steps, which must
    ride one predict_batch and one generate_for_batch of batch 4, one seeded
    request, and two bad bodies (400). Then, uncounted, the seeded response
    must equal `generate` at that seed sample for sample. Returns counted's
    (launches, shapes)."""
    import threading

    import numpy as np

    from tango_tpu_torch import pipeline
    from tango_tpu_torch.serve import BatchingPredictor, serve_http

    timings, made, real = {}, [], pipeline.Tango

    def timed_tango(*a, **kw):
        """Tango(...), its construction and first generate / generate_for_batch
        (setup's warm-ups) timed."""
        t0 = time.perf_counter()
        t = real(*a, **kw)
        torch.cuda.synchronize()
        timings["load_s"] = round(time.perf_counter() - t0, 3)
        for name in ("generate", "generate_for_batch"):
            def timed(*args, _fn=getattr(t, name), _name=name, **kwargs):
                s0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                timings[f"warmup_{_name}_s"] = round(time.perf_counter() - s0, 3)
                return out
            setattr(t, name, timed)
        made.append(t)
        return t

    predictor = BatchingPredictor(max_batch=SERVE_BATCH)
    pipeline.Tango = timed_tango
    try:
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the default tokenizer's, checked in `snapshot`
            predictor.setup(snap_dir, device=DEVICE)
        timings["setup_s"] = round(time.perf_counter() - t0, 3)
    finally:
        pipeline.Tango = real
    tango = predictor.tango
    del tango.generate, tango.generate_for_batch  # the class's methods again
    batches, chunks = [], []
    predict_batch, generate_for_batch = predictor.predict_batch, tango.generate_for_batch

    def spy_predict_batch(prompts, **kw):
        batches.append(len(prompts))
        return predict_batch(prompts, **kw)

    def spy_generate_for_batch(prompts, **kw):
        chunks.append((len(prompts), kw.get("batch_size")))
        return generate_for_batch(prompts, **kw)

    predictor.predict_batch, tango.generate_for_batch = spy_predict_batch, spy_generate_for_batch
    server = serve_http(predictor, 0, "127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    remove = instrument(tango)
    latencies, seeded, bad = {}, {}, {}

    def drive():
        status = http(port, "/healthz")
        if status[:3] != (200, "text/plain", b"ok"):
            raise AssertionError(f"GET /healthz: {status[:3]}")
        results = {}

        def post(i, prompt):
            results[i] = http(port, "/generate",
                              json.dumps({"prompt": prompt, "steps": STEPS}).encode())

        threads = [threading.Thread(target=post, args=(i, p)) for i, p in enumerate(SERVE_PROMPTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads) or len(results) != len(SERVE_PROMPTS):
            raise AssertionError(f"{len(results)} of {len(SERVE_PROMPTS)} requests answered")
        st, ctype, body, sec = http(port, "/generate", json.dumps(
            {"prompt": PROMPT, "steps": STEPS, "seed": SERVE_SEED}).encode())
        seeded.update(status=st, ctype=ctype, body=body)
        for name, b in (("empty", b"{}"), ("not_json", b"not json")):
            bad[name] = http(port, "/generate", b)[0]
        outs = []
        for i, (st_i, ctype_i, body_i, sec_i) in sorted(results.items()):
            if (st_i, ctype_i) != (200, "audio/wav"):
                raise AssertionError(f"request {i}: {st_i} {ctype_i} {body_i[:200]!r}")
            latencies[f"request_{i}"] = round(sec_i, 3)
            outs.append(wav_samples(body_i))
        if (st, ctype) != (200, "audio/wav"):
            raise AssertionError(f"seeded request: {st} {ctype} {body[:200]!r}")
        latencies["seeded"] = round(sec, 3)
        outs.append(wav_samples(body))
        return outs, {"batched_requests": wall, "seeded_request": sec}

    def fields(launches):
        return dict(**timings, request_latency_s=latencies, predict_batch_sizes=batches,
                    generate_for_batch_calls=chunks, bad_body_status=bad)

    try:
        counted_out = counted("serve_http", drive, expect_len, extra=fields)
        problems = []
        if batches != [SERVE_BATCH] or chunks != [(SERVE_BATCH, SERVE_BATCH)]:
            problems.append(f"the {len(SERVE_PROMPTS)} requests rode predict_batch {batches} "
                            f"and generate_for_batch {chunks}: expected one batch of "
                            f"{SERVE_BATCH}")
        if bad != {"empty": 400, "not_json": 400}:
            problems.append(f"bad bodies answered {bad}, expected 400")
        want = tango.generate(PROMPT, steps=STEPS, seed=SERVE_SEED)
        got = wav_samples(seeded["body"])
        differ = int((got != want).sum()) if got.shape == want.shape else -1
        log("serve_http_seeded", samples=int(want.size), differ=differ,
            max_int16_diff=int(abs(got.astype("int32") - want.astype("int32")).max())
            if differ >= 0 else None)
        if differ:
            problems.append(f"the seeded response differs from generate at seed {SERVE_SEED} "
                            f"in {differ} samples (-1: in length)")
        if problems:
            raise AssertionError("serve_http: " + "; ".join(problems))
    finally:
        remove()
        server.shutdown()
        server.server_close()
        predictor.close()
    del predictor, tango, made, remove
    torch.cuda.empty_cache()
    return counted_out


def timed_methods(cls, names, times: dict):
    """Wrap methods `names` of `cls` to append each call's seconds (the card
    synchronized around it) to times[name]; returns the undo function."""
    saved = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(name, []).append(round(1e3 * (time.perf_counter() - s0), 3))
            return out
        return timed

    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))

    def undo():
        for n, fn in saved.items():
            setattr(cls, n, fn)
    return undo


def train_cli_phase(snap_dir: str, root: str, start: dict, ops) -> tuple:
    """`python -m tango_tpu_torch.train.cli`'s main on the snapshot (the VAE
    with its encoder from --tango_snapshot, the UNet and T5 from --hf_model)
    and 8 synthetic WAVs: batch 2, accumulation 2, 2 updates, one epoch,
    validation on the first 2 clips, `best` kept. Counters zeroed just
    before main and read after. `start`: the snapshot's UNet weights.
    Returns (launches, shapes, tc, cluster)."""
    import numpy as np

    from tango_tpu_torch.train import cli, sft
    from tango_tpu_torch.utils.checkpoint import load_native

    manifest = os.path.join(root, "data", "train.json")
    val = os.path.join(root, "data", "val.json")
    out = os.path.join(root, "train_cli")
    times = {}
    undo = timed_methods(sft.SFTTrainer, ("train_step",), times)
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the default tokenizer's
            state = cli.main(["--train_file", manifest, "--validation_file", val,
                              "--tango_snapshot", snap_dir, "--hf_model", snap_dir,
                              "--per_device_train_batch_size", str(TRAIN_BATCH),
                              "--gradient_accumulation_steps", "2", "--max_train_steps", "2",
                              "--num_train_epochs", "1", "--checkpointing_steps", "best",
                              "--output_dir", out, "--device", DEVICE])
        torch.cuda.synchronize()
    finally:
        undo()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, shapes, tc, cluster = read_counters(ops)
    problems = body_problems("train_cli", launches, tc, cluster)
    with open(os.path.join(out, "summary.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if (len(records) != 2 or set(records[0]) != {"args"}
            or not all(math.isfinite(records[1][k]) for k in ("train_loss", "val_loss"))):
        problems.append(f"summary.jsonl: {records}")
    if (state.step, state.opt_state.updates) != (4, 2):
        problems.append(f"{state.step} micro-steps, {state.opt_state.updates} updates: "
                        "expected 4, 2")
    best, _ = load_native(os.path.join(out, "best"))
    if set(best) != set(start):
        problems.append("the best checkpoint's keys are not the UNet's")
    elif all(torch.equal(best[k], start[k]) for k in start):
        problems.append("the best checkpoint equals the snapshot's UNet: no training happened")
    finite = all(bool(torch.isfinite(v).all()) for v in best.values())
    if not finite:
        problems.append("non-finite weights in the best checkpoint")
    log("train_cli", seconds=round(seconds, 3), peak_memory_bytes=peak,
        ms_per_micro_step=times.get("train_step"), records=records[1:], launches=launches,
        tc_launches=tc, cluster_launches=cluster,
        shapes={n: len(v) for n, v in shapes.items()}, problems=problems)
    del state, best
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("train_cli: " + "; ".join(problems))
    return launches, shapes, tc, cluster


def dpo_phase(snap_dir: str, root: str, start: dict, ops) -> tuple:
    """`python -m tango_tpu_torch.train.dpo_cli`'s main on the snapshot: a
    4-row preference manifest (chosen clips 0-3, rejected 4-7), batch 2,
    accumulation 1, 2 epochs of which 1 SFT-first, a 2-row validation file.
    Counters zeroed just before main and read after. Checks one `sft` and one
    `dpo` record, `last` and `best`, the reference UNet bit-equal to `start`
    (the snapshot's UNet) after the run, and every launch on its body.
    Returns (launches, shapes, tc, cluster)."""
    from tango_tpu_torch.train import dpo, dpo_cli

    rows = [{"captions": TRAIN_CAPTIONS[i], "chosen": os.path.join(root, "data", f"clip{i}.wav"),
             "rejected": os.path.join(root, "data", f"clip{i + 4}.wav")} for i in range(4)]
    prefs, val = os.path.join(root, "data", "prefs.json"), os.path.join(root, "data", "prefs_val.json")
    for path, part in ((prefs, rows), (val, rows[:2])):
        with open(path, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in part))
    out = os.path.join(root, "dpo")
    times = {}
    undo = timed_methods(dpo.DPOTrainer, ("dpo_step", "sft_step"), times)
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the default tokenizer's
            state, ref = dpo_cli.main(["--train_file", prefs, "--validation_file", val,
                                       "--tango_snapshot", snap_dir,
                                       "--per_device_train_batch_size", "2",
                                       "--gradient_accumulation_steps", "1",
                                       "--num_train_epochs", "2", "--sft_first_epochs", "1",
                                       "--output_dir", out, "--device", DEVICE])
        torch.cuda.synchronize()
    finally:
        undo()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, shapes, tc, cluster = read_counters(ops)
    problems = body_problems("dpo", launches, tc, cluster)
    with open(os.path.join(out, "summary.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if [r["phase"] for r in records] != ["sft", "dpo"] or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["val_loss"]) for r in records):
        problems.append(f"summary.jsonl: {records}")
    elif not 0.0 <= records[1]["implicit_acc"] <= 1.0:
        problems.append(f"implicit_acc {records[1]['implicit_acc']}")
    missing = [n for n in ("last", "best") if not os.path.exists(os.path.join(out, n, "params"))]
    if missing:
        problems.append(f"checkpoints missing: {missing}")
    ref_sd = ref.state_dict()
    ref_differ = sum(int((ref_sd[k].cpu() != start[k]).sum()) for k in start)
    if set(ref_sd) != set(start) or ref_differ:
        problems.append(f"the reference UNet moved: {ref_differ} elements differ from the "
                        "snapshot's")
    if any(p.grad is not None for p in ref.parameters()):
        problems.append("the reference UNet has gradients")
    log("dpo", seconds=round(seconds, 3), peak_memory_bytes=peak,
        ms_per_dpo_micro_step=times.get("dpo_step"), ms_per_sft_micro_step=times.get("sft_step"),
        records=records, reference_elements_differ=ref_differ, updates=state.opt_state.updates,
        launches=launches, tc_launches=tc, cluster_launches=cluster,
        shapes={n: len(v) for n, v in shapes.items()}, problems=problems)
    del state, ref, ref_sd
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("dpo: " + "; ".join(problems))
    return launches, shapes, tc, cluster


# ---- phase tango2_eval: Tango 2's inference CLI with the CLAP score and the
# objective evaluation, and the batch CLI's CLAP re-ranking

def renamed(sd: dict, rules, prefix: str = "") -> dict:
    """`sd` on the host in f32 under released names: each key through the
    first of `rules` (regex, replacement) that matches, then `prefix`."""
    out = {}
    for k, v in sd.items():
        for rx, rep in rules:
            k, n = re.subn(rx, rep, k)
            if n:
                break
        out[prefix + k] = v.detach().to("cpu", torch.float32)
    return out


# the port's names -> LAION-CLAP's (text_branch: HF RobertaModel), Cnn14's
# and torchvggish's: the converters' rules run backwards
CLAP_TEXT_NAMES = (
    (r"^(word|position|token_type)_embeddings\.", r"text_branch.embeddings.\1_embeddings."),
    (r"^embeddings_ln\.", "text_branch.embeddings.LayerNorm."),
    (r"^layer_(\d+)\.attention\.(query|key|value)\.",
     r"text_branch.encoder.layer.\1.attention.self.\2."),
    (r"^layer_(\d+)\.attention\.output_dense\.",
     r"text_branch.encoder.layer.\1.attention.output.dense."),
    (r"^layer_(\d+)\.attention_ln\.", r"text_branch.encoder.layer.\1.attention.output.LayerNorm."),
    (r"^layer_(\d+)\.intermediate\.", r"text_branch.encoder.layer.\1.intermediate.dense."),
    (r"^layer_(\d+)\.output\.", r"text_branch.encoder.layer.\1.output.dense."),
    (r"^layer_(\d+)\.output_ln\.", r"text_branch.encoder.layer.\1.output.LayerNorm."),
    (r"^pooler\.", "text_branch.pooler.dense."),
    (r"^proj_(\d)\.", r"text_projection.\1."))
CLAP_AUDIO_NAMES = (
    (r"^htsat\.bn0\.(mean|var)$", r"audio_branch.bn0.running_\1"),
    (r"^htsat\.patch_(proj|norm)\.", r"audio_branch.patch_embed.\1."),
    (r"^htsat\.layer_(\d+)_block_(\d+)\.mlp_fc(\d)\.",
     r"audio_branch.layers.\1.blocks.\2.mlp.fc\3."),
    (r"^htsat\.layer_(\d+)_block_(\d+)\.", r"audio_branch.layers.\1.blocks.\2."),
    (r"^htsat\.layer_(\d+)_downsample\.", r"audio_branch.layers.\1.downsample."),
    (r"^htsat\.", "audio_branch."),
    (r"^proj_(\d)\.", r"audio_projection.\1."))
CNN14_NAMES = ((r"\.(mean|var)$", r".running_\1"),)
VGGISH_NAMES = (tuple((rf"^conv{i}\.", f"features.{t}.")
                     for i, t in enumerate((0, 3, 6, 8, 11, 13)))
                + tuple((rf"^fc{i}\.", f"embeddings.{t}.") for i, t in enumerate((0, 2, 4))))


def write_scorer_checkpoints(root: str) -> dict:
    """Seeded random full-width scorers written in their released formats
    under `root`: a LAION-CLAP `.pt` ({"state_dict": ...}: RoBERTa-base,
    HTSAT-tiny and both projections, the audio side under `module.`), Cnn14
    (527 classes) as {"model": sd}, and torchvggish's state dict. Each
    converts back bit-equal to the weights it was written from (checked).
    Returns the paths and the seconds and bytes written."""
    from tango_tpu_torch.eval.panns import Cnn14, convert_cnn14
    from tango_tpu_torch.eval.vggish import VGGish, convert_vggish
    from tango_tpu_torch.models.clap import ROBERTA_BASE, ClapTextEncoder, convert_clap_text
    from tango_tpu_torch.models.htsat import HTSAT_TINY, ClapAudioEncoder, convert_clap_audio
    from tango_tpu_torch.utils.init import init_random_

    def made(make, seed):
        with torch.device("meta"):
            m = make()
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        return init_random_(m.to_empty(device=DEVICE), gen).state_dict()

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    text = made(lambda: ClapTextEncoder(ROBERTA_BASE), 11)
    audio = made(lambda: ClapAudioEncoder(HTSAT_TINY), 12)
    c14, vgg = made(Cnn14, 13), made(VGGish, 14)
    clap = {**renamed(text, CLAP_TEXT_NAMES), **renamed(audio, CLAP_AUDIO_NAMES, "module.")}
    cnn14, vggish = renamed(c14, CNN14_NAMES), renamed(vgg, VGGISH_NAMES)
    unprefixed = {k[len("module."):] if k.startswith("module.") else k: v for k, v in clap.items()}
    problems = [what for what, ours, back in (
        ("clap text", text, convert_clap_text(unprefixed)),
        ("clap audio", audio, convert_clap_audio(unprefixed, HTSAT_TINY)),
        ("cnn14", c14, convert_cnn14(cnn14)), ("vggish", vgg, convert_vggish(vggish)))
        if set(ours) != set(back) or any(not torch.equal(ours[k].cpu(), back[k]) for k in ours)]
    del text, audio, c14, vgg, unprefixed
    if problems:
        raise AssertionError(f"released-format checkpoints do not convert back: {problems}")
    paths = {n: os.path.join(root, f) for n, f in (("clap", "clap.pt"), ("cnn14", "cnn14.pth"),
                                                   ("vggish", "vggish.pth"))}
    torch.save({"state_dict": clap}, paths["clap"])
    torch.save({"model": cnn14}, paths["cnn14"])
    torch.save(vggish, paths["vggish"])
    return {"paths": paths, "write_s": round(time.perf_counter() - t0, 3),
            "bytes": {n: os.path.getsize(p) for n, p in paths.items()}}


def write_references(root: str, n: int, seconds: float, seed: int) -> str:
    """`n` seeded ground-truth WAVs named as the CLI's outputs (output_{i}.wav,
    the evaluation's pairing) in `root`."""
    manifest = write_wavs(root, n, seconds, seed)
    for i in range(n):
        os.replace(os.path.join(root, f"clip{i}.wav"), os.path.join(root, f"output_{i}.wav"))
    os.remove(manifest)
    return root


def read_int16(path: str):
    import wave

    import numpy as np

    with wave.open(path) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def card_vs_cpu(what: str, card, cpu, limit: float, scale: float = 1.0) -> dict:
    """Largest |card - cpu| over `scale` (1, or the CPU output's largest
    magnitude) against `limit`."""
    import numpy as np

    err = float(np.abs(np.asarray(card, np.float64) - np.asarray(cpu, np.float64)).max()) / scale
    return {"what": what, "err": err, "limit": limit, "ok": bool(err <= limit)}


def tango2_eval_phase(snap_dir: str, root: str, ops) -> tuple:
    """Phase `tango2_eval` on the snapshot, counted as one path (the counters
    zeroed just before the two CLI runs and read just after): seeded random
    full-width scorers written in their released formats and 4 reference
    WAVs; `inference_tango2.main` with --clap_ckpt, --reference_dir,
    --cnn14_ckpt and --vggish_ckpt (TANGO2_PROMPTS, STEPS steps, batch 4, the
    RoBERTa-id fallback tokenizer); `inference.main` with --num_samples 2
    and --clap_ckpt (batch 2). Checks JAX's record keys, a finite CLAP score
    in [-1, 1], finite metrics (IS NaN: its 10 splits need 10 clips, as in
    JAX), every tower's weights on the card, each re-ranked WAV its group's
    argmax of the similarity recomputed here, the generation's launches on
    their bodies; then, uncounted, the full-width towers (and HTSAT's latent
    map) on the card against the same modules on the CPU in f32
    (CARD_CPU_LIMITS). Returns (launches,
    shapes, tc, cluster)."""
    import numpy as np

    from tango_tpu_torch import inference, inference_tango2, pipeline
    from tango_tpu_torch.audio.wav import resample_poly
    from tango_tpu_torch.eval import evaluator
    from tango_tpu_torch.models.htsat import clap_logmel

    t_phase = time.perf_counter()
    ckpts = write_scorer_checkpoints(os.path.join(root, "scorers"))
    paths = ckpts["paths"]
    refs = write_references(os.path.join(root, "refs"), len(TANGO2_PROMPTS), 10.24, seed=5)
    manifest = os.path.join(root, "tango2.json")
    with open(manifest, "w") as f:
        f.write("".join(json.dumps({"location": f"x{i}.wav", "captions": c}) + "\n"
                        for i, c in enumerate(TANGO2_PROMPTS)))
    towers, loads, groups = [], {}, []
    real_load, real_init = inference_tango2.load_clap, evaluator.EvaluationHelper.__init__
    real_gen = pipeline.Tango.generate_for_batch

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        clap = real_load(*a, **kw)
        torch.cuda.synchronize()
        loads.setdefault("load_clap_s", []).append(round(time.perf_counter() - t0, 3))
        towers.extend([("clap_text", clap.text.model), ("clap_audio", clap.audio_model)])
        return clap

    def timed_init(self, *a, **kw):
        t0 = time.perf_counter()
        real_init(self, *a, **kw)
        torch.cuda.synchronize()
        loads.setdefault("evaluation_helper_s", []).append(round(time.perf_counter() - t0, 3))
        towers.extend([("cnn14", self.cnn14), ("vggish", self.vggish)])

    def kept_gen(self, *a, **kw):
        groups.append(real_gen(self, *a, **kw))
        return groups[-1]

    out2, out1 = os.path.join(root, "tango2_out"), os.path.join(root, "rerank_out")
    common = ["--model", snap_dir, "--test_file", manifest, "--num_steps", str(STEPS),
              "--clap_ckpt", paths["clap"], "--device", DEVICE]
    inference_tango2.load_clap, evaluator.EvaluationHelper.__init__ = timed_load, timed_init
    pipeline.Tango.generate_for_batch = kept_gen
    cwd = os.getcwd()
    os.chdir(root)
    seconds = {}
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            record = inference_tango2.main(common + [
                "--output_dir", out2, "--batch_size", str(TANGO2_BATCH), "--reference_dir", refs,
                "--cnn14_ckpt", paths["cnn14"], "--vggish_ckpt", paths["vggish"]])
            torch.cuda.synchronize()
            seconds["tango2_cli_s"] = round(time.perf_counter() - t0, 3)
            t0 = time.perf_counter()
            inference.main(common + ["--output_dir", out1, "--batch_size", str(RERANK_BATCH),
                                     "--num_samples", str(RERANK_SAMPLES)])
            torch.cuda.synchronize()
            seconds["rerank_cli_s"] = round(time.perf_counter() - t0, 3)
    finally:
        inference_tango2.load_clap, evaluator.EvaluationHelper.__init__ = real_load, real_init
        pipeline.Tango.generate_for_batch = real_gen
        os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated()
    launches, shapes, tc, cluster = read_counters(ops)
    problems = body_problems("tango2_eval", launches, tc, cluster)
    fallback_warned = any("RoBERTa" in str(w.message) for w in caught)

    # the record, against JAX's keys
    metrics = record.get("metrics", {})
    if set(record) != TANGO2_RECORD_KEYS or set(metrics) != METRIC_KEYS:
        problems.append(f"record keys {sorted(record)}, metrics {sorted(metrics)}")
    elif not (math.isfinite(record["clap_score"]) and -1.0 <= record["clap_score"] <= 1.0):
        problems.append(f"clap_score {record['clap_score']}")
    nonfinite = sorted(k for k, v in metrics.items() if not math.isfinite(v))
    if nonfinite != ["is_mean", "is_std"]:
        problems.append(f"non-finite metrics {nonfinite} (only IS is NaN with 4 clips)")
    off_card = [n for n, m in towers if m is None or any(
        t.device.type != "cuda" for t in (*m.parameters(), *m.buffers()))]
    if len(towers) != 6 or off_card:
        problems.append(f"towers {[n for n, _ in towers]}, not on the card: {off_card}")
    if not fallback_warned:
        problems.append("the default CLAP tokenizer did not warn")

    # the re-ranking, recomputed: each output_{i}.wav is its group's argmax
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clap = real_load(paths["clap"], device=DEVICE)
        clap_cpu = real_load(paths["clap"], device="cpu")
    rerank = []
    for i, (prompt, group) in enumerate(zip(TANGO2_PROMPTS, groups[-1])):
        sims = clap.similarity(np.stack([g.astype(np.float32) / 32768.0 for g in group]), prompt)
        pick = int(np.argmax(sims))
        rerank.append({"sims": [round(float(s), 6) for s in sims], "pick": pick})
        if not np.array_equal(read_int16(os.path.join(out1, f"output_{i}.wav")), group[pick]):
            problems.append(f"rerank output_{i}.wav is not its group's CLAP argmax {pick}")

    # the full-width towers on the card against the same modules on the CPU
    waves = np.stack([w.astype(np.float32) / 32768.0 for w in groups[0]])
    clap.audio_batch = clap_cpu.audio_batch = len(waves)
    files = [os.path.join(out2, f"output_{i}.wav") for i in range(len(TANGO2_PROMPTS))]
    card, cpu = (evaluator.EvaluationHelper(16000, device=d, cnn14_ckpt=paths["cnn14"],
                                            vggish_ckpt=paths["vggish"]) for d in (DEVICE, "cpu"))
    card.batch_size = cpu.batch_size = len(files)
    f_card, f_cpu = card.cnn14_features(files), cpu.cnn14_features(files)
    v_card, v_cpu = card.vggish_embeddings(files), cpu.vggish_embeddings(files)
    errors = [
        card_vs_cpu("clap_text", clap.text_embed(TANGO2_PROMPTS),
                    clap_cpu.text_embed(TANGO2_PROMPTS), CARD_CPU_LIMITS["clap_text"]),
        card_vs_cpu("clap_audio", clap.audio_embed(waves), clap_cpu.audio_embed(waves),
                    CARD_CPU_LIMITS["clap_audio"])]
    # HTSAT's trunk alone, on one log-mel: the latent map before pooling and
    # projection, where its TF32 patch convolution shows
    cfg = clap.audio_cfg
    mel = clap_logmel(torch.from_numpy(np.stack(
        [resample_poly(w, 16000, cfg.sample_rate)[:cfg.clip_samples] for w in waves])), cfg)
    with torch.inference_mode():
        lat_card = clap.audio_model.htsat(mel.to(DEVICE))["latent_map"].cpu().numpy()
        lat_cpu = clap_cpu.audio_model.htsat(mel)["latent_map"].numpy()
    errors.append(card_vs_cpu("htsat_latent_map", lat_card, lat_cpu, CARD_CPU_LIMITS["htsat"],
                              float(np.abs(lat_cpu).max())))
    for key in ("2048", "logits"):
        errors.append(card_vs_cpu(f"cnn14_{key}", f_card[key], f_cpu[key],
                                  CARD_CPU_LIMITS["cnn14"], float(np.abs(f_cpu[key]).max())))
    errors.append(card_vs_cpu("vggish", v_card, v_cpu, CARD_CPU_LIMITS["vggish"],
                              float(np.abs(v_cpu).max())))
    problems += [f"{e['what']}: card vs CPU {e['err']:.3g} over its limit {e['limit']}"
                 for e in errors if not e["ok"]]
    log("tango2_eval", phase_s=round(time.perf_counter() - t_phase, 3), **seconds,
        checkpoints_write_s=ckpts["write_s"], checkpoint_bytes=ckpts["bytes"], **loads,
        peak_memory_bytes=peak, clap_score=record.get("clap_score"), metrics=metrics,
        rerank=rerank, card_vs_cpu=errors, fallback_tokenizer_warned=fallback_warned,
        launches=launches, tc_launches=tc, cluster_launches=cluster,
        shapes={n: len(v) for n, v in shapes.items()}, problems=problems)
    del clap, clap_cpu, card, cpu, towers, groups
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("tango2_eval: " + "; ".join(problems))
    return launches, shapes, tc, cluster

def train_phase(C, ops) -> tuple[dict, dict, dict, dict]:
    """One full-width f32 SFTTrainer.fit on the card: 4 micro-steps at batch
    2 with accumulation 2 (2 updates), one validation batch, the best
    checkpoint saved, loaded back and deleted. Returns the launches, shapes,
    tensor-core launches and cluster launches of the counted run; raises on
    any failed check."""
    from tango_tpu_torch.models.diffusion import AudioDiffusion
    from tango_tpu_torch.models.t5 import T5Encoder
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.tokenizer import WordHashTokenizer
    from tango_tpu_torch.train import sft
    from tango_tpu_torch.train.data import FeaturizedLoader, load_manifest, validate_manifest
    from tango_tpu_torch.utils.checkpoint import load_native
    from tango_tpu_torch.utils.init import init_random_

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def frozen(make):
        with torch.device("meta"):
            m = make()
        return init_random_(m.to_empty(device=DEVICE), gen).eval().requires_grad_(False)

    diffusion = AudioDiffusion(C.TANGO_UNET, C.SD21_SCHEDULER, snr_gamma=5.0, uncondition=True,
                               remat=True, device=DEVICE)
    vae = frozen(lambda: AutoencoderKL(C.TANGO_VAE, with_encoder=True))
    t5 = frozen(lambda: T5Encoder(C.FLAN_T5_LARGE))
    cfg = C.TrainConfig(gradient_accumulation_steps=2, max_train_steps=2,
                        per_device_train_batch_size=TRAIN_BATCH, augment=False)
    trainer = sft.SFTTrainer(diffusion, vae, cfg, total_steps=cfg.max_train_steps)
    state = trainer.init_state(gen)
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in diffusion.unet.parameters())
    log("train_model", seconds=round(time.perf_counter() - t0, 3), unet_params=n_unet,
        dtype=str(diffusion.unet.conv_in.weight.dtype))

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    examples = load_manifest(write_wavs(os.path.join(root, "data"), TRAIN_WAVS, 10.24, seed=0))
    validate_manifest(examples)
    tok = WordHashTokenizer(C.FLAN_T5_LARGE.vocab_size)
    train_batches = sft.encode_batches(
        FeaturizedLoader(examples, TRAIN_BATCH, target_length=1024, seed=0), tok, t5)
    val_batches = sft.encode_batches(
        FeaturizedLoader(examples[:TRAIN_BATCH], TRAIN_BATCH, target_length=1024,
                         shuffle=False), tok, t5)

    # watch each micro-step: its loss, its time, and one parameter tensor
    watched = diffusion.unet.conv_in.weight
    micro = []  # (seconds, loss, watched parameter changed since the last step)
    step, save = trainer.train_step, sft.save_native
    saves = []

    def timed_step(st, batch, generator=None):
        before = watched.detach().clone()
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = step(st, batch, generator)
        torch.cuda.synchronize()
        micro.append((time.perf_counter() - s0, float(out[1]),
                      not torch.equal(before, watched.detach())))
        return out

    def timed_save(*a, **kw):
        s0 = time.perf_counter()
        save(*a, **kw)
        saves.append(time.perf_counter() - s0)

    records = []
    trainer.train_step, sft.save_native = timed_step, timed_save
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.fit(state, train_batches, val_batches, gen, os.path.join(root, "run"),
                        num_epochs=1, log_fn=records.append)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, shapes, tc, cluster = read_counters(ops)
    trainer.train_step, sft.save_native = step, save

    problems = []
    losses = [m[1] for m in micro] + [r["val_loss"] for r in records]
    if not all(math.isfinite(v) for v in losses):
        problems.append(f"non-finite loss: {losses}")
    if [m[2] for m in micro] != [False, True, False, True]:
        problems.append(f"parameters changed after micro-steps {[m[2] for m in micro]}, "
                        "expected after the 2nd and 4th only")
    if state.step != 4 or state.opt_state.updates != 2 or len(records) != 1:
        problems.append(f"{state.step} micro-steps, {state.opt_state.updates} updates, "
                        f"{len(records)} validations: expected 4, 2, 1")
    t0 = time.perf_counter()
    best, manifest = load_native(os.path.join(root, "run", "best"))
    load_s = time.perf_counter() - t0
    live = diffusion.unet.state_dict()
    if set(best) != set(live) or not all(torch.equal(best[k], live[k].cpu()) for k in live):
        problems.append("the best checkpoint does not load back bit-equal")
    del best
    shutil.rmtree(root)
    # every attention of training is f32 at head dim 64: the forward's on the
    # 3xTF32 body, the backward's on theirs; every single-pass GroupNorm and
    # GroupNorm backward on its cluster body
    problems += body_problems("train", launches, tc, cluster)
    log("train", fit_s=round(fit_s, 3), micro_steps=len(micro), tc_launches=tc,
        cluster_launches=cluster,
        ms_per_micro_step=[round(1e3 * m[0], 3) for m in micro],
        losses=[m[1] for m in micro], val_loss=[r["val_loss"] for r in records],
        peak_memory_bytes=peak, checkpoint_save_s=[round(v, 3) for v in saves],
        checkpoint_load_s=round(load_s, 3), checkpoint_manifest=manifest, launches=launches,
        launches_per_micro_step={n: c / max(len(micro), 1) for n, c in launches.items()},
        shapes={n: len(v) for n, v in shapes.items()}, problems=problems)
    if problems:
        raise AssertionError("; ".join(problems))
    del trainer, state, diffusion, vae, t5
    torch.cuda.empty_cache()
    return launches, shapes, tc, cluster


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
    from tango_tpu_torch.ops.quant import QLinear
    from tango_tpu_torch.ops.winograd import wino_supported
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

    # ---- the serving paths, each counted on its own
    checks = {}
    tc_launches = {}  # path -> tensor-core launches of each kernel that has such a body
    cluster_launches = {}  # path -> cluster launches of each kernel that has such a body
    sample_times = {}  # CFG batch of the UNet -> [seconds, steps]
    first_latents = {}  # path -> the latents of its first decode
    first_wavs = {}  # path -> its first waveform

    def instrument(t):
        """Check every decode of pipeline t and time every sampling loop;
        returns the function that takes the instruments off again."""
        decode, sample = t.decode, t.model.sample

        def checked_decode(latents):
            checks["latents_finite"] &= bool(torch.isfinite(latents).all())
            first_latents.setdefault(checks["path"], latents.float().clone())
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

        t.decode, t.model.sample = checked_decode, timed_sample

        def remove():
            t.decode, t.model.sample = decode, sample
        return remove

    def counted(path, drive, expect_len, phase=None, extra=None):
        """Zero the counters, run `drive` (-> waveforms, seconds by call), read
        the counters; check the waveforms and that the path's kernels ran; log
        it as `phase` (the path's name by default), with the fields
        `extra(launches)` adds."""
        checks.update(latents_finite=True, mel_finite=True, path=path)
        sample_times.clear()
        ops.reset_counters()
        outs, seconds = drive()
        torch.cuda.synchronize()
        first_wavs[path] = outs[0]
        launches, shapes, tc, cluster = read_counters(ops)
        problems = []
        if path in TC_PATHS and any(tc[n] != launches[n] for n in tc):
            problems.append(f"launches off the tensor-core body: launches "
                            f"{ {n: launches[n] for n in tc} }, tensor-core {tc}")
        problems += off_cluster(cluster, launches)
        for w in outs:
            if w.dtype.name != "int16" or w.shape != (expect_len,):
                problems.append(f"waveform {w.dtype} {w.shape}, expected int16 ({expect_len},)")
            if int(abs(w.astype("int32")).max()) == 0:
                problems.append("a silent waveform")
        if not (checks["latents_finite"] and checks["mel_finite"]):
            problems.append(f"non-finite values: {checks}")
        idle = [n for n in PATH_KERNELS.get(path, ()) if launches[n] == 0]
        if idle:
            problems.append(f"kernels never launched on the {path} path: {idle}")
        log(phase or path, **{f"{k}_s": round(v, 3) for k, v in seconds.items()},
            ms_per_unet_step={f"cfg_batch_{b}": round(1e3 * t / n, 3)
                              for b, (t, n) in sorted(sample_times.items())},
            launches=launches, tc_launches=tc, cluster_launches=cluster,
            shapes={n: len(v) for n, v in shapes.items()},
            wav_len=expect_len, peak=[int(abs(w.astype("int32")).max()) for w in outs],
            **(extra(launches) if extra else {}), problems=problems)
        if problems:
            raise AssertionError("; ".join(problems))
        tc_launches[path] = tc
        cluster_launches[path] = cluster
        return launches, shapes

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def single(t, steps=STEPS, **kw):
        """One generate of PROMPT at seed 0 through pipeline t."""
        def drive():
            wav, t_gen = timed(lambda: t.generate(PROMPT, steps=steps, seed=0, **kw))
            return [wav], {"generate": t_gen}
        return drive

    def serve():
        wav, t_gen = timed(lambda: tango.generate(PROMPT, steps=STEPS, guidance=3.0, seed=0))
        wavs, t_batch = timed(lambda: tango.generate_for_batch(BATCH_PROMPTS, steps=STEPS,
                                                               batch_size=2, seed=0))
        if len(wavs) != len(BATCH_PROMPTS):
            raise AssertionError(f"{len(wavs)} waveforms for {len(BATCH_PROMPTS)} prompts")
        return [wav] + list(wavs), {"generate": t_gen, "generate_for_batch": t_batch}

    frames = tango.model.latent_t_size
    # 4x VAE, x160 vocoder, +32 samples of the vocoder's transposed-conv edge
    wav_len = lambda latent_t: latent_t * 4 * 160 + 32  # noqa: E731
    factor = 2 ** (len(tango.model.unet_config.block_out_channels) - 1)
    long_t = factor * max(round(LONG_CLIP_S * 25.6 / factor), 1)  # as Tango.generate
    remove = instrument(tango)
    by_path = {"serve": counted("serve", serve, wav_len(frames), phase="slice")}
    remove()

    # ---- a full-width reference-format snapshot of the same weights, written,
    # loaded by Tango(dir) (bf16, default tokenizer, cast_params=True), counted
    # as path `snapshot`, and run through the batch-generation CLI
    t_phase = time.perf_counter()
    snap_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_snapshot")
    shutil.rmtree(snap_root, ignore_errors=True)
    snap_dir = os.path.join(snap_root, "snapshot")
    written = write_snapshot(snap_dir, C, tango, random_encoder(C, seed=3))
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ts = Tango(snap_dir, device=DEVICE)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    params = compare_loaded(tango, ts)
    tokenizer_warned = any("WordHashTokenizer" in str(w.message) for w in caught)

    def snapshot_fields(launches):
        lat = (first_latents["snapshot"] - first_latents["serve"]).abs().max().item()
        wav = abs(first_wavs["serve"].astype("int32") - first_wavs["snapshot"].astype("int32"))
        return dict(**written, cold_start_s=round(cold_s, 3), dtype=str(ts.dtype),
                    tokenizer_warned=tokenizer_warned, params=params,
                    latents_max_abs_diff_vs_slice=lat, wav_max_int16_diff_vs_slice=int(wav.max()))

    remove = instrument(ts)
    by_path["snapshot"] = counted("snapshot", single(ts), wav_len(frames), extra=snapshot_fields)
    remove()
    lat_diff = (first_latents["snapshot"] - first_latents["serve"]).abs().max().item()
    if lat_diff != 0 or not tokenizer_warned:
        raise AssertionError(f"snapshot path: latents {lat_diff} from the slice's at the same "
                             f"seed (must be 0); tokenizer warning {tokenizer_warned}")
    del ts, remove  # the instruments' closures hold the pipeline
    torch.cuda.empty_cache()
    cli = cli_phase(os.path.join(snap_root, "cli"), snap_dir, wav_len(frames))
    torch.cuda.empty_cache()
    log("snapshot_cli", **cli, phase_s=round(time.perf_counter() - t_phase, 3),
        total_s=round(time.perf_counter() - t_start, 3))

    # ---- the entry points on the same snapshot, each counted: the HTTP
    # server, the SFT training CLI, the DPO training CLI
    t_phase = time.perf_counter()
    by_path["serve_http"] = serve_http_phase(snap_dir, counted, instrument, wav_len(frames))
    start = {k: v.detach().to("cpu", torch.float32) for k, v in tango.model.unet.state_dict().items()}
    manifest = write_wavs(os.path.join(snap_root, "data"), TRAIN_WAVS, 10.24, seed=0)
    with open(manifest) as f:
        rows = f.readlines()
    with open(os.path.join(snap_root, "data", "val.json"), "w") as f:
        f.writelines(rows[:TRAIN_BATCH])
    for path, phase in (("train_cli", train_cli_phase), ("dpo", dpo_phase)):
        (path_launches, path_shapes, tc_launches[path],
         cluster_launches[path]) = phase(snap_dir, snap_root, start, ops)
        by_path[path] = (path_launches, path_shapes)
    del start
    (path_launches, path_shapes, tc_launches["tango2_eval"],
     cluster_launches["tango2_eval"]) = tango2_eval_phase(snap_dir, snap_root, ops)
    by_path["tango2_eval"] = (path_launches, path_shapes)
    shutil.rmtree(snap_root)
    torch.cuda.empty_cache()
    log("entry_points", phase_s=round(time.perf_counter() - t_phase, 3),
        total_s=round(time.perf_counter() - t_start, 3))

    remove = instrument(tango)
    # one uncounted step at each new shape first: cuDNN's and cuBLAS's first use
    tango.generate("warm up", steps=1, duration=LONG_CLIP_S, seed=1)
    by_path["long_clip"] = counted("long_clip", single(tango, duration=LONG_CLIP_S),
                                   wav_len(long_t))
    tango.max_text_length = LONG_PROMPT_TOKENS
    tango.generate("warm up", steps=1, seed=1)
    by_path["long_prompt"] = counted("long_prompt", single(tango), wav_len(frames))
    tango.max_text_length = 128
    remove()

    # ---- the int8 W8A8 serving mode, on the same weights
    def quantized(scope, unet_params=None, cast_params=False):
        return Tango.from_components(
            unet_config=C.TANGO_UNET, vae_config=C.TANGO_VAE, t5_config=C.FLAN_T5_LARGE,
            hifigan_config=C.TANGO_HIFIGAN, scheduler_config=C.SD21_SCHEDULER, device=DEVICE,
            unet_params=tango.model.unet.state_dict() if unet_params is None else unet_params,
            vae_params=tango.vae.state_dict(), t5_params=tango.t5.state_dict(),
            hifigan_params=tango.vocoder.state_dict(), quant=scope, cast_params=cast_params)

    t0 = time.perf_counter()
    tq = quantized("all")
    tq.generate("warm up", steps=1, seed=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    def int8_fields(launches):
        ref, got = first_latents["serve"], first_latents["int8"]
        return dict(build_and_warmup_s=round(warm_s, 3),
                    w8a8_per_eval=launches["w8a8_matmul"] / STEPS,
                    rel_l2_vs_bf16=((got - ref).norm() / ref.norm()).item())

    remove = instrument(tq)
    by_path["int8"] = counted("int8", single(tq), wav_len(frames), extra=int8_fields)
    remove()
    tc = quantized("conv")
    remove = instrument(tc)
    conv_launches, _ = counted("int8_conv", single(tc, steps=2), wav_len(frames))
    remove()
    if conv_launches["w8a8_matmul"]:
        raise AssertionError(f"quant='conv' launched w8a8_matmul {conv_launches['w8a8_matmul']}"
                             " times")
    del tc, remove  # the instruments' closures hold the pipeline
    int8_order_phase(C, quantized)

    shapes = {n: set() for n in ops.all_kernels()}
    for _, path_shapes in by_path.values():
        for n, v in path_shapes.items():
            shapes[n] |= v

    # ---- launches in one UNet evaluation (CFG batch of one prompt), bf16 and
    # int8; the 3x3 stride-1 convolutions of the bf16 one, for winograd_conv3x3
    unet, m = tango.model.unet, tango.model
    lat = torch.randn(2, m.latent_t_size, m.latent_f_size, unet.cfg.in_channels, device=DEVICE)
    ctx = torch.randn(2, tango.max_text_length, unet.cfg.cross_attention_dim, device=DEVICE,
                      dtype=tango.dtype)
    mask = torch.ones(2, tango.max_text_length, dtype=torch.long, device=DEVICE)
    steps = torch.tensor([999, 999], device=DEVICE)

    def record(mod, inputs, _):
        x = inputs[0]
        if mod.stride == (1, 1) and mod.padding == (1, 1) and wino_supported(
                x.shape, mod.weight.shape, mod.stride):
            shapes["winograd_conv3x3"].add((tuple(x.shape), tuple(mod.weight.shape)))

    hooks = [mod.register_forward_hook(record) for mod in unet.modules()
             if isinstance(mod, torch.nn.Conv2d)]
    ops.reset_counters()
    with torch.inference_mode():
        unet(lat, steps, ctx, mask)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    per_eval = {n: fn.launches for n, fn in ops.KERNELS.items()}
    gemms = collections.Counter()  # (M, K, N) of the int8 evaluation's W8A8 GEMMs

    def record_gemm(mod, inputs, out):
        gemms[(math.prod(inputs[0].shape[:-1]), inputs[0].shape[-1], out.shape[-1])] += 1

    hooks = [mod.register_forward_hook(record_gemm) for mod in tq.model.unet.modules()
             if isinstance(mod, QLinear)]
    ops.reset_counters()
    with torch.inference_mode():
        tq.model.unet(lat, steps, ctx, mask)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    per_eval_int8 = {n: fn.launches for n, fn in ops.KERNELS.items()}
    w8a8_tc = ops.KERNELS["w8a8_matmul"].tc_launches
    n_qlinear = sum(isinstance(mod, QLinear) for mod in tq.model.unet.modules())
    # device time of one evaluation, bf16 and int8, and the int8 one's W8A8
    # kernels (quantize pass and GEMM)
    with torch.inference_mode():
        bf16_ms = device_ms(lambda: unet(lat, steps, ctx, mask), 3)
        int8_ms = device_ms(lambda: tq.model.unet(lat, steps, ctx, mask), 3)
    log("per_eval", launches=per_eval, group_norms=per_eval["gn_silu_fwd"] + per_eval["gn_stats"],
        int8_launches=per_eval_int8, int8_w8a8_tc_launches=w8a8_tc, quantized_linears=n_qlinear,
        conv3x3_shapes=len(shapes["winograd_conv3x3"]),
        device_ms_per_eval={"bf16": sum(bf16_ms.values()), "int8": sum(int8_ms.values()),
                            "int8_w8a8": sum(t for k, t in int8_ms.items()
                                             if "w8a8" in k or "quantize_rows" in k)},
        w8a8_gemms_per_eval=[[*g, c] for g, c in sorted(gemms.items())])
    if "w8a8_matmul" in PATH_KERNELS["int8"] and not (
            per_eval_int8["w8a8_matmul"] == w8a8_tc == n_qlinear):
        raise AssertionError(f"{per_eval_int8['w8a8_matmul']} w8a8_matmul launches ({w8a8_tc} on "
                             f"the tensor-core body) in one int8 UNet evaluation for {n_qlinear} "
                             "quantized Linear layers")
    del tango, tq, unet, m
    torch.cuda.empty_cache()

    # ---- the training path, counted
    (train_launches, train_shapes, tc_launches["train"],
     cluster_launches["train"]) = train_phase(C, ops)
    by_path["train"] = (train_launches, train_shapes)
    launches = {n: sum(p[0][n] for p in by_path.values()) for n in ops.all_kernels()}
    for n, v in by_path["train"][1].items():
        shapes[n] |= v

    t0 = time.perf_counter()
    cases = check_kernels(ops, shapes, train_shapes, detail)
    log("kernels", seconds=round(time.perf_counter() - t0, 3),
        total_s=round(time.perf_counter() - t_start, 3),
        **{n: {"err_f32": c.err["f32"], "err_bf16": c.err["bf16"], "ms": c.ms,
               "plain_ms": c.plain_ms, "library_ms": c.library_ms, "bound_ms": c.bound,
               "f32": c.f32, **c.notes, "shapes": len(shapes[n])} for n, c in cases.items()})

    print(smi, flush=True)
    kernels = ops.all_kernels()
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": kernels[n].source,
         "replaces": kernels[n].replaces, "launches": launches[n],
         "launches_by_path": {p: v[0][n] for p, v in by_path.items()},
         "max_abs_err": max(c.err.values()), "ms": c.ms, "plain_ms": c.plain_ms,
         "bound_ms": c.bound, "bound_by": c.bound_by, "library_ms": c.library_ms,
         **tc_fields(kernels[n], {p: tc_launches.get(p, {}) for p in by_path},
                     {p: cluster_launches.get(p, {}) for p in by_path})}
        for n, c in cases.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
