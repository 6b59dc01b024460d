#!/usr/bin/env python3
"""Mustango's chord search on one CUDA card: the graphed device loop, the
eager device loop and the host loop of `T5Seq2Seq.generate`, and with
--parent the parent tree's `generate`, in turns in one call.

    python3 scripts/beam_search_probe.py [--parent DIR] [--reps 2]

DIR holds another tree's `tango_tpu_torch` (`git archive <commit>
tango_tpu_torch | tar -x -C DIR`, under build/). Each turn is a process of
its own (parent, this tree, this tree, parent for --reps 2) that builds the
untied FLAN-T5-large seq2seq of chip_smoke.py's phase mustango from seeded
random f32 weights (q scaled by d_kv^-0.5, as HF initializes T5), tokenizes
one chord prompt (PROMPT, the word-hash tokenizer, padded to 512 as
MusicFeaturePredictor pads) and runs the predictor's search (5 beams,
min_length 8, max_length 128, early stopping): per loop the seconds of each
run (host clock around a synchronized call; the graphed loop's first run
includes its capture), the steps and host syncs, the tokens' digest, and
for the default loop the device time of one run by torch.profiler (the
kernels' own time, and its largest kernels), its share of the wall time and
the bytes floor of a step. Prints one JSON line a
turn, then a summary line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = ("Caption: an upbeat jazz piece with a walking bass line \\n Timestamps: "
          "0.5 , 1.0 , 1.5 , 2.0 , 2.5 , 3.0 , 3.5 , 4.0 \\n Max Beat: 4")
SEARCH = dict(num_beams=5, min_length=8, max_length=128, early_stopping=True)


def build(cfg, device: str, seed: int = 8):
    """The smoke's chord predictor: untied, seeded, q scaled by d_kv^-0.5."""
    from tango_tpu_torch.models.t5 import T5Attention, T5Seq2Seq
    from tango_tpu_torch.utils.init import init_random_

    cfg = dataclasses.replace(cfg, tie_word_embeddings=False)
    with torch.device("meta"):
        m = T5Seq2Seq(cfg)
    m = init_random_(m.to_empty(device=device), torch.Generator(device=device).manual_seed(seed))
    m = m.eval().requires_grad_(False)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, T5Attention):
                mod.q.weight.mul_(cfg.d_kv**-0.5)
    return m


def tokens(vocab: int, device: str):
    from tango_tpu_torch.tokenizer import WordHashTokenizer

    b = WordHashTokenizer(vocab)([PROMPT], max_length=512, padding="max_length",
                                 truncation=True, return_tensors="np")
    return (torch.as_tensor(b["input_ids"], dtype=torch.long, device=device),
            torch.as_tensor(b["attention_mask"], dtype=torch.long, device=device))


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def timed(call, device: str):
    sync(device)
    t0 = time.perf_counter()
    out = call()
    sync(device)
    return out, time.perf_counter() - t0


def device_time(call, device: str, top: int = 12) -> dict:
    """The kernels' own time of one call, by torch.profiler: the total ms
    and the `top` kernels by time (ms, launches). Only the device's own
    events count: an eager run's operators also carry their kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        sync(device)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    return {"ms": sum(e.self_device_time_total for e in rows) / 1e3,
            "top": [[e.key[:90], round(e.self_device_time_total / 1e3, 3), e.count]
                    for e in rows[:top]]}


def floor_ms_per_step(m) -> float:
    """Bytes a step must move over 3.35 TB/s: the decoder's weights (the
    embedding row aside), the cross K / V at batch 1 and the self caches at
    max_length, each read once."""
    c, L = m.cfg, SEARCH["max_length"]
    dec = sum(p.numel() * p.element_size() for n, p in m.decoder.named_parameters()
              if n != "token_embedding.weight")
    kv = 4 * c.num_layers * c.num_heads * c.d_kv * (2 * 512 + 2 * SEARCH["num_beams"] * L)
    return (dec + kv) / 3.35e12 * 1e3


def worker(tree: str, device: str = "cuda", cfg=None) -> dict:
    """One turn on `tree`'s package: each loop it has, timed."""
    from tango_tpu_torch import configs as C

    m = build(cfg or C.FLAN_T5_LARGE, device)
    ids, mask = tokens(m.cfg.vocab_size, device)
    runs = {}

    def record(name, call, n):
        for i in range(n):
            out, s = timed(call, device)
            stats = dict(getattr(m, "beam_stats", None) or {})
            r = runs.setdefault(name, {"s": [], **stats,
                                       "digest": hashlib.sha1(out.tobytes()).hexdigest()[:12],
                                       "len": int(out.size)})
            r["s"].append(round(s, 4))
            if r["digest"] != hashlib.sha1(out.tobytes()).hexdigest()[:12]:
                raise AssertionError(f"{name}: run {i} gave other tokens")

    with torch.inference_mode():
        default = lambda: m.generate(ids, mask, **SEARCH)  # noqa: E731
        record("default", default, 3)
        runs["default"]["device"] = dev = device_time(default, device)
        runs["default"]["device_share"] = dev["ms"] / 1e3 / min(runs["default"]["s"])
        runs["default"]["floor_ms_per_step"] = floor_ms_per_step(m)
        if hasattr(m, "device_beam_search"):
            pre = m.precompute(m.encode(ids, mask), mask, SEARCH["max_length"])
            full = dict(SEARCH, length_penalty=1.0, eos_token_id=1, pad_token_id=0,
                        decoder_start_token_id=0)
            record("eager_device", lambda: m.device_beam_search(*pre, graph=False, **full), 2)
            record("host", lambda: m.generate(ids, mask, device_loop=False, **SEARCH), 2)
    return {"tree": tree, "runs": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a directory holding the parent's tango_tpu_torch")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        sys.path.insert(0, args.worker)
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    trees = [REPO] if not args.parent else [os.path.abspath(args.parent), REPO]
    order = []
    for i in range(args.reps):
        order += trees if i % 2 == 0 else trees[::-1]
    turns = []
    for tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                             capture_output=True, text=True, timeout=900, cwd=tree)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    digests = {t["runs"]["default"]["digest"] for t in turns}
    print(json.dumps({"card": card.strip(), "turns": [t["tree"] for t in turns],
                      "same_tokens_every_turn": len(digests) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
