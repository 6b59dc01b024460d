#!/usr/bin/env python3
"""Host time per gn_silu_fwd call: this checkout's port against another's.

    python3 scripts/gn_fwd_host_us.py OTHER_CHECKOUT [ROUNDS]

Imports the port of this checkout and of OTHER_CHECKOUT (e.g. the parent
commit unpacked with `git archive`) into one process, each with its own
kernel library (built in its checkout's build/ on first use), and times
ROUNDS (default 21) rounds of 1000 back-to-back bf16 calls of each one's
gn_silu_fwd at chip_smoke.py's HOST_US_SHAPE with chip_smoke.host_us (the
wall clock to the last call's end on the card), the two in turns, their
order swapped every round. One process's readings drift by several µs
against the next one's, so the comparison is the paired difference within
a round. Prints one JSON line: each checkout's median and the median and
quartiles of (this - other), in µs.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import HOST_US_SHAPE, host_us  # noqa: E402


def load_port(root: str):
    """gn_silu_fwd of the port under `root`, its library built or loaded.
    The package is imported afresh, so each checkout's modules (and kernel
    library) stay its own."""
    for name in [m for m in sys.modules if m.split(".")[0] == "tango_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from tango_tpu_torch.ops import _build, gn_silu
        _build.load()
    finally:
        sys.path.remove(root)
    return gn_silu.gn_silu_fwd


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("gn_fwd_host_us: no CUDA device", file=sys.stderr)
        return 2
    other_root = os.path.abspath(argv[0])
    rounds = int(argv[1]) if len(argv) > 1 else 21
    fns = {"this": load_port(ROOT), "other": load_port(other_root)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(HOST_US_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(HOST_US_SHAPE[1], generator=gen, device="cuda")
    b = torch.randn(HOST_US_SHAPE[1], generator=gen, device="cuda")
    us = {"this": [], "other": []}
    for r in range(rounds):
        for name in (("this", "other") if r % 2 else ("other", "this")):
            fn = fns[name]
            us[name].append(host_us(lambda: fn(x, g, b, 32, 1e-5, "silu")))
    diff = [a - o for a, o in zip(us["this"], us["other"])]
    q1, med, q3 = statistics.quantiles(diff, n=4)
    print(json.dumps({"other": other_root, "shape": HOST_US_SHAPE, "rounds": rounds,
                      "this_median_us": statistics.median(us["this"]),
                      "other_median_us": statistics.median(us["other"]),
                      "diff_median_us": med, "diff_q1_us": q1, "diff_q3_us": q3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
