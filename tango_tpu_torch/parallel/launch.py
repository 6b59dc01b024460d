"""Start one process a rank on this host, as torchrun does, and stop them all.

    results = launch([sys.executable, "-m", "tango_tpu_torch.parallel.dryrun"], world=4)

Each rank gets torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR=127.0.0.1 and a free MASTER_PORT), or, with
`jax_vars=True`, JAX's (JAX_COORDINATOR, JAX_NUM_PROCESSES, JAX_PROCESS_ID),
which `parallel.mesh.init_distributed` reads alike. When a rank fails the
others are stopped at once (they would wait in a collective until their
process group's timeout), and at `timeout` seconds every rank still running
is killed.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import tempfile
import time
from typing import List, Optional


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int   # negative: ended by a signal (stopped after a failure, or the timeout)
    stdout: str
    stderr: str


def rank_env(rank: int, world: int, port: int, jax_vars: bool = False,
             base: Optional[dict] = None) -> dict:
    env = dict(os.environ if base is None else base)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        env.pop(k, None)
    if jax_vars:
        env.update(JAX_COORDINATOR=f"127.0.0.1:{port}", JAX_NUM_PROCESSES=str(world),
                   JAX_PROCESS_ID=str(rank))
    else:
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


def launch(cmd: List[str], world: int, timeout: float, env: Optional[dict] = None,
           cwd: Optional[str] = None, jax_vars: bool = False) -> List[RankResult]:
    """Run `cmd` as ranks 0..world-1 and wait for them; every process is
    ended before this returns."""
    port = free_port()
    procs, outs = [], []
    for r in range(world):
        out = tempfile.TemporaryFile("w+")
        err = tempfile.TemporaryFile("w+")
        procs.append(subprocess.Popen(cmd, env=rank_env(r, world, port, jax_vars, env),
                                      cwd=cwd, stdout=out, stderr=err, text=True))
        outs.append((out, err))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        out.seek(0)
        err.seek(0)
        results.append(RankResult(r, p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return results


def check(results: List[RankResult], what: str) -> None:
    """Raise, with the failing ranks' last output, unless every rank exited 0."""
    bad = [r for r in results if r.returncode != 0]
    if bad:
        raise RuntimeError(f"{what}: ranks failed: " + "; ".join(
            f"rank {r.rank} exit {r.returncode}: {r.stderr[-3000:]}" for r in bad))
