"""Ops of the port: hand-written CUDA kernels with their plain PyTorch versions.

Every kernel wrapper is registered by name: the forward kernels (serving and
training) in `KERNELS`, the backward kernels (training only) in
`BACKWARD_KERNELS`; `all_kernels()` gives both. A wrapper runs its kernel
for a CUDA tensor and its plain version for a CPU tensor, and counts its
launches in `wrapper.launches` (a plain integer). The wrappers with a
tensor-core body (`attn_fwd`, `attn_fwd_v2`, `attn_fwd_bias`, `attn_bwd_dq`,
`attn_bwd_dkv`, `w8a8_matmul`, `winograd_conv3x3`) also count the launches that took it in
`wrapper.tc_launches`, from what the C entry point reports (`reported_tc`,
`count_tc`); `gn_silu_fwd`, `gn_silu_bwd` and `gn_bwd_stats` count their
thread-block-cluster launches in `wrapper.cluster_launches` the same way, and
`gn_bwd_apply` the launches of its flat body in `wrapper.flat_launches`
(`count_cluster`).
"""

from tango_tpu_torch.ops import _build

KERNELS: dict = {}
BACKWARD_KERNELS: dict = {}
TC_LAUNCHED = -1  # a C entry point's return after a tensor-core launch (tt::kTcLaunched)
CLUSTER_LAUNCHED = -2  # ... after a thread-block-cluster launch (tt::kClusterLaunched)
FLAT_LAUNCHED = -3  # ... after a launch of gn_bwd_apply's flat body (tt::kFlatLaunched)


def kernel_wrapper(source: str, replaces: str, backward: bool = False):
    """Register a kernel wrapper and give it a launch counter.

    `source` is the CUDA file in the repository, `replaces` the file:line of
    the Pallas kernel body it ports. `shapes` collects the argument shapes the
    wrapper launched the kernel on, so a caller can re-check the kernel at the
    shapes a run actually used."""

    def deco(fn):
        fn.launches = 0
        fn.shapes = set()
        fn.source = source
        fn.replaces = replaces
        (BACKWARD_KERNELS if backward else KERNELS)[fn.__name__] = fn
        return fn

    return deco


def all_kernels() -> dict:
    return {**KERNELS, **BACKWARD_KERNELS}


def reset_counters() -> None:
    for fn in all_kernels().values():
        fn.launches = 0
        fn.shapes.clear()
        for counter in ("tc_launches", "cluster_launches", "flat_launches"):
            if hasattr(fn, counter):
                setattr(fn, counter, 0)


def check_tc_aligned(name: str, *tensors) -> None:
    """Raise unless every tensor's data is 16-byte aligned, as a tensor-core
    body's 16-byte copies and stores need."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the tensor-core body needs 16-byte aligned inputs and "
                         f"outputs (offsets mod 16: {[t.data_ptr() % 16 for t in tensors]})")


def reported_tc(lib, code: int, name: str) -> bool:
    """Raise if a C entry point returned a CUDA error; True where it reports a
    tensor-core launch."""
    tc = code == TC_LAUNCHED
    _build.check(lib, 0 if tc else code, name)
    return tc


def count_tc(fn, rule: bool, ran: bool) -> None:
    """Count in fn.tc_launches a launch the C entry point reported as a
    tensor-core one (ran); raise where that report disagrees with the rule
    the wrapper prepared the launch by."""
    if ran != rule:
        raise RuntimeError(f"{fn.__name__}: the entry point launched the "
                           f"{'tensor' if ran else 'CUDA'}-core body against the wrapper's rule")
    fn.tc_launches += ran


def count_cluster(fn, rule: bool, ran: bool, body: str = "cluster") -> None:
    """Count in fn.<body>_launches a launch the C entry point reported as
    one of that body (ran: its return was CLUSTER_LAUNCHED for a
    thread-block-cluster body, FLAT_LAUNCHED for gn_bwd_apply's flat one);
    raise where that report disagrees with the rule the wrapper prepared the
    launch by."""
    if ran != rule:
        raise RuntimeError(f"{fn.__name__}: the entry point launched the "
                           f"{body if ran else 'streaming'} body against the wrapper's rule")
    setattr(fn, f"{body}_launches", getattr(fn, f"{body}_launches") + ran)
