"""Ops of the port: hand-written CUDA kernels with their plain PyTorch versions.

Every kernel wrapper is registered by name: the forward kernels (serving and
training) in `KERNELS`, the backward kernels (training only) in
`BACKWARD_KERNELS`; `all_kernels()` gives both. A wrapper runs its kernel
for a CUDA tensor and its plain version for a CPU tensor, and counts its
launches in `wrapper.launches` (a plain integer). The attention wrappers
with a tensor-core body (`attn_fwd`, `attn_fwd_v2`, `attn_bwd_dq`,
`attn_bwd_dkv`) also count the launches that took it in
`wrapper.tc_launches`.
"""

KERNELS: dict = {}
BACKWARD_KERNELS: dict = {}


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
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = 0
