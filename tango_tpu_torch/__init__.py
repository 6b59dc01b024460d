"""tango_tpu_torch — the PyTorch/CUDA port of tango_tpu for one NVIDIA H100.

The JAX package `tango_tpu` stays beside it as the reference; this package
imports torch, numpy and the standard library and nothing of JAX or of
`tango_tpu`. Entry points run on CUDA unless the caller passes
`device="cpu"`. The pipelines are `Tango` (text to audio, Tango 2 included)
and `Mustango` (text to music). The Pallas kernels are hand-written
CUDA kernels here (`csrc/`, built with nvcc on first use into `build/`), each
with a plain PyTorch version beside it (`ops/`).
"""

__version__ = "0.1.0"


def __getattr__(name):
    """`from tango_tpu_torch import Tango` (or `Mustango`) without importing
    the models on a bare `import tango_tpu_torch`."""
    if name == "Tango":
        from tango_tpu_torch.pipeline import Tango

        return Tango
    if name == "Mustango":
        from tango_tpu_torch.pipeline_music import Mustango

        return Mustango
    raise AttributeError(f"module 'tango_tpu_torch' has no attribute {name!r}")
