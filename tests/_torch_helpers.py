"""Shared pieces of the port's parity tests (tests/test_torch_*.py)."""

import types

import jax
import numpy as np
import torch

from tango_tpu_torch.ops import _build

EMBEDDINGS = ("token_embedding", "relative_attention_bias")


def random_jax_params(init_fn, seed: int):
    """A Flax parameter tree of numpy arrays shaped like `init_fn`'s.

    The shapes come from `jax.eval_shape` (a trace, no compile), the values
    from numpy: kernels normal with variance 1/fan_in, biases and norm
    offsets 0.1-scale noise, norm scales 1 + 0.1-scale noise, embedding
    tables standard normal. Nonzero biases and non-unit scales make a wrong
    parameter mapping show in the outputs."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(seed))

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in EMBEDDINGS:
            v = rng.randn(*s.shape)
        elif name == "kernel":
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "weight") or name.endswith("_scale"):
            v = 1.0 + 0.1 * rng.randn(*s.shape)
        elif name == "bias" or name.endswith("_bias"):
            v = 0.1 * rng.randn(*s.shape)
        else:
            raise ValueError(f"unexpected parameter {name}")
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def fake_kernel_library(monkeypatch, codes, args=None):
    """Run the kernel wrappers' launch path on the CPU: the kernel library
    becomes a recorder whose entry points return the next of `codes` (what a
    C entry point reports: `TC_LAUNCHED` for a tensor-core launch, 0 for a
    CUDA-core one, a positive CUDA error code), and the CUDA stream a stub.
    Returns the list of entry points called, in order; `args`, a list, also
    receives each call's arguments."""
    calls, codes = [], iter(codes)

    class Library:
        def __getattr__(self, name):
            def entry(*a):
                calls.append(name)
                if args is not None:
                    args.append(a)
                return next(codes)
            return entry

        @staticmethod
        def tt_error_string(code):
            return b"recorded error"

    monkeypatch.setattr(_build, "load", Library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls
