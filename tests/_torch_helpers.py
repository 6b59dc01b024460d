"""Shared pieces of the port's parity tests (tests/test_torch_*.py)."""

import types

import jax
import numpy as np
import torch

from tango_tpu_torch.ops import _build

EMBEDDINGS = ("token_embedding", "relative_attention_bias", "word_embeddings",
              "position_embeddings", "token_type_embeddings", "relative_position_bias_table",
              "rel_embeddings", "lm_head")


def random_jax_params(init_fn, seed: int):
    """A Flax parameter tree of numpy arrays shaped like `init_fn`'s.

    The shapes come from `jax.eval_shape` (a trace, no compile), the values
    from numpy: kernels normal with variance 1/fan_in, biases and norm
    offsets 0.1-scale noise, norm scales 1 + 0.1-scale noise, embedding
    and relative-position tables standard normal, BatchNorm running means
    0.1-scale noise and variances in [0.5, 1.5]. Nonzero biases and non-unit scales make a wrong
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
        elif name == "bias" or name.endswith("_bias") or name == "mean":
            v = 0.1 * rng.randn(*s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
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


def write_tiny_clap(path):
    """A LAION-format CLAP `.pt` ({"state_dict": sd}) of the goldens' tiny
    towers (clap_text_tiny's RoBERTa and projection under text_branch. /
    text_projection., htsat_tiny's audio_branch. / audio_projection.), the
    audio side's keys under `module.` as a DDP-saved checkpoint has them.
    Returns the state dict without the prefix."""
    from tests.conftest import load_golden

    sd = {}
    for name in ("clap_text_tiny", "htsat_tiny"):
        g = load_golden(name)
        for k in g.files:
            if k.startswith("sd::"):
                key = k[4:]
                if name == "clap_text_tiny" and not key.startswith("text_projection."):
                    key = "text_branch." + key
                sd[key] = torch.from_numpy(np.array(g[k]))
    saved = {("module." + k if k.startswith("audio_") else k): v for k, v in sd.items()}
    torch.save({"state_dict": saved}, path)
    return sd


def tiny_clap_configs():
    """The goldens' tiny CLAP towers as the port's configs: tests/test_clap.py's
    TINY_ROBERTA and tests/test_htsat.py's TINY_HTSAT."""
    from tango_tpu_torch.models.clap import RobertaConfig
    from tango_tpu_torch.models.htsat import HTSATConfig
    from tests.test_clap import TINY_ROBERTA
    from tests.test_htsat import TINY_HTSAT

    return (RobertaConfig.from_dict(TINY_ROBERTA.to_dict()),
            HTSATConfig.from_dict({**TINY_HTSAT.to_dict(),
                                   "patch_stride": tuple(TINY_HTSAT.patch_stride)}))


def tiny_clap_geometry(monkeypatch):
    """Make `inference_tango2.load_clap` build the tiny towers in place of
    RoBERTa-base and HTSAT-tiny. Returns (text config, audio config)."""
    from tango_tpu_torch import inference_tango2

    text, audio = tiny_clap_configs()
    monkeypatch.setattr(inference_tango2, "ROBERTA_BASE", text)
    monkeypatch.setattr(inference_tango2, "HTSAT_TINY", audio)
    return text, audio


def write_extractor_ckpts(root):
    """Cnn14 (527 classes, as `{"model": sd}`) and VGGish checkpoints in the
    released formats under `root`, seeded as the eval_composition golden's
    (tests/test_eval_composition.py). Returns their paths."""
    import json
    import os

    from tests.conftest import GOLDEN
    from tests.test_eval_composition import _fill_sd_from_spec

    g = np.load(GOLDEN / "eval_composition.npz")
    cnn14, vggish = os.path.join(root, "cnn14.pth"), os.path.join(root, "vggish.pth")
    torch.save({"model": _fill_sd_from_spec(json.loads(str(g["cnn14_spec"])),
                                            int(g["cnn14_seed"]))}, cnn14)
    torch.save(_fill_sd_from_spec(json.loads(str(g["vgg_spec"])), int(g["vgg_seed"])), vggish)
    return cnn14, vggish
