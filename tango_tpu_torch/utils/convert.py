"""JAX parameter trees -> the port's state dicts.

`from_jax_params` takes a Flax parameter tree of numpy arrays (what
`jax.device_get` returns) for the UNet, the T5 encoder, the VAE or HiFi-GAN
and returns a state dict for the matching module of this package. The port's
modules carry the Flax module names, so a path maps onto a key; what changes
is the leaf name and the layout:

  Dense kernel (I, O)              -> Linear weight (O, I)
  Conv kernel (kh, kw, I, O)       -> Conv2d weight (O, I, kh, kw)
  Conv kernel (k, I, O)            -> Conv1d weight (O, I, k)
  ConvTranspose kernel (k, I, O)   -> ConvTranspose1d weight (I, O, k), with
                                      the spatial flip the JAX converter applied
                                      (tango_tpu/utils/convert.py:75) undone
  int8 kernel_q (as kernel)        -> int8 weight, the same layout change
  int8 kernel_scale (O,)           -> weight_scale (f32)
  LayerNorm scale                  -> weight
  GroupNorm `<name>_scale/_bias`   -> `<name>.weight/.bias`
  embedding tables                 -> `<name>.weight`

Fused projections stay fused: the port's attention modules hold `to_qkv`
(self-attention) and `to_kv` (cross-attention) as the JAX modules do.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch

# top-level parameters that are embedding tables (no `kernel` leaf)
_EMBEDDINGS = ("token_embedding", "relative_attention_bias")


def _flatten(tree: Mapping, prefix=()) -> Iterable[tuple[tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert_leaf(path: tuple[str, ...], w: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    if not mods and leaf in _EMBEDDINGS:
        return f"{leaf}.weight", w
    if leaf == "kernel_scale":
        return ".".join(mods + ["weight_scale"]), w
    if leaf in ("kernel", "kernel_q"):
        if w.ndim == 4:
            w = np.transpose(w, (3, 2, 0, 1))
        elif w.ndim == 3 and mods[-1].startswith("ups_"):
            w = np.transpose(w[::-1], (1, 2, 0))
        elif w.ndim == 3:
            w = np.transpose(w, (2, 1, 0))
        elif w.ndim == 2:
            w = w.T
        else:
            raise ValueError(f"unhandled kernel {'/'.join(path)} {w.shape}")
        return ".".join(mods + ["weight"]), w
    if leaf in ("scale", "weight"):
        return ".".join(mods + ["weight"]), w
    if leaf == "bias":
        return ".".join(mods + ["bias"]), w
    for suffix, name in (("_scale", "weight"), ("_bias", "bias")):
        if leaf.endswith(suffix):
            return ".".join(mods + [leaf[: -len(suffix)], name]), w
    raise ValueError(f"unhandled parameter {'/'.join(path)}")


def from_jax_params(params: Mapping, skip: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """Flax parameter tree -> state dict of f32 CPU tensors (int8 for the
    `kernel_q` leaves of a tree from `quantize_tree`).

    `skip` lists top-level subtrees the target module does not have: for the
    VAE's decode side alone, "encoder" and "quant_conv"; a VAE built with
    `with_encoder=True` takes the whole tree. Load the result with
    `module.load_state_dict(sd)`, whose strict key check catches a mismatch.
    A gradient tree converts the same way as its parameters."""
    skip = set(skip)
    out = {}
    for path, w in _flatten(params):
        if path[0] in skip:
            continue
        key, w = _convert_leaf(path, w)
        dtype = np.int8 if path[-1] == "kernel_q" else np.float32
        out[key] = torch.from_numpy(np.array(w, dtype=dtype, order="C"))
    return out
