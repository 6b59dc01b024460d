"""Native checkpoints, port of save_native / load_native in
tango_tpu/utils/checkpoint.py.

The same directory layout: `<dir>/params` holds the tensors and
`<dir>/manifest.json` the optional manifest. The tensors go through
`torch.save` of a state dict (of CPU tensors), where JAX writes an orbax
tree. A state dict made by `utils.convert.from_jax_params` and one saved
here load into the same module.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import torch


def save_native(path: str, state_dict: Mapping[str, torch.Tensor],
                manifest: Optional[dict] = None) -> None:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tensors = {k: v.detach().to("cpu") for k, v in state_dict.items()}
    tmp = os.path.join(path, "params.tmp")
    torch.save(tensors, tmp)
    os.replace(tmp, os.path.join(path, "params"))  # a reader never sees half a file
    if manifest is not None:
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)


def load_native(path: str, map_location="cpu"):
    """-> (state dict, manifest or None)."""
    path = os.path.abspath(path)
    state = torch.load(os.path.join(path, "params"), map_location=map_location,
                       weights_only=True)
    manifest = None
    mpath = os.path.join(path, "manifest.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    return state, manifest
