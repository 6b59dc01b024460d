"""Model registry: checkpoint metadata and cache paths, port of
tango_tpu/registry.py (the same names, URLs and paths, under
`TANGO_TPU_CACHE`, by default ~/.cache/tango_tpu).

`resolve(name)` returns a local path: a registered file already in the cache,
or one fetched from its URL with `urllib` (to `path + ".part"`, then renamed,
so an interrupted download never looks cached); a failure raises
`FileNotFoundError` with the URL, so that it can be fetched by hand. The
port has no hub client: a `*_snapshot` entry resolves only where `name` is a
local directory, and otherwise raises naming the repository id. A name the
registry does not know is returned as it is (a local path).
"""

from __future__ import annotations

import os
import urllib.request

CACHE_ROOT = os.environ.get(
    "TANGO_TPU_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "tango_tpu"))

REGISTRY = {
    # monolithic AudioLDM checkpoints (zenodo)
    "audioldm-s-full": {
        "kind": "audioldm_ckpt",
        "path": os.path.join(CACHE_ROOT, "audioldm-s-full.ckpt"),
        "url": "https://zenodo.org/record/7600541/files/audioldm-s-full?download=1",
    },
    "audioldm-l-full": {
        "kind": "audioldm_ckpt",
        "path": os.path.join(CACHE_ROOT, "audioldm-l-full.ckpt"),
        "url": "https://zenodo.org/record/7698295/files/audioldm-full-l.ckpt?download=1",
    },
    "audioldm-m-full": {
        "kind": "audioldm_ckpt",
        "path": os.path.join(CACHE_ROOT, "audioldm-m-full.ckpt"),
        # record 7813012, not 7698295
        "url": "https://zenodo.org/record/7813012/files/audioldm-m-full.ckpt?download=1",
    },
    "audioldm-s-full-v2": {
        "kind": "audioldm_ckpt",
        "path": os.path.join(CACHE_ROOT, "audioldm-s-full-v2.ckpt"),
        # the file is named full-s-v2 on zenodo
        "url": "https://zenodo.org/record/7698295/files/audioldm-full-s-v2.ckpt?download=1",
    },
    # snapshot repositories
    "declare-lab/tango": {"kind": "tango_snapshot"},
    "declare-lab/tango-full-ft-audiocaps": {"kind": "tango_snapshot"},
    "declare-lab/tango-full-ft-audio-music-caps": {"kind": "tango_snapshot"},
    "declare-lab/tango2": {"kind": "tango_snapshot"},
    "declare-lab/tango2-full": {"kind": "tango_snapshot"},
    "declare-lab/mustango": {"kind": "mustango_snapshot"},
    # the evaluation's feature extractors
    "cnn14-16k": {
        "kind": "torch_weights",
        "path": os.path.join(CACHE_ROOT, "Cnn14_16k_mAP=0.438.pth"),
        "url": "https://zenodo.org/record/3987831/files/Cnn14_16k_mAP%3D0.438.pth",
    },
    "vggish": {
        "kind": "torch_weights",
        "path": os.path.join(CACHE_ROOT, "vggish-10086976.pth"),
        "url": "https://github.com/harritaylor/torchvggish/releases/download/v0.1/"
               "vggish-10086976.pth",
    },
}


def get_metadata() -> dict:
    return REGISTRY


def resolve(name: str, download: bool = True) -> str:
    """A local path for registry entry `name`, downloaded if permitted."""
    meta = REGISTRY.get(name)
    if meta is None:
        return name
    path = meta.get("path")
    if path and os.path.exists(path):
        return path
    if meta["kind"].endswith("snapshot"):
        if os.path.isdir(name):
            return name
        raise FileNotFoundError(
            f"{name} is a snapshot repository; the port has no hub client and downloads "
            "no snapshot: fetch it by hand and pass its local directory")
    if not download:
        raise FileNotFoundError(f"{name} not cached at {path}")
    url = meta["url"]
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, path)
        return path
    except Exception as e:
        raise FileNotFoundError(
            f"Could not download {name}. Fetch it by hand:\n  {url}\n-> {path}") from e
