"""Checkpoint conversion CLI, port of tango_tpu/convert_cli.py.

Forward, a reference-format snapshot -> the port's native directory
(`utils.checkpoint.save_native`: the state dicts of the UNet, the VAE with
its encoder, the T5 encoder and the vocoder, under `unet.`, `vae.`, `t5.` and
`hifigan.`, Mustango's music conditioner under `conditioner.`, and a
manifest of the configs):

    python -m tango_tpu_torch.convert_cli tango <snapshot_dir> <out_dir>
    python -m tango_tpu_torch.convert_cli mustango <mustango_snapshot> <out_dir>
    python -m tango_tpu_torch.convert_cli audioldm <audioldm-s-full.ckpt> <out_dir>

(`audioldm`: the FiLM UNet under `unet.`, the VAE with its encoder under
`vae.`, the folded vocoder under `hifigan.`, and the manifest
{"kind": "audioldm", "scale_factor": s}.)

Reverse, a UNet trained with the port (a `save_native` directory such as
`SFTTrainer.fit`'s `best`, or `-` for the snapshot's own) -> the reference's
layout, bit-exact (tests/test_torch_convert_cli.py):

    python -m tango_tpu_torch.convert_cli export-main <snapshot_dir> <unet_ckpt|-> <out.bin>
    python -m tango_tpu_torch.convert_cli export-snapshot <snapshot_dir> <unet_ckpt|-> <out_dir>
    python -m tango_tpu_torch.convert_cli export-mustango <mustango_snap> <unet_ckpt|-> <out_dir>

`export-snapshot` copies the snapshot's VAE bin, configs and scheduler over
and writes a fresh main bin; `export-mustango` copies Mustango's `configs/`,
`vae/`, `stft/`, `beats/` and `chords/` over and writes a fresh
`ldm/pytorch_model_ldm.bin` (the music UNet, the T5 encoder and the music
conditioner). Everything runs on the host; nothing is downloaded.
"""

from __future__ import annotations

import os
import shutil
import sys

# every kind of the JAX CLI is ported
NOT_PORTED: dict = {}
# what export-snapshot copies from the source snapshot unchanged
SNAPSHOT_FILES = ("pytorch_model_vae.bin", "pytorch_model_stft.bin", "vae_config.json",
                  "stft_config.json", "main_config.json", "unet_config.json")
# what export-mustango copies from the source Mustango snapshot unchanged
MUSTANGO_DIRS = ("configs", "vae", "stft", "beats", "chords")


def _unet(loaded, ckpt: str):
    """The snapshot's UNet state dict (`loaded["unet_params"]`), or the
    native checkpoint's (`ckpt` not "-")."""
    from tango_tpu_torch.utils.checkpoint import load_native

    return loaded["unet_params"] if ckpt == "-" else load_native(ckpt)[0]


def main(argv=None):
    """Positional CLI: kind src dst [out]; see the module docstring."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if len(argv) < 3:
        raise SystemExit(__doc__)
    kind, src, dst = argv[0], argv[1], argv[2]
    if kind in NOT_PORTED:
        raise SystemExit(f"convert_cli {kind}: {NOT_PORTED[kind]} is not ported yet")

    from tango_tpu_torch.utils import checkpoint as ckpt_io
    from tango_tpu_torch.utils.export import save_main_bin

    if kind in ("tango", "mustango", "export-main", "export-snapshot",
                "export-mustango") and not os.path.isdir(src):
        raise FileNotFoundError(f"{src!r} is not a snapshot directory; the port downloads "
                                "nothing")
    if kind == "tango":
        loaded = ckpt_io.load_tango_snapshot(src, with_encoder=True)
        parts = {"unet": loaded["unet_params"], "vae": loaded["vae_params"],
                 "t5": loaded["t5_params"], "hifigan": loaded["hifigan_params"]}
        state = {f"{name}.{k}": v for name, sd in parts.items() if sd is not None
                 for k, v in sd.items()}
        manifest = {
            "kind": "tango",
            "unet_config": loaded["unet_config"].to_dict(),
            "vae_config": loaded["vae_config"].to_dict(),
            "stft_config": loaded["stft_config"].to_dict(),
            "main_config": loaded["main_config"].to_dict(),
        }
        ckpt_io.save_native(dst, state, manifest)
        print(f"converted {kind} checkpoint -> {dst}")
    elif kind == "mustango":
        from tango_tpu_torch.pipeline_music import load_mustango_snapshot

        loaded = load_mustango_snapshot(src, with_encoder=True)
        parts = {"unet": loaded["unet_params"], "t5": loaded["t5_params"],
                 "conditioner": loaded["conditioner_params"], "vae": loaded["vae_params"],
                 "hifigan": loaded["hifigan_params"]}
        state = {f"{name}.{k}": v for name, sd in parts.items() if sd is not None
                 for k, v in sd.items()}
        manifest = {"kind": "mustango", "unet_config": loaded["unet_config"].to_dict(),
                    "vae_config": loaded["vae_config"].to_dict()}
        ckpt_io.save_native(dst, state, manifest)
        print(f"converted {kind} checkpoint -> {dst}")
    elif kind == "audioldm":
        from tango_tpu_torch.models.audioldm_unet import convert_film_unet
        from tango_tpu_torch.utils.convert import load_torch_bin

        vae_params, hifigan_params, scale = ckpt_io.load_audioldm_ckpt(src)
        pre = "model.diffusion_model."
        unet_sd = {k[len(pre):]: v for k, v in load_torch_bin(src).items() if k.startswith(pre)}
        parts = {"unet": convert_film_unet(unet_sd) if unet_sd else None, "vae": vae_params,
                 "hifigan": hifigan_params}
        state = {f"{name}.{k}": v for name, sd in parts.items() if sd is not None
                 for k, v in sd.items()}
        ckpt_io.save_native(dst, state, {"kind": "audioldm", "scale_factor": scale})
        print(f"converted {kind} checkpoint -> {dst}")
    elif kind == "export-mustango":
        from tango_tpu_torch.pipeline_music import convert_mustango_ldm
        from tango_tpu_torch.utils.convert import load_torch_bin
        from tango_tpu_torch.utils.export import save_ldm_bin

        out_dir = argv[3]
        parts = convert_mustango_ldm(load_torch_bin(os.path.join(src, "ldm",
                                                                 "pytorch_model_ldm.bin")))
        os.makedirs(os.path.join(out_dir, "ldm"), exist_ok=True)
        for sub in MUSTANGO_DIRS:
            path = os.path.join(src, sub)
            if os.path.isdir(path):
                shutil.copytree(path, os.path.join(out_dir, sub), dirs_exist_ok=True)
        save_ldm_bin(os.path.join(out_dir, "ldm", "pytorch_model_ldm.bin"), _unet(parts, dst),
                     parts["t5_params"], parts["conditioner_params"])
        print(f"exported mustango snapshot -> {out_dir}")
    elif kind == "export-main":
        out_bin = argv[3]
        loaded = ckpt_io.load_tango_snapshot(src)
        save_main_bin(out_bin, _unet(loaded, dst), loaded["t5_params"])
        print(f"exported main bin -> {out_bin}")
    elif kind == "export-snapshot":
        out_dir = argv[3]
        os.makedirs(out_dir, exist_ok=True)
        loaded = ckpt_io.load_tango_snapshot(src)
        for name in SNAPSHOT_FILES:
            path = os.path.join(src, name)
            if os.path.exists(path):
                shutil.copy2(path, os.path.join(out_dir, name))
        # a shipped scheduler config comes before the SD-2.1 fallback: keep it
        sched_dir = os.path.join(src, "scheduler")
        if os.path.isdir(sched_dir):
            shutil.copytree(sched_dir, os.path.join(out_dir, "scheduler"), dirs_exist_ok=True)
        save_main_bin(os.path.join(out_dir, "pytorch_model_main.bin"), _unet(loaded, dst),
                      loaded["t5_params"])
        print(f"exported reference-format snapshot -> {out_dir}")
    else:
        raise SystemExit(f"unknown kind {kind}")


if __name__ == "__main__":
    main()
