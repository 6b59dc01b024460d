"""Checkpoint I/O, port of tango_tpu/utils/checkpoint.py.

Reference snapshots (`load_tango_snapshot`, `load_main_weights`): a Tango
snapshot directory holds `main_config.json`, `vae_config.json`, optionally
`stft_config.json` and `unet_config.json`, `pytorch_model_main.bin` (the
UNet under `unet.`, the frozen T5 encoder under `text_encoder.`) and
`pytorch_model_vae.bin` (the VAE, with the HiFi-GAN vocoder under
`vocoder.`). They load into configs and state dicts of the port's modules,
through `utils.convert`. `load_audioldm_ckpt` reads the VAE (with its
encoder), the vocoder and the scale factor out of AudioLDM's monolithic
`.ckpt` (the FiLM UNet and CLAP in it load in `audioldm.pipeline`).

Native checkpoints (`save_native`, `load_native`): the JAX package's
directory layout, `<dir>/params` for the tensors and `<dir>/manifest.json`
for the optional manifest. The tensors go through `torch.save` of a state
dict (of CPU tensors), where JAX writes an orbax tree. A state dict made by
`utils.convert` and one saved here load into the same module.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Dict, Mapping, Optional

import torch

from tango_tpu_torch import configs as C
from tango_tpu_torch.models.t5 import convert_t5_encoder, t5_config_from_state_dict
from tango_tpu_torch.utils import convert as conv

SD21_NAME = "stabilityai/stable-diffusion-2-1"


def split_main_state_dict(sd: Mapping[str, torch.Tensor]):
    """pytorch_model_main.bin -> (unet state dict, text encoder state dict,
    leftovers). The schedulers' buffers are derived, not loaded."""
    unet, text, rest = {}, {}, {}
    for k, v in sd.items():
        if k.startswith("unet."):
            unet[k[len("unet."):]] = v
        elif k.startswith("text_encoder."):
            text[k[len("text_encoder."):]] = v
        elif not k.startswith(("noise_scheduler", "inference_scheduler")):
            rest[k] = v
    return unet, text, rest


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_main_weights(path: str) -> Dict[str, Any]:
    """Only `pytorch_model_main.bin` of a snapshot directory, the reference's
    --hf_model continue-training init -> {unet_params, t5_params (or None),
    t5_config (or None), unet_config (from the directory's unet_config.json,
    or None)}."""
    unet_sd, text_sd, _ = split_main_state_dict(
        conv.load_torch_bin(os.path.join(path, "pytorch_model_main.bin")))
    cfg_path = os.path.join(path, "unet_config.json")
    return {
        "unet_params": conv.convert_unet(unet_sd),
        "t5_params": convert_t5_encoder(text_sd) if text_sd else None,
        "t5_config": t5_config_from_state_dict(text_sd) if text_sd else None,
        "unet_config": (C.UNetConfig.from_dict(_read_json(cfg_path))
                        if os.path.exists(cfg_path) else None),
    }


def load_tango_snapshot(path: str, with_encoder: bool = False) -> Dict[str, Any]:
    """A reference-format Tango snapshot directory -> {vae_config,
    stft_config, main_config, scheduler_config, unet_config, vae_params,
    unet_params, t5_params (or None), t5_config (or None), hifigan_params
    (or None), hifigan_config (or None)}: configs of this package and state
    dicts of f32 CPU tensors for its modules. The VAE's are its decode side
    (the serving `AutoencoderKL`), and with `with_encoder` also its encoder
    and `quant_conv`, for `AutoencoderKL(vae_config, with_encoder=True)`: the
    trainers encode fbanks into latents."""
    main_raw = _read_json(os.path.join(path, "main_config.json"))
    stft_path = os.path.join(path, "stft_config.json")
    main_config = C.DiffusionConfig.from_dict(main_raw)

    unet_config = C.TANGO_UNET
    cfg_path = main_raw.get("unet_model_config_path")
    if cfg_path:
        for cand in (cfg_path, os.path.join(path, os.path.basename(cfg_path))):
            if os.path.exists(cand):
                unet_config = C.UNetConfig.from_dict(_read_json(cand))
                break

    vae_sd = conv.load_torch_bin(os.path.join(path, "pytorch_model_vae.bin"))
    voc_sd = {k[len("vocoder."):]: v for k, v in vae_sd.items() if k.startswith("vocoder.")}
    hifigan_params = hifigan_config = None
    if voc_sd:
        # the widths are in conv_pre's shape, (initial channels, mels, 7);
        # the upsample rates are not in the weights, and every release
        # uses HIFIGAN_16K_64's
        w = voc_sd.get("conv_pre.weight_v", voc_sd.get("conv_pre.weight"))
        hifigan_config = dataclasses.replace(
            C.TANGO_HIFIGAN, upsample_initial_channel=int(w.shape[0]), num_mels=int(w.shape[1]))
        hifigan_params = conv.convert_hifigan(voc_sd)
    vae_params = conv.convert_vae(vae_sd, with_encoder=with_encoder)
    del vae_sd, voc_sd

    unet_sd, text_sd, _ = split_main_state_dict(
        conv.load_torch_bin(os.path.join(path, "pytorch_model_main.bin")))

    # the reference fetches main_config's scheduler_name from the hub, SD-2.1
    # for every released Tango; a scheduler config shipped in the snapshot
    # comes first, and there is no download
    scheduler_config = C.SD21_SCHEDULER
    sched_path = os.path.join(path, "scheduler", "scheduler_config.json")
    if os.path.exists(sched_path):
        scheduler_config = C.SchedulerConfig.from_dict(_read_json(sched_path))
    elif main_config.scheduler_name != SD21_NAME:
        warnings.warn(
            f"snapshot names scheduler {main_config.scheduler_name!r} but ships no "
            "scheduler/scheduler_config.json; using the SD-2.1 coefficients",
            stacklevel=2)

    return {
        "vae_config": C.VAEConfig.from_dict(_read_json(os.path.join(path, "vae_config.json"))),
        "stft_config": C.StftConfig.from_dict(
            _read_json(stft_path) if os.path.exists(stft_path) else {}),
        "main_config": main_config,
        "scheduler_config": scheduler_config,
        "unet_config": unet_config,
        "vae_params": vae_params,
        "unet_params": conv.convert_unet(unet_sd),
        "t5_params": convert_t5_encoder(text_sd) if text_sd else None,
        "t5_config": t5_config_from_state_dict(text_sd) if text_sd else None,
        "hifigan_params": hifigan_params,
        "hifigan_config": hifigan_config,
    }


def load_audioldm_ckpt(path: str):
    """A monolithic audioldm-*-full `.ckpt` -> (the VAE's state dict, its
    encoder and quant_conv included; the folded HiFi-GAN state dict, or None
    where the file has no vocoder; scale_factor)."""
    vae_sd, scale = conv.split_audioldm_ckpt(conv.load_torch_bin(path))
    vocoder = {k[len("vocoder."):]: v for k, v in vae_sd.items() if k.startswith("vocoder.")}
    return (conv.convert_vae(vae_sd, with_encoder=True),
            conv.convert_hifigan(vocoder) if vocoder else None, scale)


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
