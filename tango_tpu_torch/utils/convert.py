"""Reference state dicts and JAX parameter trees -> the port's state dicts.

Reference names (a snapshot's `.bin` files, the goldens' `sd::` keys): port
of tango_tpu/utils/convert.py. `load_torch_bin` reads a file into f32 CPU
tensors; `split_audioldm_ckpt` takes the VAE and its scale factor out of
AudioLDM's monolithic checkpoint; `convert_unet` (diffusers), `convert_vae` (AudioLDM) and
`convert_hifigan` (HiFi-GAN, weight-normed or folded) rename the keys onto
the port's modules. Both sides are torch layouts, so nothing is transposed;
what changes:

  `down_blocks.0.` / `resnets.1.` / ...   -> `down_blocks_0.` / `resnets_1.`
  `attentions2.N.` / `attentions3.N.`    -> `attentions_N_extra1.` / `_extra2.`
                                             (Mustango's beat and chord streams)
  attn1 to_q | to_k | to_v (O, I) each    -> to_qkv, concatenated on O
  attn2 to_k | to_v                       -> to_kv, concatenated on O
  `weight_g` / `weight_v` pairs           -> weight = g * v / ||v|| (dims != 0)
  `ups.N` transposed convs (I, O, k)      -> kept as they are

The tensors are the caller's where no key is fused or folded: a 4.8 GB main
`.bin` stays one f32 copy on the host while it converts.

`from_jax_params` takes a Flax parameter tree of numpy arrays (what
`jax.device_get` returns) for the UNet, the T5 encoder or decoder, the VAE,
HiFi-GAN, the CLAP towers, the evaluation's Cnn14 and VGGish, Mustango's
MusicConditioner or the DeBERTa beat predictor and returns a state dict for
the matching module of this package. The port's modules carry
the Flax module names, so a path maps onto a key; what changes is the leaf
name and the layout:

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
  embedding tables                 -> `<name>.weight` (T5's decoder `lm_head`
                                      and DeBERTa's `rel_embeddings` too)
  BatchNormEval mean / var         -> the buffers `mean` / `var`
  relative_position_bias_table     -> kept as it is (HTSAT's Swin blocks)
  fme_translation_bias             -> kept as it is (the MusicConditioner's)

Fused projections stay fused: the port's attention modules hold `to_qkv`
(self-attention) and `to_kv` (cross-attention) as the JAX modules do. The
one JAX tree with unfused self-attention projections, the FiLM UNet's
(`input_{i}_attn/attn1/to_q|to_k|to_v`, and attn2's alike), gets them
concatenated into `to_qkv`, the port's FilmUNet's.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# top-level parameters that are tables (no `kernel` leaf): T5's (and its
# decoder's untied head), RoBERTa's (the CLAP text tower), DeBERTa's
_EMBEDDINGS = ("token_embedding", "relative_attention_bias", "word_embeddings",
               "position_embeddings", "token_type_embeddings", "lm_head", "rel_embeddings")
# leaves whose name and layout are the port's own: BatchNormEval's running
# statistics, the Swin blocks' bias tables, the music conditioner's bias
_KEPT = ("mean", "var", "relative_position_bias_table", "fme_translation_bias")


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
    if leaf in _KEPT:
        return ".".join(mods + [leaf]), w
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


def f32_tensor(v) -> torch.Tensor:
    """A numpy array or tensor -> a new contiguous f32 CPU tensor."""
    return torch.from_numpy(np.array(v, dtype=np.float32, order="C"))


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
    for k in [k for k in out if k.endswith(".to_q.weight")]:
        pre = k[: -len("to_q.weight")]
        if pre + "to_k.weight" in out and pre + "to_v.weight" in out:
            out[pre + "to_qkv.weight"] = torch.cat([out.pop(pre + f"to_{n}.weight")
                                                    for n in "qkv"])
    return out


# ------------------------------------------------------------ reference names

def load_torch_bin(path: str) -> StateDict:
    """A reference `.bin` / `.ckpt` -> {key: f32 CPU tensor}, unwrapping a
    `state_dict` or `model` entry. Tensors are converted one at a time."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    elif isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        # released PANNs checkpoints wrap the flat state dict as {"model": sd}
        sd = sd["model"]
    out = {}
    for k in list(sd):
        v = sd.pop(k)
        out[k] = v.detach().float() if torch.is_tensor(v) else torch.tensor(v, dtype=torch.float32)
    return out


def split_audioldm_ckpt(sd: Mapping[str, torch.Tensor]):
    """A monolithic audioldm-*-full state dict -> (its VAE state dict, the
    `first_stage_model.` keys with the prefix taken off, the vocoder's
    `vocoder.*` among them; scale_factor as a float)."""
    scale = float(sd["scale_factor"])
    pre = "first_stage_model."
    return {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}, scale


def fold_weight_norm(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """Fold `weight_g` / `weight_v` pairs into `weight` = g * v / ||v||, the
    norm over every dimension but 0 (torch's `remove_weight_norm`). The
    norm is numpy's f32 sum, the reference converter's, so both give the
    same bits."""
    out = {}
    for k, v in sd.items():
        if k.endswith("weight_g"):
            base = k[: -len("weight_g")]
            g, wv = v.numpy(), sd[base + "weight_v"].numpy()
            norm = np.sqrt(np.sum(wv**2, axis=tuple(range(1, wv.ndim)), keepdims=True))
            out[base + "weight"] = torch.from_numpy((g * wv / norm).astype(np.float32))
        elif not k.endswith("weight_v"):
            out[k] = v
    return out


def _leaf(key: str, what: str) -> None:
    if key.rsplit(".", 1)[-1] not in ("weight", "bias"):
        raise ValueError(f"unhandled {what} key {key}")


_UNET_INDEXED = re.compile(
    r"\b(down_blocks|up_blocks|resnets|transformer_blocks|downsamplers|upsamplers|attentions)"
    r"\.(\d+)\.")
# Mustango's extra streams: `attentions2` beats, `attentions3` chords
_UNET_STREAMS = re.compile(r"\battentions([23])\.(\d+)\.")


def convert_unet(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """diffusers UNet2DConditionModel state dict (or Mustango's music UNet's)
    -> the port's UNet's."""
    out = {}
    for key, w in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        k = _UNET_STREAMS.sub(lambda m: f"attentions_{m[2]}_extra{int(m[1]) - 1}.", key)
        k = _UNET_INDEXED.sub(r"\1_\2.", k)
        k = (k.replace("to_out.0.", "to_out_0.").replace("ff.net.0.proj.", "ff.net_0_proj.")
             .replace("ff.net.2.", "ff.net_2."))
        blocks = re.findall(r"\btransformer_blocks_(\d+)\.", k)
        if blocks and blocks[0] != "0":
            # the UNet has one transformer block an attention: a deeper
            # checkpoint must not load with its extra blocks dropped
            raise ValueError(f"transformer_layers_per_block > 1 is not supported (key: {key})")
        _leaf(key, "UNet")
        out[k] = w
    for k in [k for k in out if k.endswith(".attn1.to_q.weight")]:
        pre = k[: -len("to_q.weight")]
        out[pre + "to_qkv.weight"] = torch.cat(
            [out.pop(pre + f"to_{n}.weight") for n in "qkv"])
    for k in [k for k in out if k.endswith(".attn2.to_k.weight")]:
        pre = k[: -len("to_k.weight")]
        out[pre + "to_kv.weight"] = torch.cat([out.pop(pre + f"to_{n}.weight") for n in "kv"])
    return out


_VAE_RULES = (
    (re.compile(r"\b(down|up)\.(\d+)\.(block|attn)\.(\d+)\."), r"\1_\2_\3_\4."),
    (re.compile(r"\bdown\.(\d+)\.downsample\."), r"down_\1_downsample."),
    (re.compile(r"\bup\.(\d+)\.upsample\."), r"up_\1_upsample."),
    (re.compile(r"\bmid\.(block_1|block_2|attn_1)\."), r"mid_\1."),
)


def convert_vae(sd: Mapping[str, torch.Tensor], with_encoder: bool = False) -> StateDict:
    """AudioLDM AutoencoderKL state dict -> the port's AutoencoderKL's.

    The vocoder bundled in the file (`vocoder.*`, see `convert_hifigan`) and
    the training loss (`loss.*`) stay out; so do `encoder.*` and
    `quant_conv.*` unless the VAE is built `with_encoder`."""
    skip = ("vocoder.", "loss.") + (() if with_encoder else ("encoder.", "quant_conv."))
    out = {}
    for key, w in sd.items():
        if key.startswith(skip) or key.endswith("num_batches_tracked"):
            continue
        _leaf(key, "VAE")
        k = key
        for rx, rep in _VAE_RULES:
            k = rx.sub(rep, k)
        out[k] = w
    return out


def convert_hifigan(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """HiFi-GAN generator state dict (weight-normed or folded, with or
    without a `generator.` prefix) -> the port's HiFiGANGenerator's. The
    transposed convs keep torch's (I, O, k) layout: the port runs them as
    `nn.ConvTranspose1d`."""
    sd = fold_weight_norm({re.sub(r"^generator\.", "", k): v for k, v in sd.items()})
    out = {}
    for key, w in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        _leaf(key, "HiFi-GAN")
        k = re.sub(r"\bups\.(\d+)\.", r"ups_\1.", key)
        k = re.sub(r"\bresblocks\.(\d+)\.convs([12])\.(\d+)\.", r"resblocks_\1.convs\2_\3.", k)
        out[k] = w
    return out
