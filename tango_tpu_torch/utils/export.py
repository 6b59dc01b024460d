"""The port's state dicts -> reference names, port of tango_tpu/utils/export.py.

The inverse of `utils.convert` for the `pytorch_model_main.bin` layout (the
UNet under `unet.`, the T5 encoder under `text_encoder.`) and Mustango's
`ldm/pytorch_model_ldm.bin` (the same and the music conditioner's flat
keys): a UNet trained with the port writes back into a reference-format
snapshot, which the reference's own code and this package's loader read. The
contract is `export(convert(sd)) == sd`, bit for bit and key for key, the
T5's `encoder.embed_tokens` alias included. Values are f32 CPU tensors.

  `down_blocks_0.` / `resnets_1.` / ...   -> `down_blocks.0.` / `resnets.1.`
  `attentions_0_extra1.` / `_extra2.`     -> `attentions2.0.` / `attentions3.0.`
  attn1 to_qkv                            -> to_q | to_k | to_v (equal thirds)
  attn2 to_kv                             -> to_k | to_v (equal halves)

`export_deberta_beats` and `export_t5_seq2seq` invert the Mustango
predictors' converters (models/deberta.py, models/t5.py), for writing a
snapshot's `beats/` and `chords/` checkpoints; the JAX package has no
counterpart.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch

StateDict = Dict[str, torch.Tensor]

_INDEXED = re.compile(
    r"\b(down_blocks|up_blocks|resnets|transformer_blocks|downsamplers|upsamplers|attentions)"
    r"_(\d+)\.")
_STREAMS = re.compile(r"\battentions_(\d+)_extra([12])\.")


def _f32(w: torch.Tensor) -> torch.Tensor:
    return w.detach().to("cpu", torch.float32).contiguous()


def export_unet(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """The port's UNet state dict -> diffusers UNet2DConditionModel's (or
    Mustango's music UNet's)."""
    out = {}
    for key, w in state_dict.items():
        if key.rsplit(".", 1)[-1] not in ("weight", "bias"):
            # an int8 UNet's weight_scale: the reference has no int8 layout
            raise ValueError(f"unhandled UNet key {key}")
        k = _STREAMS.sub(lambda m: f"attentions{int(m[2]) + 1}.{m[1]}.", key)
        k = _INDEXED.sub(r"\1.\2.", k)
        k = (k.replace("to_out_0.", "to_out.0.").replace("ff.net_0_proj.", "ff.net.0.proj.")
             .replace("ff.net_2.", "ff.net.2."))
        for fused, names in (("to_qkv.weight", "qkv"), ("to_kv.weight", "kv")):
            if k.endswith(fused):
                pre = k[: -len(fused)]
                for name, part in zip(names, torch.chunk(w, len(names))):
                    out[pre + f"to_{name}.weight"] = _f32(part)
                break
        else:
            out[k] = _f32(w)
    return out


def export_t5_encoder(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """The port's T5Encoder state dict -> HF T5EncoderModel's, with the
    `encoder.embed_tokens` alias HF writes beside `shared` (one tensor)."""
    emb = _f32(state_dict["token_embedding.weight"])
    out = {
        "shared.weight": emb,
        "encoder.embed_tokens.weight": emb,
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
            _f32(state_dict["relative_attention_bias.weight"]),
        "encoder.final_layer_norm.weight": _f32(state_dict["final_layer_norm.weight"]),
    }
    i = 0
    while f"block_{i}.attn.q.weight" in state_dict:
        pre, blk = f"encoder.block.{i}.layer.", f"block_{i}."
        out[pre + "0.layer_norm.weight"] = _f32(state_dict[blk + "ln_attn.weight"])
        out[pre + "1.layer_norm.weight"] = _f32(state_dict[blk + "ln_ff.weight"])
        for name in "qkvo":
            out[pre + f"0.SelfAttention.{name}.weight"] = _f32(state_dict[blk + f"attn.{name}.weight"])
        for name in ("wi", "wi_0", "wi_1", "wo"):
            if blk + f"ff.{name}.weight" in state_dict:
                out[pre + f"1.DenseReluDense.{name}.weight"] = _f32(
                    state_dict[blk + f"ff.{name}.weight"])
        i += 1
    return out


def export_main_state_dict(unet_params: Mapping[str, torch.Tensor],
                           t5_params: Optional[Mapping[str, torch.Tensor]] = None) -> StateDict:
    """The pytorch_model_main.bin key set: `unet.*`, and `text_encoder.*`
    when the T5 encoder's state dict is given."""
    sd = {f"unet.{k}": v for k, v in export_unet(unet_params).items()}
    if t5_params is not None:
        sd.update({f"text_encoder.{k}": v for k, v in export_t5_encoder(t5_params).items()})
    return sd


def save_main_bin(path: str, unet_params: Mapping[str, torch.Tensor],
                  t5_params: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """torch.save the exported main state dict to `path`."""
    torch.save(export_main_state_dict(unet_params, t5_params), path)


def export_music_conditioner(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """The port's MusicConditioner state dict -> the ldm bin's music keys."""
    return {
        "FME.translation_bias": _f32(state_dict["fme_translation_bias"]),
        **{f"{layer}.{ffn}.{leaf}": _f32(state_dict[f"{ffn}.{leaf}"])
           for layer, ffn in (("beat_embedding_layer", "beat_ffn"),
                              ("chord_embedding_layer", "chord_ffn"))
           for leaf in ("weight", "bias")},
    }


def export_ldm_state_dict(unet_params: Mapping[str, torch.Tensor],
                          t5_params: Optional[Mapping[str, torch.Tensor]] = None,
                          conditioner_params: Optional[Mapping[str, torch.Tensor]] = None
                          ) -> StateDict:
    """Mustango's ldm/pytorch_model_ldm.bin key set: `unet.*`,
    `text_encoder.*` and the music keys, each when given (the inverse of
    pipeline_music.convert_mustango_ldm)."""
    sd = export_main_state_dict(unet_params, t5_params)
    if conditioner_params is not None:
        sd.update(export_music_conditioner(conditioner_params))
    return sd


def save_ldm_bin(path: str, unet_params: Mapping[str, torch.Tensor],
                 t5_params: Optional[Mapping[str, torch.Tensor]] = None,
                 conditioner_params: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """torch.save the exported ldm state dict to `path`."""
    torch.save(export_ldm_state_dict(unet_params, t5_params, conditioner_params), path)


_DEBERTA_RULES = (
    (re.compile(r"^word_embeddings\."), "deberta.embeddings.word_embeddings."),
    (re.compile(r"^emb_ln\."), "deberta.embeddings.LayerNorm."),
    (re.compile(r"^rel_embeddings\."), "deberta.encoder.rel_embeddings."),
    (re.compile(r"^rel_ln\."), "deberta.encoder.LayerNorm."),
    (re.compile(r"^layer_(\d+)\.self\."), r"deberta.encoder.layer.\1.attention.self."),
    (re.compile(r"^layer_(\d+)\.attn_out_dense\."),
     r"deberta.encoder.layer.\1.attention.output.dense."),
    (re.compile(r"^layer_(\d+)\.attn_out_ln\."),
     r"deberta.encoder.layer.\1.attention.output.LayerNorm."),
    (re.compile(r"^layer_(\d+)\.intermediate_dense\."),
     r"deberta.encoder.layer.\1.intermediate.dense."),
    (re.compile(r"^layer_(\d+)\.output_dense\."), r"deberta.encoder.layer.\1.output.dense."),
    (re.compile(r"^layer_(\d+)\.output_ln\."), r"deberta.encoder.layer.\1.output.LayerNorm."),
)


def export_deberta_beats(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """The port's DebertaV2ForBeats state dict -> the reference's
    DebertaV2ForTokenClassificationRegression names (the head's keep theirs)."""
    out = {}
    for key, w in state_dict.items():
        k = key
        for rx, rep in _DEBERTA_RULES:
            k, n = rx.subn(rep, k)
            if n:
                break
        out[k] = _f32(w)
    return out


def export_t5_seq2seq(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """The port's T5Seq2Seq state dict -> HF T5ForConditionalGeneration's,
    `shared` once (the encoder's embedding) with HF's `encoder.embed_tokens`
    and `decoder.embed_tokens` aliases."""
    enc = export_t5_encoder({k[len("encoder."):]: v for k, v in state_dict.items()
                             if k.startswith("encoder.")})
    dec = {k[len("decoder."):]: v for k, v in state_dict.items() if k.startswith("decoder.")}
    out = dict(enc)
    out["decoder.embed_tokens.weight"] = enc["shared.weight"]
    out["decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = _f32(
        dec["relative_attention_bias.weight"])
    out["decoder.final_layer_norm.weight"] = _f32(dec["final_layer_norm.weight"])
    if "lm_head.weight" in dec:
        out["lm_head.weight"] = _f32(dec["lm_head.weight"])
    i = 0
    while f"block_{i}.self_attn.q.weight" in dec:
        pre, blk = f"decoder.block.{i}.layer.", f"block_{i}."
        for j, ln in enumerate(("ln_self", "ln_cross", "ln_ff")):
            out[pre + f"{j}.layer_norm.weight"] = _f32(dec[blk + f"{ln}.weight"])
        for name in "qkvo":
            out[pre + f"0.SelfAttention.{name}.weight"] = _f32(
                dec[blk + f"self_attn.{name}.weight"])
            out[pre + f"1.EncDecAttention.{name}.weight"] = _f32(
                dec[blk + f"cross_attn.{name}.weight"])
        for name in ("wi", "wi_0", "wi_1", "wo"):
            if blk + f"ff.{name}.weight" in dec:
                out[pre + f"2.DenseReluDense.{name}.weight"] = _f32(dec[blk + f"ff.{name}.weight"])
        i += 1
    return out
