"""The port's state dicts -> reference names, port of tango_tpu/utils/export.py.

The inverse of `utils.convert` for the `pytorch_model_main.bin` layout (the
UNet under `unet.`, the T5 encoder under `text_encoder.`): a UNet trained
with the port writes back into a reference-format snapshot, which the
reference's own code and this package's loader read. The contract is
`export(convert(sd)) == sd`, bit for bit and key for key, the T5's
`encoder.embed_tokens` alias included. Values are f32 CPU tensors.

  `down_blocks_0.` / `resnets_1.` / ...   -> `down_blocks.0.` / `resnets.1.`
  attn1 to_qkv                            -> to_q | to_k | to_v (equal thirds)
  attn2 to_kv                             -> to_k | to_v (equal halves)

Mustango's ldm bin waits for its UNet streams (ROADMAP queue A #7).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch

StateDict = Dict[str, torch.Tensor]

_INDEXED = re.compile(
    r"\b(down_blocks|up_blocks|resnets|transformer_blocks|downsamplers|upsamplers|attentions)"
    r"_(\d+)\.")


def _f32(w: torch.Tensor) -> torch.Tensor:
    return w.detach().to("cpu", torch.float32).contiguous()


def export_unet(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """The port's UNet state dict -> diffusers UNet2DConditionModel's."""
    out = {}
    for key, w in state_dict.items():
        if key.rsplit(".", 1)[-1] not in ("weight", "bias"):
            # an int8 UNet's weight_scale: the reference has no int8 layout
            raise ValueError(f"unhandled UNet key {key}")
        k = _INDEXED.sub(r"\1.\2.", key)
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
