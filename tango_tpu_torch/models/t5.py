"""T5 encoder, port of T5Encoder in tango_tpu/models/t5.py.

RMS layer norm (f32), unscaled attention with one relative-position bias
table shared by every layer, gated-GELU (tanh) feed-forward. Logits and
softmax are f32 whatever the compute dtype.

`t5_config_from_state_dict` and `convert_t5_encoder` read an HF
T5EncoderModel state dict (a snapshot's `text_encoder.*`): the geometry from
the tensors' shapes, the weights under the port's names.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tango_tpu_torch.configs import T5Config


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128, bidirectional: bool = True) -> np.ndarray:
    """T5 relative position buckets (host side), `memory_pos - query_pos`."""
    ret = np.zeros_like(relative_position)
    if bidirectional:
        n = num_buckets // 2
        ret += (relative_position > 0).astype(np.int64) * n
        rp = np.abs(relative_position)
    else:
        n = num_buckets
        rp = -np.minimum(relative_position, 0)
    max_exact = n // 2
    is_small = rp < max_exact
    val_large = max_exact + (
        np.log(np.maximum(rp, 1) / max_exact) / np.log(max_distance / max_exact)
        * (n - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, n - 1)
    ret += np.where(is_small, rp, val_large)
    return ret


class T5LayerNorm(nn.Module):
    """RMS norm without bias or mean subtraction, f32 statistics."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.weight.float() * xf).to(x.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)

    def forward(self, x, position_bias, mask_bias):
        b, s, _ = x.shape

        def heads(t):
            return t.reshape(b, s, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + position_bias
        if mask_bias is not None:
            logits = logits + mask_bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, -1)
        return self.o(out)


class T5FeedForward(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.is_gated
        self.gelu = cfg.act.startswith("gelu")
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        if self.gated:
            g = self.wi_0(x)
            # HF "gelu" for T5 is gelu_new, the tanh approximation
            act = F.gelu(g, approximate="tanh") if self.gelu else F.relu(g)
            h = act * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.ln_attn = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.attn = T5Attention(cfg)
        self.ln_ff = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.ff = T5FeedForward(cfg)

    def forward(self, x, position_bias, mask_bias):
        x = x + self.attn(self.ln_attn(x), position_bias, mask_bias)
        return x + self.ff(self.ln_ff(x))


class T5Encoder(nn.Module):
    """input_ids (B, S), attention_mask (B, S) -> last hidden state (B, S, d_model)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                    cfg.num_heads)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", T5Block(cfg))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None):
        c = self.cfg
        x = self.token_embedding(input_ids)
        s = input_ids.shape[1]
        pos = np.arange(s)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           c.relative_attention_num_buckets,
                                           c.relative_attention_max_distance)
        buckets = torch.as_tensor(buckets, device=input_ids.device)
        position_bias = self.relative_attention_bias(buckets).permute(2, 0, 1)[None].float()
        mask_bias = None
        if attention_mask is not None:
            mask_bias = (1.0 - attention_mask.float())[:, None, None, :] * -1e9
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x, position_bias, mask_bias)
        return self.final_layer_norm(x)


def t5_config_from_state_dict(sd: Mapping[str, torch.Tensor]) -> T5Config:
    """The encoder's geometry from an HF T5 state dict's shapes, so
    FLAN-T5-Large, FLAN-T5-XL (Tango-XL) and test-sized encoders load with
    no hub lookup. `relative_attention_max_distance` is not in the shapes;
    every released T5 uses 128, the default."""
    vocab, d_model = sd["shared.weight"].shape
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.block."))
    attn = "encoder.block.0.layer.0.SelfAttention."
    buckets, heads = sd[attn + "relative_attention_bias.weight"].shape
    inner = sd[attn + "q.weight"].shape[0]
    gated = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in sd
    wi = "encoder.block.0.layer.1.DenseReluDense." + ("wi_0" if gated else "wi")
    return T5Config(vocab_size=int(vocab), d_model=int(d_model), d_kv=int(inner // heads),
                    d_ff=int(sd[wi + ".weight"].shape[0]), num_layers=n_layers,
                    num_heads=int(heads), relative_attention_num_buckets=int(buckets),
                    feed_forward_proj="gated-gelu" if gated else "relu")


def convert_t5_encoder(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF T5EncoderModel state dict -> the port's T5Encoder's. The
    `encoder.embed_tokens` alias of `shared` and any decoder keys are left
    out."""
    out = {
        "token_embedding.weight": sd["shared.weight"],
        "relative_attention_bias.weight":
            sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"],
        "final_layer_norm.weight": sd["encoder.final_layer_norm.weight"],
    }
    i = 0
    while f"encoder.block.{i}.layer.0.SelfAttention.q.weight" in sd:
        pre, blk = f"encoder.block.{i}.layer.", f"block_{i}."
        out[blk + "ln_attn.weight"] = sd[pre + "0.layer_norm.weight"]
        out[blk + "ln_ff.weight"] = sd[pre + "1.layer_norm.weight"]
        for name in "qkvo":
            out[blk + f"attn.{name}.weight"] = sd[pre + f"0.SelfAttention.{name}.weight"]
        for name in ("wi", "wi_0", "wi_1", "wo"):
            key = pre + f"1.DenseReluDense.{name}.weight"
            if key in sd:
                out[blk + f"ff.{name}.weight"] = sd[key]
        i += 1
    return out
