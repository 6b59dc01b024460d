"""DeBERTa-v2/v3 encoder with Mustango's beat head, port of
tango_tpu/models/deberta.py.

Mustango's beat predictor is DeBERTa-v3-large with a token classification
and regression head: the max-beat class from token 0's logits and a beat
interval per token. Eval mode, no dropout:

  * embeddings: word embedding -> LayerNorm -> times the mask; no absolute
    positions (v3), no token types;
  * relative positions q_i - k_j, log-bucketed (`make_log_bucket_position`),
    a host-side table for the sequence length;
  * disentangled attention: content-to-content logits plus c2p (the query
    against the relative table's keys) and p2c (the key against its
    queries) gathered at the bucket of (i, j) with `torch.gather`, all scaled
    by 1 / sqrt(d * 3); the table goes through the layer's own k and q
    projections (`share_att_key`) after a LayerNorm;
  * XSoftmax: masked logits take f32's minimum and masked rows output zeros;
  * each layer: attention -> dense -> LayerNorm(x + .) -> exact-GELU FF ->
    dense -> LayerNorm(x + .);
  * head: logits = classifier(hidden1(h)), values = regressor(hidden2(h)).

The modules carry the JAX module names (`layer_{i}.self.query_proj`, ...) so
that `utils.convert.from_jax_params` maps a Flax tree onto them, and
`convert_deberta_beats` maps the reference's torch state dict. Plain PyTorch,
as this is XLA in JAX: no kernel. The predictor runs it in f32.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tango_tpu_torch.configs import DebertaConfig


def make_log_bucket_position(relative_pos: np.ndarray, bucket_size: int,
                             max_position: int) -> np.ndarray:
    """Log-bucketed relative positions, host side."""
    sign = np.sign(relative_pos)
    mid = bucket_size // 2
    abs_pos = np.where((relative_pos < mid) & (relative_pos > -mid), mid - 1,
                       np.abs(relative_pos)).astype(np.float64)
    log_pos = (np.ceil(np.log(abs_pos / mid) / np.log((max_position - 1) / mid) * (mid - 1))
               + mid)
    bucket_pos = np.where(abs_pos <= mid, relative_pos.astype(np.float64), log_pos * sign)
    return bucket_pos.astype(np.int64)


def build_relative_position(query_size: int, key_size: int, bucket_size: int,
                            max_position: int) -> np.ndarray:
    """(Sq, Sk) relative positions q_i - k_j, log-bucketed when both sizes are set."""
    rel = np.arange(query_size)[:, None] - np.arange(key_size)[None, :]
    if bucket_size > 0 and max_position > 0:
        rel = make_log_bucket_position(rel, bucket_size, max_position)
    return rel.astype(np.int64)


class Table(nn.Embedding):
    """An embedding table drawn N(0, 0.02) by `utils.init.init_random_`, as
    JAX's DeBERTa initializes its tables."""

    init_std = 0.02


class DisentangledSelfAttention(nn.Module):
    def __init__(self, cfg: DebertaConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query_proj = nn.Linear(h, h)
        self.key_proj = nn.Linear(h, h)
        self.value_proj = nn.Linear(h, h)
        if not cfg.share_att_key:
            self.pos_key_proj = nn.Linear(h, h)
            self.pos_query_proj = nn.Linear(h, h)

    def forward(self, x, mask_2d, rel_embeddings, rel_pos):
        """x (B, S, hidden); mask_2d (B, S, S) 0/1; rel_embeddings (2*span,
        hidden); rel_pos (S, S) long buckets."""
        c = self.cfg
        nh = c.num_attention_heads
        d = c.hidden_size // nh
        b, s, _ = x.shape
        span = c.position_buckets if c.position_buckets > 0 else c.max_position_embeddings

        def heads(t):  # (..., hidden) -> (..., H, D)
            return t.reshape(*t.shape[:-1], nh, d)

        q, k, v = heads(self.query_proj(x)), heads(self.key_proj(x)), heads(self.value_proj(x))
        scale = 1.0 / math.sqrt(d * (1 + len(c.pos_att_type)))
        qf, kf = q.float(), k.float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale

        rel = rel_embeddings.to(x.dtype)
        if c.share_att_key:
            pos_key, pos_query = heads(self.key_proj(rel)), heads(self.query_proj(rel))
        else:
            pos_key, pos_query = heads(self.pos_key_proj(rel)), heads(self.pos_query_proj(rel))
        if "c2p" in c.pos_att_type:
            c2p = torch.einsum("bqhd,khd->bhqk", qf, pos_key.float())  # (B, H, S, 2*span)
            idx = torch.clamp(rel_pos + span, 0, 2 * span - 1).expand(b, nh, s, s)
            logits = logits + torch.gather(c2p, -1, idx) * scale
        if "p2c" in c.pos_att_type:
            p2c = torch.einsum("bkhd,qhd->bhkq", kf, pos_query.float())
            idx = torch.clamp(-rel_pos + span, 0, 2 * span - 1).expand(b, nh, s, s)
            logits = logits + torch.gather(p2c, -1, idx).transpose(-1, -2) * scale

        # XSoftmax: f32's minimum at masked keys, zeros at masked rows
        m = mask_2d[:, None].bool()
        logits = torch.where(m, logits, torch.finfo(torch.float32).min)
        probs = torch.where(m, torch.softmax(logits, dim=-1), 0.0).to(x.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, c.hidden_size)


class DebertaLayer(nn.Module):
    def __init__(self, cfg: DebertaConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.add_module("self", DisentangledSelfAttention(cfg))
        self.attn_out_dense = nn.Linear(h, h)
        self.attn_out_ln = nn.LayerNorm(h, eps=eps)
        self.intermediate_dense = nn.Linear(h, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, h)
        self.output_ln = nn.LayerNorm(h, eps=eps)

    def forward(self, x, mask_2d, rel_embeddings, rel_pos):
        a = self._modules["self"](x, mask_2d, rel_embeddings, rel_pos)
        x = self.attn_out_ln(x + self.attn_out_dense(a))
        f = self.output_dense(F.gelu(self.intermediate_dense(x)))
        return self.output_ln(x + f)


class DebertaV2ForBeats(nn.Module):
    """DeBERTa encoder + Mustango's head: input_ids (B, S), attention_mask
    (B, S) -> (logits (B, S, num_labels), values (B, S, 1)). The caller takes
    logits[0, 0] for the max-beat class and values[0, :, 0] for the
    intervals."""

    def __init__(self, cfg: DebertaConfig):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        span = cfg.position_buckets if cfg.position_buckets > 0 else cfg.max_position_embeddings
        self.word_embeddings = Table(cfg.vocab_size, h)
        self.emb_ln = nn.LayerNorm(h, eps=eps)
        self.rel_embeddings = Table(2 * span, h)
        if "layer_norm" in cfg.norm_rel_ebd:
            self.rel_ln = nn.LayerNorm(h, eps=eps)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", DebertaLayer(cfg))
        self.hidden1 = nn.Linear(h, h)
        self.classifier = nn.Linear(h, cfg.num_labels)
        self.hidden2 = nn.Linear(h, h)
        self.regressor = nn.Linear(h, 1)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None):
        c = self.cfg
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.emb_ln(self.word_embeddings(input_ids))
        x = x * attention_mask[..., None].to(x.dtype)
        am = attention_mask.long()
        mask_2d = am[:, :, None] * am[:, None, :]
        rel_embeddings = self.rel_embeddings.weight
        if hasattr(self, "rel_ln"):
            rel_embeddings = F.layer_norm(rel_embeddings.float(), (c.hidden_size,),
                                          self.rel_ln.weight.float(), self.rel_ln.bias.float(),
                                          c.layer_norm_eps)
        rel_pos = torch.as_tensor(
            build_relative_position(s, s, c.position_buckets, c.max_position_embeddings),
            device=input_ids.device)
        for i in range(c.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, mask_2d, rel_embeddings, rel_pos)
        logits = self.classifier(self.hidden1(x))
        values = self.regressor(self.hidden2(x))
        return logits, values


def _pairs(prefix: str, module: str):
    return {f"{module}.weight": f"{prefix}.weight", f"{module}.bias": f"{prefix}.bias"}


def convert_deberta_beats(sd: Mapping[str, torch.Tensor]) -> dict:
    """The reference's DebertaV2ForTokenClassificationRegression state dict
    (microsoft-deberta-v3-large.pt) -> DebertaV2ForBeats's. Both are torch
    layouts: only the names change."""
    names = {"word_embeddings.weight": "deberta.embeddings.word_embeddings.weight",
             "rel_embeddings.weight": "deberta.encoder.rel_embeddings.weight",
             **_pairs("deberta.embeddings.LayerNorm", "emb_ln")}
    for head in ("hidden1", "classifier", "hidden2", "regressor"):
        names.update(_pairs(head, head))
    if "deberta.encoder.LayerNorm.weight" in sd:
        names.update(_pairs("deberta.encoder.LayerNorm", "rel_ln"))
    i = 0
    while f"deberta.encoder.layer.{i}.attention.self.query_proj.weight" in sd:
        pre, blk = f"deberta.encoder.layer.{i}.", f"layer_{i}."
        for proj in ("query_proj", "key_proj", "value_proj", "pos_key_proj", "pos_query_proj"):
            if f"{pre}attention.self.{proj}.weight" in sd:
                names.update(_pairs(f"{pre}attention.self.{proj}", f"{blk}self.{proj}"))
        for src, dst in (("attention.output.dense", "attn_out_dense"),
                         ("attention.output.LayerNorm", "attn_out_ln"),
                         ("intermediate.dense", "intermediate_dense"),
                         ("output.dense", "output_dense"), ("output.LayerNorm", "output_ln")):
            names.update(_pairs(pre + src, blk + dst))
        i += 1
    return {k: sd[v] for k, v in names.items()}
