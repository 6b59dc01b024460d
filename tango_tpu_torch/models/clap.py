"""CLAP: the RoBERTa text tower with its projection, and `Clap`, which
scores audio against text: port of tango_tpu/models/clap.py.

The text path is RobertaModel("roberta-base")'s pooler output ->
Linear(768, 512), ReLU, Linear(512, 512) -> L2-normalize (LAION-CLAP). RoBERTa:
position ids cumsum(mask) * mask + padding_idx (pad id 1), post-LayerNorm
blocks, exact-GELU FFN, learned positions, pooler tanh(Linear(x[:, 0])). The
attention is plain torch (matmul, softmax), as JAX's is einsum and softmax.

`Clap` pairs the text tower with HTSAT's (models/htsat.py) or PANN-14's
(models/pann.py) audio tower for the reference's uses: re-ranking a
prompt's candidates (`similarity`) and the CLAP score of Tango 2's
inference (`clap_score`: the mean cosine over (audio_i, prompt_i) pairs).
The towers are built from state dicts and run in f32, on the card unless
`device` names another; the audio is resampled on the host. The tokenizer is the caller's: JAX takes
RobertaTokenizer("roberta-base"), whose files this package does not load.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tango_tpu_torch.configs import _FromDict, resolve_device
from tango_tpu_torch.models.htsat import (
    HTSAT_TINY,
    ClapAudioEncoder,
    clap_logmel,
    convert_projection,
    l2_normalize,
)
from tango_tpu_torch.models.layers import frozen
from tango_tpu_torch.models.pann import ClapPannAudioEncoder, PANNAudioConfig, pann_logmel
from tango_tpu_torch.utils.convert import StateDict, f32_tensor


@dataclasses.dataclass(frozen=True)
class RobertaConfig(_FromDict):
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    projection_dim: int = 512


ROBERTA_BASE = RobertaConfig()


def roberta_position_ids(input_ids: torch.Tensor, pad_id: int = 1) -> torch.Tensor:
    mask = (input_ids != pad_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_id


class RobertaSelfAttention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        for name in ("query", "key", "value", "output_dense"):
            setattr(self, name, nn.Linear(cfg.hidden_size, cfg.hidden_size))

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        h = self.heads
        d = c // h
        q, k, v = (getattr(self, n)(x).reshape(b, s, h, d).transpose(1, 2)
                   for n in ("query", "key", "value"))
        logits = (q @ k.transpose(-2, -1)).float() * (d**-0.5) + mask_bias
        probs = logits.softmax(-1).to(x.dtype)
        return self.output_dense((probs @ v).transpose(1, 2).reshape(b, s, c))


class RobertaLayer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.attention = RobertaSelfAttention(cfg)
        self.attention_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.output_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        x = self.attention_ln(x + self.attention(x, mask_bias))
        return self.output_ln(x + self.output(F.gelu(self.intermediate(x))))


class ClapTextEncoder(nn.Module):
    """input_ids, attention_mask -> L2-normalized (B, projection_dim), or the
    last hidden states (B, S, hidden) with `return_hidden`."""

    def __init__(self, cfg: RobertaConfig = ROBERTA_BASE):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.embeddings_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layer_{i}", RobertaLayer(cfg))
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.proj_0 = nn.Linear(cfg.hidden_size, cfg.projection_dim)
        self.proj_2 = nn.Linear(cfg.projection_dim, cfg.projection_dim)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                return_hidden: bool = False) -> torch.Tensor:
        c = self.cfg
        pos_ids = roberta_position_ids(input_ids, c.pad_token_id)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos_ids)
             + self.token_type_embeddings.weight[0][None, None, :])
        x = self.embeddings_ln(x)
        mask_bias = ((1.0 - attention_mask.float())[:, None, None, :]
                     * torch.finfo(torch.float32).min)
        for i in range(c.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, mask_bias)
        if return_hidden:
            return x
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return l2_normalize(self.proj_2(F.relu(self.proj_0(pooled))))


def convert_clap_text(sd: Mapping, prefix: str = "") -> StateDict:
    """HF RobertaModel (+ CLAP's text_projection) state dict -> ClapTextEncoder's.

    Keys resolve as {prefix}text_branch.* / {prefix}text_projection.* (a
    whole CLAP checkpoint), or {prefix}* for a bare RobertaModel, whose
    projection is then absent."""
    tb = (f"{prefix}text_branch."
          if f"{prefix}text_branch.embeddings.word_embeddings.weight" in sd else prefix)
    out = {f"{n}.weight": f32_tensor(sd[f"{tb}embeddings.{n}.weight"])
           for n in ("word_embeddings", "position_embeddings", "token_type_embeddings")}

    def take(src, dst):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = f32_tensor(sd[f"{src}.{leaf}"])

    take(f"{tb}embeddings.LayerNorm", "embeddings_ln")
    i = 0
    while f"{tb}encoder.layer.{i}.attention.self.query.weight" in sd:
        le = f"{tb}encoder.layer.{i}."
        for src, dst in (("attention.self.query", "attention.query"),
                         ("attention.self.key", "attention.key"),
                         ("attention.self.value", "attention.value"),
                         ("attention.output.dense", "attention.output_dense"),
                         ("attention.output.LayerNorm", "attention_ln"),
                         ("intermediate.dense", "intermediate"),
                         ("output.dense", "output"), ("output.LayerNorm", "output_ln")):
            take(le + src, f"layer_{i}.{dst}")
        i += 1
    if f"{tb}pooler.dense.weight" in sd:
        take(f"{tb}pooler.dense", "pooler")
    if f"{prefix}text_projection.0.weight" in sd:
        out.update(convert_projection(sd, f"{prefix}text_projection"))
    return out


class ClapTextConditioner:
    """Prompts -> (B, projection_dim) normalized text embeddings (numpy)."""

    def __init__(self, params, tokenizer, cfg: RobertaConfig = ROBERTA_BASE,
                 max_length: int = 77, device=None):
        self.device = resolve_device(device)
        self.model = frozen(lambda: ClapTextEncoder(cfg), params, self.device)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.dim = cfg.projection_dim
        self._uncond = None

    def text_embed(self, prompts) -> np.ndarray:
        tok = self.tokenizer(list(prompts), padding="max_length", truncation=True,
                             max_length=self.max_length, return_tensors="np")
        ids, mask = (torch.as_tensor(np.asarray(tok[k]), dtype=torch.long, device=self.device)
                     for k in ("input_ids", "attention_mask"))
        with torch.inference_mode():
            return self.model(ids, mask).cpu().numpy()

    def unconditional_embed(self, batch: int) -> np.ndarray:
        if self._uncond is None:
            self._uncond = self.text_embed([""])
        return np.repeat(self._uncond, batch, axis=0)


class Clap:
    """Audio and text towers -> similarity scores (numpy in, numpy out)."""

    # the towers run in chunks of this many clips, the last padded by
    # repetition, as JAX runs one compiled shape
    audio_batch: int = 32

    def __init__(self, text_params, audio_params, tokenizer,
                 text_cfg: RobertaConfig = ROBERTA_BASE, audio_cfg=None, max_length: int = 77,
                 device=None):
        self.device = resolve_device(device)
        self.text = ClapTextConditioner(text_params, tokenizer, text_cfg, max_length, self.device)
        self.audio_cfg = cfg = audio_cfg or HTSAT_TINY
        if isinstance(cfg, PANNAudioConfig):
            # the PANN-14 tower (PANN-14.json)
            self.audio_model = frozen(lambda: ClapPannAudioEncoder(cfg), audio_params,
                                      self.device)
            self._logmel = lambda w: pann_logmel(w, cfg)
        else:
            self.audio_model = frozen(lambda: ClapAudioEncoder(cfg), audio_params, self.device)
            self._logmel = lambda w: clap_logmel(w, cfg)
        self.dim = cfg.joint_embed_dim

    def text_embed(self, prompts) -> np.ndarray:
        return self.text.text_embed(prompts)

    def unconditional_embed(self, batch: int) -> np.ndarray:
        return self.text.unconditional_embed(batch)

    def audio_embed(self, waveforms_16k: np.ndarray) -> np.ndarray:
        """(B, L) float waveforms at 16 kHz -> (B, D) normalized embeddings.

        Resamples to the tower's rate and fills each clip to `clip_samples`
        (10 s) as the reference's enable_fusion=False path does: a shorter
        clip is tiled whole int(clip / len) times and zero-padded
        (data_filling="repeatpad"), a longer one cut to its leading window
        (the reference crops at random)."""
        from tango_tpu_torch.audio.wav import resample_poly

        clip = self.audio_cfg.clip_samples
        n_in = len(waveforms_16k)
        out = np.zeros((n_in, clip), np.float32)
        for i, w in enumerate(np.asarray(waveforms_16k, np.float32)):
            w48 = resample_poly(w, 16000, self.audio_cfg.sample_rate)
            n = len(w48)
            if 0 < n < clip:
                tiled = np.tile(w48, int(clip / n))
                out[i, : len(tiled)] = tiled
            else:
                out[i] = w48[:clip]
        bs = self.audio_batch
        embs = []
        for k in range(0, n_in, bs):
            chunk = out[k: k + bs]
            pad = bs - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)], 0)
            with torch.inference_mode():
                mel = self._logmel(torch.from_numpy(chunk).to(self.device))
                e = self.audio_model(mel).cpu().numpy()
            embs.append(e if not pad else e[:-pad])
        return np.concatenate(embs, 0) if embs else np.zeros((0, self.dim), np.float32)

    def similarity(self, waveforms_16k, prompt: str) -> np.ndarray:
        """Cosine similarity of each waveform against one prompt."""
        return self.audio_embed(waveforms_16k) @ self.text_embed([prompt])[0]

    def clap_score(self, waveforms_16k, prompts) -> float:
        """Mean cosine over (waveform_i, prompt_i) pairs (tango2/inference.py:21-46)."""
        a = self.audio_embed(waveforms_16k)
        t = self.text_embed(list(prompts))
        return float(np.mean(np.sum(a * t, axis=-1)))
