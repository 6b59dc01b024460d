"""T5, port of tango_tpu/models/t5.py: the encoder (Tango's and Mustango's
text conditioning) and the seq2seq with beam search (Mustango's chord
predictor, FLAN-T5-large).

RMS layer norm (f32), unscaled attention with one relative-position bias
table shared by every layer (bidirectional in the encoder, causal in the
decoder), gated-GELU (tanh) feed-forward. Logits and softmax are f32
whatever the compute dtype.

`T5Seq2Seq.generate` is HF's beam search (transformers 4.57's
BeamSearchScorer semantics) over a KV-cached decoder: one single-token step
per generated token, the cross-attention K/V projected once at batch 1 and
broadcast to the beams. The bookkeeping runs on the host in numpy, from one
host copy of each step's f32 log-probabilities, exactly as JAX's host loop
(tango_tpu/models/t5.py:648-740), which is pinned token for token to HF.

`t5_config_from_state_dict` and `convert_t5_encoder` read an HF
T5EncoderModel state dict (a snapshot's `text_encoder.*`): the geometry from
the tensors' shapes, the weights under the port's names;
`convert_t5_decoder` and `convert_t5_seq2seq` read a
T5ForConditionalGeneration's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tango_tpu_torch.configs import T5Config
from tango_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model, split_span


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
    """Under tensor parallelism (parallel.mesh.shard_params) a model rank
    keeps whole heads of q, k, v (their rows) and of o (its columns), and
    the relative-position bias is sliced to its heads; o's partial sums are
    all-reduced."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.head_span, self.tp_mesh = (0, cfg.num_heads), None

    def tp_layout(self, parts: int, index: int) -> dict:
        lo, hi = split_span(self.heads, parts, index)
        rows = torch.arange(lo * self.d_kv, hi * self.d_kv)
        return {"q.weight": (0, rows), "k.weight": (0, rows), "v.weight": (0, rows),
                "o.weight": (1, rows)}

    def enter_tp_(self, mesh, parts: int, index: int) -> None:
        self.head_span, self.tp_mesh = split_span(self.heads, parts, index), mesh

    def forward(self, x, position_bias, mask_bias, kv=None):
        """Self-attention when kv is None; cross-attention to kv otherwise."""
        b, s, _ = x.shape
        tp = self.tp_mesh
        if tp is not None:
            x = copy_to_model(x, tp)
            kv = None if kv is None else copy_to_model(kv, tp)
            if position_bias is not None:
                position_bias = position_bias[:, self.head_span[0]:self.head_span[1]]
        src = x if kv is None else kv
        n_heads = self.head_span[1] - self.head_span[0]

        def heads(t):
            return t.reshape(b, t.shape[1], n_heads, self.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(src)), heads(self.v(src))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if position_bias is not None:
            logits = logits + position_bias
        if mask_bias is not None:
            logits = logits + mask_bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, -1)
        return reduce_from_model(self.o(out), tp)


class T5FeedForward(nn.Module):
    """Under tensor parallelism a model rank keeps a span of the d_ff hidden
    units: the rows of wi (or wi_0 and wi_1) and the columns of wo."""

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
        self.tp_mesh = None

    def tp_layout(self, parts: int, index: int) -> dict:
        rows = torch.arange(*split_span(self.wo.in_features, parts, index))
        ins = ("wi_0", "wi_1") if self.gated else ("wi",)
        return {**{f"{n}.weight": (0, rows) for n in ins}, "wo.weight": (1, rows)}

    def enter_tp_(self, mesh, parts: int, index: int) -> None:
        self.tp_mesh = mesh

    def forward(self, x):
        x = copy_to_model(x, self.tp_mesh)
        if self.gated:
            g = self.wi_0(x)
            # HF "gelu" for T5 is gelu_new, the tanh approximation
            act = F.gelu(g, approximate="tanh") if self.gelu else F.relu(g)
            h = act * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return reduce_from_model(self.wo(h), self.tp_mesh)


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


class T5DecoderBlock(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln_self = T5LayerNorm(cfg.d_model, eps)
        self.self_attn = T5Attention(cfg)
        self.ln_cross = T5LayerNorm(cfg.d_model, eps)
        self.cross_attn = T5Attention(cfg)
        self.ln_ff = T5LayerNorm(cfg.d_model, eps)
        self.ff = T5FeedForward(cfg)

    def forward(self, x, self_bias, enc_hidden, enc_mask_bias):
        x = x + self.self_attn(self.ln_self(x), self_bias, None)
        x = x + self.cross_attn(self.ln_cross(x), None, enc_mask_bias, kv=enc_hidden)
        return x + self.ff(self.ln_ff(x))


def _decoder_bias_table(cfg: T5Config, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The decoder's (n, n) causal relative-position buckets and the causal
    mask's additive bias (-1e9 above the diagonal)."""
    pos = np.arange(n)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                       cfg.relative_attention_num_buckets,
                                       cfg.relative_attention_max_distance, bidirectional=False)
    causal = np.tril(np.ones((n, n), np.float32))
    return buckets, (1.0 - causal) * -1e9


class T5Decoder(nn.Module):
    """Causal T5 decoder with cross-attention and the LM head: decoder_ids
    (B, S_d), encoder hidden (B, S_e, d), encoder mask (B, S_e) -> f32 logits
    (B, S_d, vocab). Untied (FLAN-T5), the head is `lm_head`; tied, the
    output scaled by d_model^-0.5 goes through the embedding table."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                    cfg.num_heads)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", T5DecoderBlock(cfg))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and LM head -> f32 logits."""
        x = self.final_layer_norm(x).float()
        if self.cfg.tie_word_embeddings:
            return (x * self.cfg.d_model**-0.5) @ self.token_embedding.weight.float().T
        return x @ self.lm_head.weight.float().T

    def forward(self, decoder_ids, enc_hidden, encoder_mask=None):
        c = self.cfg
        x = self.token_embedding(decoder_ids)
        buckets, causal = _decoder_bias_table(c, decoder_ids.shape[1])
        dev = decoder_ids.device
        self_bias = self.relative_attention_bias(torch.as_tensor(buckets, device=dev))
        self_bias = self_bias.permute(2, 0, 1)[None].float() + torch.as_tensor(causal, device=dev)
        enc_bias = None
        if encoder_mask is not None:
            enc_bias = (1.0 - encoder_mask.float())[:, None, None, :] * -1e9
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x, self_bias, enc_hidden, enc_bias)
        return self.head(x)


class T5Seq2Seq(nn.Module):
    """Encoder + decoder (T5ForConditionalGeneration), one input embedding
    shared by both, with HF-compatible beam search (`generate`). The Mustango
    chord predictor calls it with num_beams=5, min_length=8, max_length=128,
    early_stopping=True."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.encoder = T5Encoder(cfg)
        self.decoder = T5Decoder(cfg)
        # one input embedding, HF's `shared`, under both names
        self.decoder.token_embedding = self.encoder.token_embedding

    def encode(self, input_ids, attention_mask):
        return self.encoder(input_ids, attention_mask)

    # ------------------------------------------------------ cached decoding
    def precompute(self, enc_hidden, enc_mask, max_len: int):
        """-> (cross K (L, B, H, S_e, dkv), cross V, the decoder's self bias
        (H, max_len, max_len) f32 with the causal mask, the encoder bias
        (B, 1, 1, S_e))."""
        c, dec = self.cfg, self.decoder
        b, se, _ = enc_hidden.shape
        h = enc_hidden.to(dec.token_embedding.weight.dtype)
        cks, cvs = [], []
        for i in range(c.num_layers):
            p = getattr(dec, f"block_{i}").cross_attn
            cks.append(p.k(h).reshape(b, se, c.num_heads, c.d_kv).transpose(1, 2))
            cvs.append(p.v(h).reshape(b, se, c.num_heads, c.d_kv).transpose(1, 2))
        buckets, causal = _decoder_bias_table(c, max_len)
        dev = enc_hidden.device
        bias = dec.relative_attention_bias(torch.as_tensor(buckets, device=dev))
        bias = bias.permute(2, 0, 1).float() + torch.as_tensor(causal, device=dev)
        enc_bias = (1.0 - enc_mask.float())[:, None, None, :] * -1e9
        return torch.stack(cks), torch.stack(cvs), bias, enc_bias

    def step(self, tok, pos: int, kc, vc, ck, cv, self_bias, enc_bias):
        """One cached decode step: tok (B,) at position pos; kc / vc (L, B, H,
        max_len, dkv) self-attention caches, written at pos in place; ck / cv
        the cross K / V; -> log-probabilities (B, vocab) f32."""
        c, dec = self.cfg, self.decoder
        x = dec.token_embedding(tok)  # (B, d)
        b, nh, dkv = x.shape[0], c.num_heads, c.d_kv
        bias_row = self_bias[None, :, pos:pos + 1, :pos + 1]  # (1, H, 1, pos + 1)
        for i in range(c.num_layers):
            blk = getattr(dec, f"block_{i}")
            a = blk.self_attn
            h = blk.ln_self(x)
            q = a.q(h).reshape(b, nh, 1, dkv)
            kc[i, :, :, pos] = a.k(h).reshape(b, nh, dkv)
            vc[i, :, :, pos] = a.v(h).reshape(b, nh, dkv)
            logits = q.float() @ kc[i, :, :, :pos + 1].float().transpose(-1, -2) + bias_row
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            x = x + a.o((probs @ vc[i, :, :, :pos + 1]).reshape(b, nh * dkv))

            a = blk.cross_attn
            q = a.q(blk.ln_cross(x)).reshape(b, nh, 1, dkv)
            logits = q.float() @ ck[i].float().transpose(-1, -2) + enc_bias
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            x = x + a.o((probs @ cv[i]).reshape(b, nh * dkv))
            x = x + blk.ff(blk.ln_ff(x))
        return torch.log_softmax(dec.head(x), dim=-1)

    def decode_logprobs(self, dec_buf, enc_hidden, enc_mask, idx: int):
        """Log-probabilities of the token after position idx through the full
        decoder: the uncached oracle the tests hold `step` to."""
        logits = self.decoder(dec_buf, enc_hidden, enc_mask)[:, idx]
        return torch.log_softmax(logits.float(), dim=-1)

    @torch.inference_mode()
    def generate(self, input_ids, attention_mask, *, num_beams: int = 5, min_length: int = 8,
                 max_length: int = 128, early_stopping: bool = True,
                 length_penalty: float = 1.0, eos_token_id: int = 1, pad_token_id: int = 0,
                 decoder_start_token_id: int = 0,
                 device_loop: Optional[bool] = None) -> np.ndarray:
        """Beam search over one prompt -> the best token sequence, the decoder
        start included (an HF generate output row), int32. Score = sum of
        log-probabilities / length**length_penalty; with early_stopping the
        search stops once num_beams hypotheses have finished.

        `device_loop` is JAX's switch between its host loop and one
        `lax.while_loop` on the device (which saves round trips to a remote
        TPU); it is kept for the signature, and either value runs the host
        loop here."""
        assert input_ids.shape[0] == 1, "beam generate handles one prompt at a time"
        if max_length <= 1:
            # HF: the decode loop never runs; generate returns the start token
            return np.asarray([decoder_start_token_id], np.int32)
        c = self.cfg
        dev = self.decoder.token_embedding.weight.device
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=dev)
        mask = torch.as_tensor(attention_mask, dtype=torch.long, device=dev)
        enc_hidden = self.encode(ids, mask)
        # the cross K / V rows are the same for every beam: project at batch 1
        ck, cv, self_bias, enc_bias = self.precompute(enc_hidden, mask, max_length)
        ck = ck.expand(-1, num_beams, -1, -1, -1)
        cv = cv.expand(-1, num_beams, -1, -1, -1)
        enc_bias = enc_bias.expand(num_beams, -1, -1, -1)
        kc = torch.zeros((c.num_layers, num_beams, c.num_heads, max_length, c.d_kv),
                         dtype=ck.dtype, device=dev)
        vc = torch.zeros_like(kc)
        tok_cur = np.full((num_beams,), decoder_start_token_id, np.int64)

        buf = np.full((num_beams, max_length), pad_token_id, np.int32)
        buf[:, 0] = decoder_start_token_id
        beam_scores = np.full((num_beams,), -1e9, np.float64)
        beam_scores[0] = 0.0  # every beam starts the same: keep one live
        hyps: list = []  # (normalized score, tokens), at most num_beams

        def add_hyp(norm, toks):
            if len(hyps) < num_beams or norm > min(h[0] for h in hyps):
                hyps.append((norm, toks))
                if len(hyps) > num_beams:
                    # HF deletes the earliest-added worst, by index
                    del hyps[min(range(len(hyps)), key=lambda i: hyps[i][0])]

        def hyp_done(cur_len_next, best_running):
            # HF 4.57's early-stop heuristic: the best running beam after
            # selection over the generated length without the start token
            if len(hyps) < num_beams:
                return False
            if early_stopping:
                return True
            best_possible = best_running / ((cur_len_next - 1) ** length_penalty)
            return min(h[0] for h in hyps) >= best_possible

        cur_len = 1
        while cur_len < max_length:
            lp_dev = self.step(torch.as_tensor(tok_cur, device=dev), cur_len - 1, kc, vc, ck, cv,
                               self_bias, enc_bias)
            lp = lp_dev.cpu().numpy().astype(np.float64)  # (num_beams, vocab)
            if cur_len < min_length:  # min_length counts the start token
                lp[:, eos_token_id] = -np.inf
            flat = (beam_scores[:, None] + lp).reshape(-1)
            # ties: the lowest index first, as torch.topk
            top = np.argsort(-flat, kind="stable")[: 2 * num_beams]
            # the last step's candidates reach max_length: HF finishes the
            # top num_beams of them whether or not they end in eos
            is_final = cur_len + 1 == max_length
            new_beams = []
            for rank, fidx in enumerate(top):
                beam, tok = divmod(int(fidx), lp.shape[1])
                score = flat[fidx]
                if tok == eos_token_id or is_final:
                    if rank >= num_beams:
                        continue  # HF drops finishes beyond the top num_beams
                    toks = buf[beam, :cur_len].copy()
                    if tok != eos_token_id:  # eos is appended at the end
                        toks = np.append(toks, tok)
                    # the normalizing length counts the token consumed now
                    add_hyp(score / (cur_len**length_penalty), toks)
                else:
                    new_beams.append((score, beam, tok))
                if len(new_beams) == num_beams:
                    break
            if not new_beams:
                break
            new_buf = np.full_like(buf, pad_token_id)
            for j, (score, beam, tok) in enumerate(new_beams):
                new_buf[j, : cur_len + 1] = np.concatenate([buf[beam, :cur_len], [tok]])
                beam_scores[j] = score
            buf = new_buf
            order = [b for _, b, _ in new_beams]
            if order != list(range(num_beams)):
                idx = torch.as_tensor(order, device=dev)
                kc, vc = kc[:, idx], vc[:, idx]
            tok_cur = np.asarray([t for _, _, t in new_beams], np.int64)
            cur_len += 1
            if hyp_done(cur_len, float(new_beams[0][0])):
                break

        out = list(max(hyps, key=lambda h: h[0])[1])
        if len(out) < max_length:
            out.append(eos_token_id)
        return np.asarray(out, np.int32)


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


def convert_t5_decoder(sd: Mapping[str, torch.Tensor],
                       prefix: str = "decoder.") -> Dict[str, torch.Tensor]:
    """HF T5 decoder weights (and `lm_head` when the checkpoint has one) ->
    the port's T5Decoder's."""
    out = {
        "token_embedding.weight": sd["shared.weight"],
        "relative_attention_bias.weight":
            sd[f"{prefix}block.0.layer.0.SelfAttention.relative_attention_bias.weight"],
        "final_layer_norm.weight": sd[f"{prefix}final_layer_norm.weight"],
    }
    if "lm_head.weight" in sd:
        out["lm_head.weight"] = sd["lm_head.weight"]
    i = 0
    while f"{prefix}block.{i}.layer.0.SelfAttention.q.weight" in sd:
        pre, blk = f"{prefix}block.{i}.layer.", f"block_{i}."
        out[blk + "ln_self.weight"] = sd[pre + "0.layer_norm.weight"]
        out[blk + "ln_cross.weight"] = sd[pre + "1.layer_norm.weight"]
        out[blk + "ln_ff.weight"] = sd[pre + "2.layer_norm.weight"]
        for name in "qkvo":
            out[blk + f"self_attn.{name}.weight"] = sd[pre + f"0.SelfAttention.{name}.weight"]
            out[blk + f"cross_attn.{name}.weight"] = sd[pre + f"1.EncDecAttention.{name}.weight"]
        for name in ("wi", "wi_0", "wi_1", "wo"):
            key = pre + f"2.DenseReluDense.{name}.weight"
            if key in sd:
                out[blk + f"ff.{name}.weight"] = sd[key]
        i += 1
    return out


def convert_t5_seq2seq(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF T5ForConditionalGeneration state dict -> the port's T5Seq2Seq's
    (`encoder.*`, `decoder.*`; `shared` feeds both embeddings)."""
    out = {f"encoder.{k}": v for k, v in convert_t5_encoder(sd).items()}
    out.update({f"decoder.{k}": v for k, v in convert_t5_decoder(sd).items()})
    return out


def t5_seq2seq_config_from_state_dict(sd: Mapping[str, torch.Tensor]) -> T5Config:
    """A T5ForConditionalGeneration's geometry from its shapes: the encoder's
    (the decoder shares it), untied when the checkpoint has an `lm_head`."""
    return dataclasses.replace(t5_config_from_state_dict(sd),
                               tie_word_embeddings="lm_head.weight" not in sd)
