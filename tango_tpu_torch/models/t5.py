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
broadcast to the beams. It has two loops, as JAX's has, both pinned token for
token to HF:
- the device loop (`device_beam_search`, JAX's `_device_beam_search`,
  tango_tpu/models/t5.py:420-566): beams, f32 scores and finished hypotheses
  in fixed-size tensors on the model's device, a shape-static step
  (`static_step`), the host reading a `done` flag once every BEAM_CHUNK
  steps. On CUDA a chunk of steps is one CUDA graph, replayed; on the CPU
  the same code runs eagerly. The default on CUDA.
- the host loop: the bookkeeping in numpy on the host, from one host copy of
  each step's log-probabilities in f64, exactly as JAX's host loop
  (tango_tpu/models/t5.py:648-740). The default on the CPU.

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


# steps of the device beam search between two host reads of its `done` flag
BEAM_CHUNK = 8


def use_device_loop(device_loop: Optional[bool], device) -> bool:
    """`generate`'s loop: the device loop where asked, else (None) where the
    model is on CUDA, as JAX's default is off the CPU."""
    if device_loop is None:
        return torch.device(device).type == "cuda"
    return bool(device_loop)


class _BeamSearch:
    """The device loop's state in fixed-size tensors, its step and its CUDA
    graph: the counterpart of JAX's `_device_beam_search`
    (tango_tpu/models/t5.py:420-566), statement for statement. The prompt's
    cross K / V and biases are copied into static buffers at batch 1, where
    the step reads them once for all beams. A step after `done` leaves the
    state as it was: every write is masked by it."""

    NEG = -1e9

    def __init__(self, model, key, ck, cv, self_bias, enc_bias):
        (self.K, self.min_length, self.L, self.early_stopping, self.length_penalty, self.eos,
         self.pad, self.start, _, self.chunk) = key[:10]
        self.key, self.graph = key, None
        c, K, L, dev = model.cfg, self.K, self.L, ck.device
        self.ck, self.cv = torch.empty_like(ck), torch.empty_like(cv)
        self.self_bias, self.enc_bias = torch.empty_like(self_bias), torch.empty_like(enc_bias)
        dec = model.decoder
        vocab = (dec.token_embedding if c.tie_word_embeddings else dec.lm_head).weight.shape[0]
        self.eos_column = torch.arange(vocab, device=dev) == self.eos
        self.ranks = torch.arange(2 * K, device=dev)
        self.beams = torch.arange(K, device=dev)

        def state(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        self.cur_len, self.done = state((), torch.long), state((), torch.bool)
        self.tok_cur, self.buf = state((K,), torch.long), state((K, L), torch.long)
        self.scores = state((K,), torch.float32)
        self.kc = state((c.num_layers, K, c.num_heads, L, c.d_kv), ck.dtype)
        self.vc = torch.empty_like(self.kc)
        self.hyps_score, self.hyps_tok = state((K,), torch.float32), state((K, L), torch.long)
        self.hyps_len, self.n_hyps = state((K,), torch.long), state((), torch.long)

    def load(self, ck, cv, self_bias, enc_bias):
        """A prompt's inputs into the static buffers, and the initial state."""
        for dst, src in ((self.ck, ck), (self.cv, cv), (self.self_bias, self_bias),
                         (self.enc_bias, enc_bias)):
            dst.copy_(src)
        self.cur_len.fill_(1)
        self.done.fill_(False)
        self.tok_cur.fill_(self.start)
        self.buf.fill_(self.pad)
        self.buf[:, 0] = self.start
        self.scores.fill_(self.NEG)
        self.scores[0] = 0.0  # every beam starts the same: keep one live
        self.kc.zero_()
        self.vc.zero_()
        self.hyps_score.fill_(self.NEG)
        self.hyps_tok.fill_(self.pad)
        self.hyps_len.zero_()
        self.n_hyps.zero_()

    def capture(self, model):
        """One CUDA graph of a chunk of steps, after a warm-up on a side
        stream (PyTorch's CUDA-graph recipe); the warm-up's steps change the
        state, so the caller loads it again."""
        side = torch.cuda.Stream(self.kc.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.run(model, self.chunk)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.run(model, self.chunk)
        self.graph = graph

    def run(self, model, n: int):
        for _ in range(n):
            self.step(model)

    @staticmethod
    def _at(t, i):
        """t[i] for a 0-d index tensor, with no host read."""
        return t.index_select(0, i.view(1))[0]

    def _insert_hyp(self, push, norm, row, row_len):
        """HF's BeamHypotheses.add where push: append while fewer than K,
        else replace the first-found worst if norm beats it."""
        K, at = self.K, self._at
        not_full = self.n_hyps < K
        worst = torch.argmin(self.hyps_score)
        slot = torch.where(not_full, self.n_hyps, worst).view(1)
        do = push & (not_full | (norm > at(self.hyps_score, worst)))
        for store, new in ((self.hyps_score, norm), (self.hyps_tok, row),
                           (self.hyps_len, row_len)):
            store.index_copy_(0, slot, torch.where(do, new, store.index_select(0, slot)[0])[None])
        self.n_hyps.copy_(torch.where(do, (self.n_hyps + 1).clamp(max=K), self.n_hyps))

    def step(self, model):
        K, L = self.K, self.L
        live = ~self.done
        cur_len = self.cur_len
        pos = (cur_len - 1).view(1)
        caches = (self.kc, self.vc)
        kept = [cache.index_select(3, pos) for cache in caches]
        lp = model.static_step(self.tok_cur, pos[0], self.kc, self.vc, self.ck, self.cv,
                               self.self_bias, self.enc_bias)  # (K, V) f32
        for cache, old in zip(caches, kept):  # after done, the K / V written back
            cache.index_copy_(3, pos, torch.where(live, cache.index_select(3, pos), old))
        V = lp.shape[1]
        lp = torch.where((cur_len < self.min_length) & self.eos_column, -torch.inf, lp)
        flat = (self.scores[:, None] + lp).reshape(-1)
        # ties go to the lowest flat index, as in lax.top_k and the host
        # loop's stable argsort; torch.topk does not promise that order
        top_vals, top_idx = torch.sort(flat, descending=True, stable=True)
        top_vals, top_idx = top_vals[:2 * K], top_idx[:2 * K]
        top_beams, top_toks = top_idx // V, top_idx % V
        # HF's norm length: the generated tokens with the one consumed now,
        # without the start token = cur_len
        norm = top_vals / cur_len.float() ** self.length_penalty
        # the last step's candidates reach max_length: HF finishes the top K
        # of them whether or not they end in eos
        is_final = cur_len == L - 1
        is_eos = top_toks == self.eos
        col = cur_len.clamp(max=L - 1).view(1)  # the column this step fills
        rows = self.buf.index_select(0, top_beams[:K])
        rows.index_copy_(1, col, torch.where(is_eos[:K, None], rows.index_select(1, col),
                                             top_toks[:K, None]))
        row_lens = torch.where(is_eos, cur_len, cur_len + 1)
        push = (is_eos | is_final) & live
        for r in range(K):  # ranks past K finish nothing
            self._insert_hyp(push[r], norm[r], rows[r], row_lens[r])

        # non-eos candidates fill the next beams in rank order
        order = torch.sort(is_eos.long() * (2 * K) + self.ranks).indices[:K]
        taken = ~is_eos[order] & live
        n_sel = taken.sum()
        sel_scores = torch.where(taken, top_vals[order], self.NEG)
        sel_beams = torch.where(taken, top_beams[order], 0)
        sel_toks = torch.where(taken, top_toks[order], self.pad)

        buf = self.buf.index_select(0, sel_beams)
        buf.index_copy_(1, col, sel_toks[:, None])
        self.buf.copy_(torch.where(live, buf, self.buf))
        keep = torch.where(live, sel_beams, self.beams)
        for cache in caches:
            cache.copy_(cache.index_select(1, keep))
        self.scores.copy_(torch.where(live, sel_scores, self.scores))
        self.tok_cur.copy_(torch.where(live, sel_toks, self.tok_cur))
        cur_len = cur_len + live.long()
        kept_min = torch.where(self.beams < self.n_hyps, self.hyps_score, torch.inf).min()
        # HF 4.57's early-stop heuristic: the best running beam after
        # selection over the generated length without the start token
        best_possible = sel_scores[0] / (cur_len - 1).float() ** self.length_penalty
        is_done = self.n_hyps >= K
        if not self.early_stopping:
            is_done = is_done & (kept_min >= best_possible)
        self.done.copy_(self.done | (n_sel == 0) | is_done | (cur_len >= L))
        self.cur_len.copy_(cur_len)

    def result(self) -> torch.Tensor:
        """(L + 2,): the best hypothesis with eos appended below max_length,
        its length, and the steps taken."""
        at, L = self._at, self.L
        best = torch.argmax(torch.where(self.beams < self.n_hyps, self.hyps_score, -torch.inf))
        tokens, out_len = self.hyps_tok.index_select(0, best.view(1))[0], at(self.hyps_len, best)
        short = out_len < L
        end = out_len.clamp(max=L - 1).view(1)
        tokens.index_copy_(0, end, torch.where(short, self.eos, tokens.index_select(0, end)))
        out_len = torch.where(short, out_len + 1, out_len)
        return torch.cat([tokens, out_len.view(1), (self.cur_len - 1).view(1)])


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
        # the device loop's state (and on CUDA its graph) for the last key
        self._beam_search: Optional[_BeamSearch] = None
        # what the last generate ran: its loop, steps and host syncs
        self.beam_stats: Optional[dict] = None

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
        the cross K / V (L, B or 1, H, S_e, dkv) and enc_bias (B or 1, 1, 1,
        S_e): at batch 1 every row attends to the one prompt; ->
        log-probabilities (B, vocab) f32."""
        def write(cache, new):
            cache[:, :, pos] = new

        return self._cached_step(tok, write, lambda cache: cache[:, :, :pos + 1],
                                 self_bias[None, :, pos:pos + 1, :pos + 1],
                                 kc, vc, ck, cv, enc_bias)

    def static_step(self, tok, pos: torch.Tensor, kc, vc, ck, cv, self_bias, enc_bias):
        """`step` with every shape fixed, the step of the device loop (JAX's
        `step`, tango_tpu/models/t5.py:351-412): pos a 0-d int64 tensor; the
        new K / V written at pos by an indexed copy; the self-attention over
        all max_len cache positions, the causal bias row selected by pos,
        whose -1e9 makes the later positions' weights exactly 0 in f32. It
        computes what `step` computes, in another summation order."""
        at = pos.view(1)

        def write(cache, new):
            cache.index_copy_(2, at, new[:, :, None])

        return self._cached_step(tok, write, lambda cache: cache,
                                 self_bias.index_select(1, at)[None], kc, vc, ck, cv, enc_bias)

    def _cached_step(self, tok, write, attend, bias_row, kc, vc, ck, cv, enc_bias):
        """The decoder on one token a row: write(cache, new) stores a layer's
        new K or V (B, H, dkv), attend(cache) gives the keys / values the
        query sees, bias_row (1, H, 1, keys) is their bias."""
        c, dec = self.cfg, self.decoder
        x = dec.token_embedding(tok)  # (B, d)
        b, nh, dkv = x.shape[0], c.num_heads, c.d_kv
        for i in range(c.num_layers):
            blk = getattr(dec, f"block_{i}")
            a = blk.self_attn
            h = blk.ln_self(x)
            q = a.q(h).reshape(b, nh, 1, dkv)
            write(kc[i], a.k(h).reshape(b, nh, dkv))
            write(vc[i], a.v(h).reshape(b, nh, dkv))
            logits = q.float() @ attend(kc[i]).float().transpose(-1, -2) + bias_row
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            x = x + a.o((probs @ attend(vc[i])).reshape(b, nh * dkv))

            # one prompt's K / V for every row: the rows fold into the
            # product's M, and the K / V are read once
            a, kb = blk.cross_attn, ck.shape[1]
            q = a.q(blk.ln_cross(x)).reshape(kb, b // kb, nh, dkv).transpose(1, 2)
            logits = q.float() @ ck[i].float().transpose(-1, -2) + enc_bias
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            x = x + a.o((probs @ cv[i]).transpose(1, 2).reshape(b, nh * dkv))
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

        `device_loop` is JAX's switch: True runs the device loop
        (`device_beam_search`: f32 scores on the model's device, on CUDA one
        CUDA graph a chunk of BEAM_CHUNK steps), False the host loop (numpy,
        f64 scores); None, the default, picks the device loop when the
        parameters are on CUDA and the host loop on the CPU
        (`use_device_loop`), as JAX picks by its backend. `beam_stats` then
        says which loop ran, its steps and its host syncs."""
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
        if use_device_loop(device_loop, dev):
            return self.device_beam_search(
                ck, cv, self_bias, enc_bias, num_beams=num_beams, min_length=min_length,
                max_length=max_length, early_stopping=early_stopping,
                length_penalty=length_penalty, eos_token_id=eos_token_id,
                pad_token_id=pad_token_id, decoder_start_token_id=decoder_start_token_id)
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

        cur_len, steps = 1, 0
        while cur_len < max_length:
            steps += 1
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

        self.beam_stats = {"loop": "host", "graph": False, "steps": steps, "syncs": steps}
        out = list(max(hyps, key=lambda h: h[0])[1])
        if len(out) < max_length:
            out.append(eos_token_id)
        return np.asarray(out, np.int32)

    @torch.inference_mode()
    def device_beam_search(self, ck, cv, self_bias, enc_bias, *, num_beams: int,
                           min_length: int, max_length: int, early_stopping: bool,
                           length_penalty: float, eos_token_id: int, pad_token_id: int,
                           decoder_start_token_id: int, chunk: int = BEAM_CHUNK,
                           graph: Optional[bool] = None) -> np.ndarray:
        """The device loop over `precompute`'s outputs at batch 1 -> the best
        token sequence, as `generate` returns it. The state lives in
        fixed-size tensors on ck's device; the host reads the `done` flag
        once every `chunk` steps and the result once at the end. `graph`
        (default: on CUDA) replays a chunk as one CUDA graph, captured once
        for the key of the search; False runs the same steps eagerly. A
        failed capture or replay raises: nothing falls back to another
        loop."""
        graph = ck.is_cuda if graph is None else graph
        if graph and not ck.is_cuda:
            raise ValueError("a CUDA graph of the beam search needs the model on CUDA")
        # a parameter replaced since the capture would leave the graph reading
        # freed memory: the parameters' addresses are part of the key
        key = (num_beams, min_length, max_length, bool(early_stopping), float(length_penalty),
               eos_token_id, pad_token_id, decoder_start_token_id, ck.shape[3], chunk,
               str(ck.device), ck.dtype, tuple(p.data_ptr() for p in self.decoder.parameters()))
        if self._beam_search is None or self._beam_search.key != key:
            # the last key's buffers and graph pool are freed first, as JAX
            # clears its loops when max_length changes
            self._beam_search = None
            self._beam_search = _BeamSearch(self, key, ck, cv, self_bias, enc_bias)
        search = self._beam_search
        search.load(ck, cv, self_bias, enc_bias)
        if graph and search.graph is None:
            search.capture(self)
            search.load(ck, cv, self_bias, enc_bias)
        syncs = 0
        while True:
            if graph:
                search.graph.replay()
            else:
                search.run(self, chunk)
            syncs += 1
            if bool(search.done):  # the one read a chunk
                break
        out = search.result().cpu().numpy()  # tokens, length, steps: one read
        self.beam_stats = {"loop": "device", "graph": graph, "steps": int(out[-1]),
                           "syncs": syncs + 1, "chunk": chunk}
        return out[: int(out[-2])].astype(np.int32)


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
