"""The port's T5 seq2seq (tango_tpu_torch/models/t5.py: T5Decoder, the
KV-cached steps, HF beam search in both loops), Mustango's chord predictor,
against the t5gen_tiny golden (HF T5ForConditionalGeneration and its
generate) and JAX's host and device loops, on the CPU in f32. Logits at
tests/test_t5.py's 3e-4 / 1e-3, the cached step at its 2e-4 / 1e-3, the
shape-static step against it at 1e-5, the beams token for token."""

import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.models import t5 as jt5
from tango_tpu_torch import configs as TC
from tango_tpu_torch.models import t5
from tango_tpu_torch.utils.convert import from_jax_params
from tango_tpu_torch.utils.export import export_t5_seq2seq

from tests.conftest import load_golden
from tests.test_t5 import GOLDEN_GEN_CASES, GOLDEN_GEN_CASES_EOSBIAS, TINY_T5GEN

torch.set_num_threads(1)

TINY = TC.T5Config.from_dict(TINY_T5GEN.to_dict())
# tests/test_t5.py:169-176, which JAX's device loop is held to against its host loop
EXTRA_CASES = [dict(num_beams=3, min_length=2, max_length=8, early_stopping=False),
               dict(num_beams=5, min_length=6, max_length=10, early_stopping=True)]


@pytest.fixture(scope="module")
def golden():
    g = load_golden("t5gen_tiny")
    sd = {k[4:]: torch.from_numpy(np.array(g[k])) for k in g.files if k.startswith("sd::")}
    return g, sd


@pytest.fixture(scope="module")
def model(golden):
    _, sd = golden
    m = t5.T5Seq2Seq(TINY)
    m.load_state_dict(t5.convert_t5_seq2seq(sd))
    return m.eval()


# the eos-biased head on a long budget: eos enters the top 2K often and the
# search stops early, at 14 of its 29 steps
EOSBIAS_EARLY = dict(num_beams=5, min_length=3, max_length=30, early_stopping=True)


@pytest.fixture(scope="module")
def jax_model(golden):
    _, sd = golden
    return jt5.T5Seq2Seq(TINY_T5GEN), jt5.convert_t5_seq2seq({k: v.numpy() for k, v in sd.items()})


def _biased(model, g):
    m = copy.deepcopy(model)
    m.decoder.lm_head.weight.data = torch.from_numpy(np.array(g["biased_lm_head"]))
    return m


def test_config_from_state_dict(golden):
    _, sd = golden
    assert t5.t5_seq2seq_config_from_state_dict(sd) == TC.T5Config(
        **{**TINY.to_dict(), "relative_attention_max_distance": 128})
    tied = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    assert t5.t5_seq2seq_config_from_state_dict(tied).tie_word_embeddings


def test_converter_and_exporter_are_bit_exact(golden):
    """convert_t5_seq2seq matches JAX's through from_jax_params (a subtree
    each); export_t5_seq2seq gives back every HF key, the embedding aliases
    included."""
    _, sd = golden
    got = t5.convert_t5_seq2seq(sd)
    jparams = jt5.convert_t5_seq2seq({k: v.numpy() for k, v in sd.items()})
    want = {f"{part}.{k}": v for part in ("encoder", "decoder")
            for k, v in from_jax_params(jparams[part]).items()}
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    back = export_t5_seq2seq(got)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_decoder_logits_match_golden(golden, model):
    g, _ = golden
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(g["ids"]).long(), torch.from_numpy(g["mask"]).long())
        logits = model.decoder(torch.from_numpy(g["dec_ids"]).long(), enc,
                               torch.from_numpy(g["mask"]).long())
    np.testing.assert_allclose(logits.numpy(), g["logits"], atol=3e-4, rtol=1e-3)


def test_tied_head_matches_jax(golden):
    """The tied head (the embedding table, the output scaled by
    d_model^-0.5) against JAX's decoder on the same weights."""
    g, sd = golden
    cfg = TC.T5Config(**{**TINY.to_dict(), "tie_word_embeddings": True})
    tied = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    m = t5.T5Seq2Seq(cfg)
    m.load_state_dict(t5.convert_t5_seq2seq(tied))
    jcfg = jt5.T5Config(**{**TINY_T5GEN.to_dict(), "tie_word_embeddings": True})
    jm = jt5.T5Seq2Seq(jcfg)
    jp = jt5.convert_t5_seq2seq({k: v.numpy() for k, v in tied.items()})
    enc = jm.encode(jp, g["ids"], g["mask"])
    want = jm.decoder.apply({"params": jp["decoder"]}, g["dec_ids"], enc, g["mask"])
    with torch.no_grad():
        ids, mask = torch.from_numpy(g["ids"]).long(), torch.from_numpy(g["mask"]).long()
        got = m.decoder(torch.from_numpy(g["dec_ids"]).long(), m.encode(ids, mask), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4, rtol=1e-3)


def test_cached_step_matches_full_decoder(golden, model):
    """The single-token step with KV caches reproduces the full decoder's
    log-probabilities at every position, and a beam reorder carries the
    caches."""
    g, _ = golden
    ids, mask = torch.from_numpy(g["ids"]).long(), torch.from_numpy(g["mask"]).long()
    dec_ids = torch.from_numpy(g["dec_ids"]).long()
    b, s = dec_ids.shape
    c = model.cfg
    with torch.no_grad():
        enc = model.encode(ids, mask)
        ck, cv, self_bias, enc_bias = model.precompute(enc, mask, s)
        kc = torch.zeros(c.num_layers, b, c.num_heads, s, c.d_kv)
        vc = torch.zeros_like(kc)
        for pos in range(s):
            lp = model.step(dec_ids[:, pos], pos, kc, vc, ck, cv, self_bias, enc_bias)
            ref = model.decode_logprobs(dec_ids, enc, mask, pos)
            np.testing.assert_allclose(lp.numpy(), ref.numpy(), atol=2e-4, rtol=1e-3,
                                       err_msg=f"cached step diverges at position {pos}")
    two = torch.cat([kc, 2 * kc], dim=1)
    assert torch.equal(two[:, [1, 0]][:, 0], 2 * kc[:, 0])


@pytest.mark.parametrize("key,kw", GOLDEN_GEN_CASES + GOLDEN_GEN_CASES_EOSBIAS,
                         ids=[c[0] for c in GOLDEN_GEN_CASES + GOLDEN_GEN_CASES_EOSBIAS])
def test_beam_search_matches_hf(golden, model, key, kw):
    """Token for token against HF generate, the eos-biased head's cases
    included (final-step finishing and the normalizing length)."""
    g, _ = golden
    m = _biased(model, g) if key.startswith("generated_eosbias") else model
    for device_loop in (False, True):  # the host loop, then the eager device loop
        out = m.generate(g["ids"], g["mask"], device_loop=device_loop, **kw)
        assert out.dtype == np.int32
        assert m.beam_stats["loop"] == ("device" if device_loop else "host")
        np.testing.assert_array_equal(out, g[key], err_msg=f"{key} device_loop={device_loop}")


def test_beam_search_max_length_one(golden, model):
    g, _ = golden
    out = model.generate(g["ids"], g["mask"], num_beams=3, min_length=1, max_length=1)
    np.testing.assert_array_equal(out, np.asarray([0], np.int32))


@pytest.mark.parametrize("kw", EXTRA_CASES, ids=["esf_beams3", "es_beams5"])
def test_beam_search_matches_jax_host_loop(golden, model, kw):
    g, sd = golden
    jm = jt5.T5Seq2Seq(TINY_T5GEN)
    jp = jt5.convert_t5_seq2seq({k: v.numpy() for k, v in sd.items()})
    want = jm.generate(jp, g["ids"], g["mask"], device_loop=False, **kw)
    np.testing.assert_array_equal(model.generate(g["ids"], g["mask"], **kw), want)


def test_beam_search_on_random_prompt_matches_jax(golden, model):
    """A second prompt, padded: the encoder mask reaches the cross-attention."""
    g, sd = golden
    rng = np.random.RandomState(0)
    ids = rng.randint(2, 64, (1, 12)).astype(np.int64)
    mask = np.ones((1, 12), np.int64)
    mask[0, 7:] = 0
    jm = jt5.T5Seq2Seq(TINY_T5GEN)
    jp = jt5.convert_t5_seq2seq({k: v.numpy() for k, v in sd.items()})
    kw = dict(num_beams=5, min_length=4, max_length=16)
    want = jm.generate(jp, jnp.asarray(ids), jnp.asarray(mask), device_loop=False, **kw)
    np.testing.assert_array_equal(model.generate(ids, mask, **kw), want)


def _random_prompt():
    rng = np.random.RandomState(0)
    ids = rng.randint(2, 64, (1, 12)).astype(np.int64)
    mask = np.ones((1, 12), np.int64)
    mask[0, 7:] = 0
    return ids, mask


@pytest.mark.parametrize("case", ["esf_beams3", "es_beams5", "eosbias_early", "eosbias_esf",
                                  "random_prompt"])
def test_device_loop_matches_jax_device_loop(golden, model, jax_model, case):
    """The port's device loop (eager on the CPU) against JAX's
    `_device_beam_search` (generate(device_loop=True)), token for token:
    tests/test_t5.py's two further configurations, the eos-biased head, and
    the padded random prompt."""
    g, _ = golden
    jm, jp = jax_model
    ids, mask, m = g["ids"], g["mask"], model
    kw = {"esf_beams3": EXTRA_CASES[0], "es_beams5": EXTRA_CASES[1],
          "eosbias_early": EOSBIAS_EARLY, "eosbias_esf": GOLDEN_GEN_CASES_EOSBIAS[1][1],
          "random_prompt": dict(num_beams=5, min_length=4, max_length=16)}[case]
    if case.startswith("eosbias"):
        m = _biased(model, g)
        jp = copy.deepcopy(jp)
        jp["decoder"]["lm_head"] = np.asarray(g["biased_lm_head"])
    if case == "random_prompt":
        ids, mask = _random_prompt()
    want = jm.generate(jp, jnp.asarray(ids), jnp.asarray(mask), device_loop=True, **kw)
    got = m.generate(ids, mask, device_loop=True, **kw)
    assert m.beam_stats["loop"] == "device" and not m.beam_stats["graph"]
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=case)


def test_static_step_matches_step(golden, model):
    """The device loop's shape-static step (pos a tensor, attention over every
    cache position, the bias row selected by pos, the prompt's K / V at batch
    1 for both rows) against `step` (the K / V a row) at every position of a
    12-token decode of two rows."""
    g, _ = golden
    c = model.cfg
    ids, mask = torch.from_numpy(g["ids"]).long(), torch.from_numpy(g["mask"]).long()
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, c.vocab_size, (2, 12)))
    n = toks.shape[1]
    with torch.no_grad():
        enc = model.encode(ids.expand(2, -1), mask.expand(2, -1))
        ck, cv, self_bias, enc_bias = model.precompute(enc, mask.expand(2, -1), n)
        kc = torch.zeros(c.num_layers, 2, c.num_heads, n, c.d_kv)
        vc, kc2, vc2 = torch.zeros_like(kc), torch.zeros_like(kc), torch.zeros_like(kc)
        for pos in range(n):
            want = model.step(toks[:, pos], pos, kc, vc, ck, cv, self_bias, enc_bias)
            got = model.static_step(toks[:, pos], torch.tensor(pos), kc2, vc2, ck[:, :1],
                                    cv[:, :1], self_bias, enc_bias[:1])
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=f"static step diverges at position {pos}")
    np.testing.assert_allclose(kc2.numpy(), kc.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(vc2.numpy(), vc.numpy(), atol=1e-5, rtol=1e-5)


def test_device_loop_chunks_agree(golden, model):
    """A chunk of 1 step (the loop stops at `done`) and chunks of BEAM_CHUNK
    and of 29 steps (up to 15 steps after `done`, all masked) leave the same
    state and tokens on a search that stops early; the host reads `done`
    once a chunk and the result once."""
    g, _ = golden
    m = _biased(model, g)
    L = EOSBIAS_EARLY["max_length"]
    with torch.inference_mode():
        mask = torch.from_numpy(g["mask"]).long()
        enc = m.encode(torch.from_numpy(g["ids"]).long(), mask)
        pre = m.precompute(enc, mask, L)
    runs = []
    for chunk in (1, t5.BEAM_CHUNK, L - 1):
        out = m.device_beam_search(*pre, length_penalty=1.0, eos_token_id=1, pad_token_id=0,
                                   decoder_start_token_id=0, chunk=chunk, **EOSBIAS_EARLY)
        s = m._beam_search
        state = {k: getattr(s, k).clone() for k in (
            "cur_len", "done", "tok_cur", "buf", "scores", "kc", "vc", "hyps_score",
            "hyps_tok", "hyps_len", "n_hyps")}
        runs.append((out, dict(m.beam_stats), state))
    (out1, stats1, state1) = runs[0]
    assert stats1["steps"] < L - 1, "the case must stop early"
    for out, stats, state in runs:
        np.testing.assert_array_equal(out, out1)
        assert stats["steps"] == stats1["steps"]
        assert stats["syncs"] == math.ceil(stats["steps"] / stats["chunk"]) + 1
        for k, v in state.items():
            assert torch.equal(v, state1[k]), k
    want = m.generate(g["ids"], g["mask"], device_loop=False, **EOSBIAS_EARLY)
    np.testing.assert_array_equal(out1, want)


def test_loop_switch(golden, model):
    """None picks the device loop on CUDA and the host loop on the CPU, as
    JAX by its backend; True and False are obeyed (decided from the device
    alone: no card is needed)."""
    assert t5.use_device_loop(None, "cuda") and t5.use_device_loop(None, torch.device("cuda:0"))
    assert not t5.use_device_loop(None, "cpu")
    assert t5.use_device_loop(True, "cpu") and not t5.use_device_loop(False, "cuda")
    g, _ = golden
    kw = GOLDEN_GEN_CASES[0][1]
    for device_loop, loop in ((None, "host"), (True, "device"), (False, "host")):
        model.generate(g["ids"], g["mask"], device_loop=device_loop, **kw)
        assert model.beam_stats["loop"] == loop
    with pytest.raises(ValueError, match="CUDA graph"):
        model.device_beam_search(*model.precompute(model.encode(
            torch.from_numpy(g["ids"]).long(), torch.from_numpy(g["mask"]).long()),
            torch.from_numpy(g["mask"]).long(), 12), graph=True, **{
            **kw, "length_penalty": 1.0, "eos_token_id": 1, "pad_token_id": 0,
            "decoder_start_token_id": 0})
