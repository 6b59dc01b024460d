"""The port's CLAP (tango_tpu_torch/models/clap.py, models/pann.py) against
the JAX package's on the CPU and against the reference golden
`clap_text_tiny`, at the JAX tests' tolerances (tests/test_clap.py: 2e-4 /
1e-3 at the valid positions; tests/test_pann.py: 5e-4 / 1e-3). `Clap` runs
with the goldens' tiny towers (TINY_ROBERTA, TINY_HTSAT: a shared 16-d joint
space) and the RoBERTa-id word-hash tokenizer in both packages."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.models import clap as J
from tango_tpu.models import htsat as JH
from tango_tpu.models import pann as JP
from tango_tpu_torch.models import clap as P
from tango_tpu_torch.models import htsat as PH
from tango_tpu_torch.models import pann as PP
from tango_tpu_torch.tokenizer import WordHashTokenizer, roberta_word_hash
from tango_tpu_torch.utils.convert import from_jax_params

from tests._torch_helpers import tiny_clap_configs
from tests.conftest import load_golden
from tests.test_clap import TINY_ROBERTA as J_ROBERTA
from tests.test_htsat import TINY_HTSAT as J_HTSAT

torch.set_num_threads(1)

P_ROBERTA, P_HTSAT = tiny_clap_configs()
TOL = dict(atol=2e-4, rtol=1e-3)


def _sd(name):
    g = load_golden(name)
    return g, {k[4:]: g[k] for k in g.files if k.startswith("sd::")}


def _assert_same_state(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k


def test_text_tower_matches_golden_and_jax():
    g, sd = _sd("clap_text_tiny")
    jparams = J.convert_clap_text(sd)
    ours = P.convert_clap_text(sd)
    _assert_same_state(ours, from_jax_params(jparams))
    model = P.ClapTextEncoder(P_ROBERTA)
    model.load_state_dict(ours)
    ids, mask = torch.from_numpy(g["ids"]).long(), torch.from_numpy(g["mask"]).long()
    with torch.no_grad():
        hidden = model(ids, mask, return_hidden=True).numpy()
        emb = model(ids, mask).numpy()
    jmodel = J.ClapTextEncoder(J_ROBERTA)
    jhidden = np.asarray(jmodel.apply({"params": jparams}, g["ids"], g["mask"], return_hidden=True))
    jemb = np.asarray(jmodel.apply({"params": jparams}, g["ids"], g["mask"]))
    valid = g["mask"].astype(bool)
    np.testing.assert_allclose(hidden[valid], g["last_hidden"][valid], **TOL)
    np.testing.assert_allclose(hidden[valid], jhidden[valid], **TOL)
    np.testing.assert_allclose(emb, g["emb"], **TOL)
    np.testing.assert_allclose(emb, jemb, **TOL)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)


def test_converter_prefixes_and_bare_roberta():
    """A whole CLAP checkpoint's text_branch. / text_projection. keys, with
    a prefix, convert as JAX's do; a bare RobertaModel has no projection."""
    _, sd = _sd("clap_text_tiny")
    full = {("m.text_branch." + k if not k.startswith("text_projection") else "m." + k): v
            for k, v in sd.items()}
    _assert_same_state(P.convert_clap_text(full, prefix="m."),
                       from_jax_params(J.convert_clap_text(full, prefix="m.")))
    bare = {k: v for k, v in sd.items() if not k.startswith("text_projection")}
    assert not any(k.startswith("proj_") for k in P.convert_clap_text(bare))


def test_roberta_position_ids_match_jax():
    ids = np.array([[0, 5, 7, 2, 1, 1], [0, 9, 2, 1, 1, 1]])
    np.testing.assert_array_equal(P.roberta_position_ids(torch.from_numpy(ids)).numpy(),
                                  np.asarray(J.roberta_position_ids(jnp.asarray(ids))))


def test_roberta_fallback_tokenizer_ids():
    """<s> = 0 first, </s> = 2 last, pad = 1 after; words above the special
    ids; "" is <s></s>; the default word hash keeps FLAN-T5's ids."""
    tok = roberta_word_hash(120)
    out = tok(["a drum loop", ""], max_length=6)
    ids, mask = out["input_ids"], out["attention_mask"]
    assert ids[0, 0] == 0 and ids[0, 4] == 2 and ids[0, 5] == 1
    assert ((ids[0, 1:4] >= 3) & (ids[0, 1:4] < 120)).all()
    assert ids[1].tolist() == [0, 2, 1, 1, 1, 1] and mask[1].tolist() == [1, 1, 0, 0, 0, 0]
    trunc = tok(["one two three four five six seven"], max_length=6)["input_ids"][0]
    assert trunc[0] == 0 and trunc[-1] == 2 and (trunc[1:5] >= 3).all()
    np.testing.assert_array_equal(P.roberta_position_ids(torch.from_numpy(ids)).numpy()[1],
                                  [2, 3, 1, 1, 1, 1])
    t5 = WordHashTokenizer(50)
    assert (t5.pad_id, t5.eos_id, t5.bos_id, t5.first_word_id) == (0, 1, None, 2)
    with pytest.raises(ValueError):
        WordHashTokenizer(3, pad_id=1, eos_id=2, bos_id=0)


@pytest.fixture(scope="module")
def towers():
    _, text_sd = _sd("clap_text_tiny")
    _, audio_sd = _sd("htsat_tiny")
    tok = roberta_word_hash(J_ROBERTA.vocab_size)
    ours = P.Clap(P.convert_clap_text(text_sd), PH.convert_clap_audio(audio_sd, P_HTSAT), tok,
                  P_ROBERTA, P_HTSAT, max_length=12, device="cpu")
    theirs = J.Clap(J.convert_clap_text(text_sd), JH.convert_clap_audio(audio_sd, J_HTSAT), tok,
                    J_ROBERTA, J_HTSAT, max_length=12)
    return ours, theirs


def _waves():
    """A clip longer than TINY_HTSAT's 2 s and two short ones (repeat-pad)."""
    rng = np.random.RandomState(0)
    return [rng.randn(40000).astype(np.float32) * 0.1,
            rng.randn(12000).astype(np.float32) * 0.1,
            0.3 * np.sin(np.arange(7000) * 0.05).astype(np.float32)]


def test_clap_matches_jax(towers):
    ours, theirs = towers
    prompts = ["a drum loop", "silence", "a dog barks"]
    wavs = _waves()
    emb = ours.audio_embed(np.stack([w[:12000] for w in wavs[:2]]))
    np.testing.assert_allclose(emb, theirs.audio_embed(np.stack([w[:12000] for w in wavs[:2]])),
                               **TOL)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-4)
    for w in wavs:
        np.testing.assert_allclose(ours.audio_embed(w[None]), theirs.audio_embed(w[None]), **TOL)
    np.testing.assert_allclose(ours.text_embed(prompts), theirs.text_embed(prompts), **TOL)
    same = np.stack([w[:7000] for w in wavs])
    sims = ours.similarity(same, "a drum loop")
    np.testing.assert_allclose(sims, theirs.similarity(same, "a drum loop"), **TOL)
    assert sims.shape == (3,) and np.all(np.abs(sims) <= 1.0 + 1e-5)
    score = ours.clap_score(same, prompts)
    np.testing.assert_allclose(score, theirs.clap_score(same, prompts), **TOL)
    assert abs(score) <= 1.0 + 1e-5


def test_audio_embed_chunks_of_audio_batch(towers, monkeypatch):
    """More clips than `audio_batch`: chunked, the last chunk padded by
    repetition, each row as when embedded alone."""
    ours, _ = towers
    wavs = np.stack([w[:7000] for w in _waves()])
    whole = ours.audio_embed(wavs)
    monkeypatch.setattr(ours, "audio_batch", 2)
    np.testing.assert_allclose(ours.audio_embed(wavs), whole, atol=1e-6, rtol=1e-5)


def test_conditioner_protocol(towers):
    ours, _ = towers
    e = ours.text_embed(["a drum loop", "silence"])
    assert e.shape == (2, 16)
    u = ours.unconditional_embed(3)
    assert u.shape == (3, 16)
    np.testing.assert_array_equal(u[0], u[2])
    np.testing.assert_allclose(u[0], ours.text_embed([""])[0], atol=1e-6)


def test_audio_embed_repeatpad_short_clips():
    """Short clips are tiled whole int(clip / len) times then zero-padded
    (the reference's data_filling="repeatpad"); a clip-length one passes."""
    ns = SimpleNamespace(
        audio_cfg=SimpleNamespace(clip_samples=10, sample_rate=16000),
        _logmel=lambda w: w, audio_model=lambda mel: mel, audio_batch=4, dim=10,
        device=torch.device("cpu"))
    out = P.Clap.audio_embed(ns, np.asarray([[1.0, 2.0, 3.0, 4.0]], np.float32))
    np.testing.assert_array_equal(out[0], [1, 2, 3, 4, 1, 2, 3, 4, 0, 0])
    full = np.arange(10, dtype=np.float32)[None] + 1
    np.testing.assert_array_equal(P.Clap.audio_embed(ns, full)[0], full[0])


def _pann_sd():
    g, trunk = _sd("cnn14_tiny")
    sd = {"audio_branch." + k: v for k, v in trunk.items()}
    rng = np.random.RandomState(0)
    joint = 32
    sd["audio_projection.0.weight"] = rng.randn(joint, 2048).astype(np.float32) * 0.02
    sd["audio_projection.0.bias"] = rng.randn(joint).astype(np.float32) * 0.01
    sd["audio_projection.2.weight"] = rng.randn(joint, joint).astype(np.float32) * 0.05
    sd["audio_projection.2.bias"] = rng.randn(joint).astype(np.float32) * 0.01
    return g, sd, joint


def test_pann_tower_matches_jax_and_swaps_in():
    """The PANN-14 tower: converter bit-equal, the encoder against JAX's and
    against tests/test_pann.py's numpy oracle; `Clap` builds it for a
    PANNAudioConfig."""
    g, sd, joint = _pann_sd()
    jparams = JP.convert_clap_pann(sd)
    ours = PP.convert_clap_pann(sd)
    _assert_same_state(ours, from_jax_params(jparams))
    cfg = PP.PANNAudioConfig(class_num=11, joint_embed_dim=joint)
    model = PP.ClapPannAudioEncoder(cfg)
    model.load_state_dict(ours)
    logmel = g["logmel"][:, 0]
    with torch.no_grad():
        emb = model(torch.from_numpy(logmel)).numpy()
    jemb = JP.ClapPannAudioEncoder(JP.PANNAudioConfig(class_num=11, joint_embed_dim=joint)).apply(
        {"params": jparams}, jnp.asarray(logmel))
    np.testing.assert_allclose(emb, np.asarray(jemb), atol=5e-4, rtol=1e-3)
    h = g["emb"] @ sd["audio_projection.0.weight"].T + sd["audio_projection.0.bias"]
    h = np.maximum(h, 0.0) @ sd["audio_projection.2.weight"].T + sd["audio_projection.2.bias"]
    np.testing.assert_allclose(emb, h / np.linalg.norm(h, axis=-1, keepdims=True),
                               atol=5e-4, rtol=1e-3)
    _, text_sd = _sd("clap_text_tiny")
    clap = P.Clap(P.convert_clap_text(text_sd), ours, roberta_word_hash(120), P_ROBERTA, cfg,
                  device="cpu")
    assert isinstance(clap.audio_model, PP.ClapPannAudioEncoder) and clap.dim == joint


def test_pann_logmel_matches_jax():
    wav = np.random.RandomState(1).randn(2, 48000).astype(np.float32) * 0.1
    ours = PP.pann_logmel(torch.from_numpy(wav)).numpy()
    theirs = np.asarray(JP.pann_logmel(jnp.asarray(wav)))
    assert ours.shape == (2, 1 + 48000 // PP.PANN_14.hop_size, PP.PANN_14.mel_bins)
    np.testing.assert_allclose(ours, theirs, atol=3e-4, rtol=1e-3)
