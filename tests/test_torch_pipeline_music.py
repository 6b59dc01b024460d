"""The port's Mustango pipeline (tango_tpu_torch/pipeline_music.py) against
JAX's on the CPU: the predictor's post-processing, the feature predictor on
tiny beat and chord checkpoints, the snapshot_tiny_mustango dress rehearsal
(weights bit-equal to JAX's loader, the whole path under one injected noise
at the sampler's 1e-4 / 1e-3), and the pipeline's own contracts on tiny
components (batch row 0 equals generate, tail padding, explicit features)."""

import inspect
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu import pipeline_music as jpm
from tango_tpu.models import deberta as jdeberta
from tango_tpu.models import t5 as jt5
from tango_tpu.models.diffusion import AudioDiffusion as JAudioDiffusion
from tango_tpu_torch import configs as TC
from tango_tpu_torch import pipeline_music as pm
from tango_tpu_torch.models.diffusion import AudioDiffusion
from tango_tpu_torch.parallel.mesh import make_mesh
from tango_tpu_torch.tokenizer import WordHashTokenizer, deberta_word_hash
from tango_tpu_torch.utils.convert import from_jax_params

from tests.conftest import GOLDEN, load_golden
from tests.test_deberta import TINY as J_TINY_DEBERTA
from tests.test_pipeline import TINY_HIFI, TINY_T5, TINY_VAE
from tests.test_t5 import TINY_T5GEN

torch.set_num_threads(1)

SNAP = GOLDEN / "snapshot_tiny_mustango"
SHORT_T = 8  # latent frames: the snapshot's UNet at 8 x 16
FEATURES = dict(beats=[[[0.5, 1.0, 1.5], [1.0, 2.0, 3.0]]], chords=["Gm", "F7"],
                chords_times=[0.4, 2.2])
MUSIC_KW = dict(
    in_channels=8, out_channels=8,
    down_block_types=("CrossAttnDownBlock2DMusic", "DownBlock2D"),
    mid_block_type="UNetMidBlock2DCrossAttnMusic",
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2DMusic"),
    block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=16,
    attention_head_dim=(2, 4), norm_num_groups=8,
)


def port_cfg(cls, jcfg):
    return cls.from_dict(jcfg.to_dict())


# ---------------------------------------------------------- post-processing

INTERVALS = {
    "steady": np.full(600, 0.5, np.float32),
    # a negative interval brings the sum back under 10 s after the break
    "negative": np.array([3.0, 4.0, 3.5, -2.0, 0.5, 0.25], np.float32),
    "rounding": np.array([0.33335, 0.33334, 0.12345678, 1.99995] * 10, np.float32),
    "empty": np.array([12.0, 1.0], np.float32),
    "over_50": np.full(80, 0.1, np.float32),
}


@pytest.mark.parametrize("case", list(INTERVALS))
def test_postprocess_beats_matches_jax(case):
    logits = np.array([0.1, 0.2, 3.0, 0.1], np.float32)
    got = pm.MusicFeaturePredictor.postprocess_beats(logits, INTERVALS[case])
    assert got == jpm.MusicFeaturePredictor.postprocess_beats(logits, INTERVALS[case])
    if case == "negative":
        assert got[1] == [3.0, 7.0]
    prompt = pm.MusicFeaturePredictor.chords_prompt("a tune", got[1], got[0])
    assert prompt == jpm.MusicFeaturePredictor.chords_prompt("a tune", got[1], got[0])


@pytest.mark.parametrize("decoded", [
    "Gm at 0.46 n Eb at 1.39 n F7 at 3.16", "Gm at 0.5 n garbage n C at x n D at 2.0",
    "Gm at 1.0 at 2.0 n C at 3.0", "", "N at 0.0", " Bbm7/F at -1.5 n A at 1e1"])
def test_parse_chords_matches_jax(decoded):
    assert (pm.MusicFeaturePredictor.parse_chords(decoded)
            == jpm.MusicFeaturePredictor.parse_chords(decoded))


def test_stub_predictor_generate_matches_jax():
    def beats_fn(prompt):
        return np.array([0.1, 0.2, 3.0, 0.1]), np.full(600, 0.5, np.float32)

    def chords_fn(cprompt):
        assert "Caption:" in cprompt and "Max Beat: 3" in cprompt
        return "Gm at 0.46 n Eb at 1.39 n F7 at 3.16"

    got = pm.MusicFeaturePredictor(beats_fn=beats_fn, chords_fn=chords_fn).generate("jazz")
    assert got == jpm.MusicFeaturePredictor(beats_fn=beats_fn, chords_fn=chords_fn).generate(
        "jazz")
    with pytest.raises(RuntimeError, match="No music predictors"):
        pm.MusicFeaturePredictor().generate("jazz")


# -------------------------------------------------- the feature predictor

CHORD_NAMES = ["C", "Gm", "Eb", "F7", "Bbmaj7", "D/F#", "Am7b5"]


class ChordTokenizer(WordHashTokenizer):
    """A word hash whose decode reads each id as a "<chord> at <time>" item,
    so the beam search's tokens become chords that parse_chords reads."""

    def decode(self, ids, skip_special_tokens=True, clean_up_tokenization_spaces=True):
        return " n ".join(f"{CHORD_NAMES[int(i) % 7]} at {int(i) % 5 * 0.5}" for i in ids
                          if int(i) > 1)


def test_feature_predictor_loads_checkpoints_and_matches_jax(tmp_path):
    """MusicFeaturePredictor(path) on beats/ and chords/ checkpoints of the
    goldens' tiny DeBERTa and T5 against JAX's predictor whose beats_fn and
    chords_fn run JAX's models on the same tokenization."""
    dg, tg = load_golden("deberta_tiny"), load_golden("t5gen_tiny")
    beats_sd = {k[4:]: dg[k] for k in dg.files if k.startswith("sd::")}
    chords_sd = {k[4:]: tg[k] for k in tg.files if k.startswith("sd::")}
    for sub, name, sd in (("beats", "microsoft-deberta-v3-large.pt", beats_sd),
                          ("chords", "flan-t5-large.bin", chords_sd)):
        os.makedirs(tmp_path / sub)
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   tmp_path / sub / name)
    btok, ctok = deberta_word_hash(96), ChordTokenizer(64)
    port = pm.MusicFeaturePredictor(
        str(tmp_path), device="cpu", beats_tokenizer=btok, chords_tokenizer=ctok,
        beats_config=port_cfg(TC.DebertaConfig, J_TINY_DEBERTA),
        chords_config=port_cfg(TC.T5Config, TINY_T5GEN))

    jbeats = jdeberta.DebertaV2ForBeats(J_TINY_DEBERTA)
    jbp = jdeberta.convert_deberta_beats(beats_sd)
    jchords = jt5.T5Seq2Seq(TINY_T5GEN)
    jcp = jt5.convert_t5_seq2seq(chords_sd)

    def tok(t, text):
        return t([text], max_length=pm.PREDICTOR_MAX_LENGTH, padding="max_length",
                 truncation=True, return_tensors="np")

    def beats_fn(prompt):
        b = tok(btok, prompt)
        logits, values = jax.jit(jbeats.apply)({"params": jbp}, jnp.asarray(b["input_ids"]),
                                               jnp.asarray(b["attention_mask"]))
        n = int(b["attention_mask"][0].sum())
        return np.asarray(logits)[0, 0], np.asarray(values)[0, :n, 0]

    def chords_fn(cprompt):
        c = tok(ctok, cprompt)
        out = jchords.generate(jcp, c["input_ids"], c["attention_mask"], num_beams=5,
                               min_length=8, max_length=128, early_stopping=True,
                               device_loop=False)
        return ctok.decode(out)

    jax_pred = jpm.MusicFeaturePredictor(beats_fn=beats_fn, chords_fn=chords_fn)
    prompt = "rock guitar riff with drums"  # the tiny T5 answers it with varied tokens
    p_logits, p_values = port._beats_fn(prompt)
    j_logits, j_values = beats_fn(prompt)
    np.testing.assert_allclose(p_logits, j_logits, atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(p_values, j_values, atol=3e-4, rtol=1e-3)
    beats, chords, times = port.generate(prompt)
    assert (beats, chords, times) == jax_pred.generate(prompt)
    assert beats[0][0] and chords, (beats, chords)


def test_feature_predictor_fallback_tokenizers_warn(tmp_path):
    dg, tg = load_golden("deberta_tiny"), load_golden("t5gen_tiny")
    for sub, name, g in (("beats", "microsoft-deberta-v3-large.pt", dg),
                         ("chords", "flan-t5-large.bin", tg)):
        os.makedirs(tmp_path / sub)
        torch.save({k[4:]: torch.from_numpy(np.array(g[k])) for k in g.files
                    if k.startswith("sd::")}, tmp_path / sub / name)
    with pytest.warns(UserWarning, match="word-hash") as caught:
        pred = pm.MusicFeaturePredictor(str(tmp_path), device="cpu",
                                        beats_config=port_cfg(TC.DebertaConfig, J_TINY_DEBERTA))
    assert len(caught) == 2
    assert pred.beats_tokenizer.bos_id == 1 and pred.beats_tokenizer.eos_id == 2
    assert pred.chords_model.cfg.vocab_size == 64 and not pred.chords_model.cfg.tie_word_embeddings


# ---------------------------------------------------------- the snapshot

@pytest.fixture(scope="module")
def loaded_pair():
    with pytest.warns(UserWarning, match="FLAN-T5"):
        port = pm.Mustango(str(SNAP), device="cpu")
    jax_m = jpm.Mustango(str(SNAP), tokenizer=port.tokenizer)
    return port, jax_m


def test_snapshot_weights_match_jax_loader(loaded_pair):
    port, jm = loaded_pair
    assert port.predictor is None and jm.predictor is None
    assert port.t5.cfg.d_model == 32 and port.vocoder.cfg.num_mels == 32
    assert port.model.unet_config.in_channels == 4
    assert port.model.unet_config == TC.UNetConfig.from_dict(jm.model.unet_config.to_dict())
    for module, tree, skip in ((port.model.unet, jm.unet_params, ()),
                               (port.model.conditioner, jm.conditioner_params, ()),
                               (port.t5, jm.t5_params, ()),
                               (port.vae, jm.vae_params, ("encoder", "quant_conv")),
                               (port.vocoder, jm.hifigan_params, ())):
        want = from_jax_params(jax.device_get(tree), skip=skip)
        got = module.state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want), type(module).__name__


def test_snapshot_generate_matches_jax(loaded_pair):
    """The whole path, prompt to int16 waveform, with the sampler's initial
    latents and step noises injected in both packages."""
    port, jm = loaded_pair
    steps = 2
    shape = (1, SHORT_T, port.model.latent_f_size, port.model.unet_config.in_channels)
    rng = np.random.RandomState(0)
    init = rng.randn(*shape).astype(np.float32)
    noises = rng.randn(steps, *shape).astype(np.float32)
    lat = {}

    def inject(model, base, side):
        def sample(*a, **k):
            out = base.sample(model, *a, **{**k, "noise_override": (init, noises)})
            if side == "jax":  # inside JAX's jitted program: read it back by a callback
                jax.debug.callback(lambda x: lat.__setitem__(side, np.asarray(x)), out)
            else:
                lat[side] = out.numpy()
            return out
        return sample

    jm.model.latent_t_size = SHORT_T
    jm.model.sample = inject(jm.model, JAudioDiffusion, "jax")
    port.model.latent_t_size = SHORT_T
    port.model.sample = inject(port.model, AudioDiffusion, "port")
    try:
        want = jm.generate("a jazzy tune", steps=steps, guidance=3.0, seed=0, **FEATURES)
        got = port.generate("a jazzy tune", steps=steps, guidance=3.0, seed=0, **FEATURES)
    finally:
        del port.model.sample
        port.model.latent_t_size = 256
    np.testing.assert_allclose(lat["port"], lat["jax"], atol=1e-4, rtol=1e-3)
    assert got.dtype == np.int16 and got.shape == want.shape and np.abs(got).max() > 0
    # f32 rounding moves an int16 sample by a step at most
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2


def test_snapshot_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        pm.Mustango("declare-lab/mustango", device="cpu")
    # the mesh is ported (tests/test_torch_parallel.py runs it on two ranks);
    # a one-process mesh is taken as it is
    mesh = make_mesh(device="cpu")
    assert pm.Mustango(None, device="cpu", mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="quant must be"):
        pm.Mustango(None, device="cpu", quant="int8")
    # a predictor checkpoint that is there but does not load raises
    snap = tmp_path / "snap"
    shutil.copytree(SNAP, snap)
    for sub, name in (("beats", "microsoft-deberta-v3-large.pt"), ("chords", "flan-t5-large.bin")):
        os.makedirs(snap / sub)
        (snap / sub / name).write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        pm.Mustango(str(snap), device="cpu", tokenizer=WordHashTokenizer(64))


# ------------------------------------------------------- tiny components

def stub_predictor():
    def beats_fn(prompt):
        return np.array([0.1, 0.2, 3.0, 0.1]), np.full(600, 0.5, np.float32)

    def chords_fn(cprompt):
        return "Gm at 0.46 n Eb at 1.39 n F7 at 3.16"

    return pm.MusicFeaturePredictor(beats_fn=beats_fn, chords_fn=chords_fn)


@pytest.fixture(scope="module")
def tiny():
    return pm.Mustango.from_components(
        unet_config=TC.UNetConfig(**MUSIC_KW), vae_config=port_cfg(TC.VAEConfig, TINY_VAE),
        t5_config=port_cfg(TC.T5Config, TINY_T5), hifigan_config=port_cfg(TC.HiFiGANConfig,
                                                                          TINY_HIFI),
        predictor=stub_predictor(), latent_t_size=8, latent_f_size=4, device="cpu")


WAV_LEN = 16 * 160 + 32


def test_generate_and_batch_row_zero(tiny):
    single = tiny.generate("an upbeat jazz piece", steps=2, guidance=3.0, seed=1)
    assert single.dtype == np.int16 and single.shape == (WAV_LEN,) and np.abs(single).max() > 0
    batch = tiny.generate_for_batch(["an upbeat jazz piece", "slow sad piano"], steps=2,
                                    guidance=3.0, batch_size=2, seed=1)
    assert len(batch) == 2
    # int16 scale; batched and unbatched CPU matmuls may differ in the last bits
    np.testing.assert_allclose(batch[0].astype(np.float32), single.astype(np.float32), atol=2.0)
    assert np.abs(batch[1].astype(np.int32) - batch[0].astype(np.int32)).max() > 0


def test_tail_chunk_pads_to_full_batch(tiny, monkeypatch):
    shapes = []
    real = tiny.sample_latents

    def spy(prompts, *a, **kw):
        shapes.append(len(prompts))
        return real(prompts, *a, **kw)

    monkeypatch.setattr(tiny, "sample_latents", spy)
    wavs = tiny.generate_for_batch(["a", "b", "c"], steps=2, batch_size=2, seed=0)
    assert len(wavs) == 3 and all(w.shape == (WAV_LEN,) for w in wavs)
    assert shapes == [2, 2]
    monkeypatch.setattr(tiny, "sample_latents", real)
    alone = tiny.generate_for_batch(["c"], steps=2, batch_size=2, seed=0)
    assert alone[0].shape == (WAV_LEN,)


def test_explicit_features_skip_the_predictor(tiny, monkeypatch):
    monkeypatch.setattr(tiny, "predictor", None)
    beats = [[[0.5, 1.0], [1.0, 2.0]]]
    wavs = tiny.generate_for_batch(["x", "y"], steps=2, batch_size=2, seed=0,
                                   beats=[beats, [[], []]], chords=[["Gm"], []],
                                   chords_times=[[0.4], []])
    assert len(wavs) == 2
    one = tiny.generate("x", steps=2, seed=0, beats=beats, chords=["Gm"], chords_times=[0.4])
    np.testing.assert_allclose(one.astype(np.float32), wavs[0].astype(np.float32), atol=2.0)
    with pytest.raises(AssertionError, match="no music predictor"):
        tiny.generate("x", steps=2)
    with pytest.raises(ValueError, match="passed together"):
        tiny.generate_for_batch(["x"], steps=2, beats=[beats])


def test_predictor_features_reach_the_sampler(tiny, monkeypatch):
    """generate without features runs the predictor once and tokenizes its
    beats and chords; generate_for_batch runs it once per distinct prompt."""
    seen, calls = [], []
    real_encode, real_gen = tiny.model.encode_music, tiny.predictor.generate
    monkeypatch.setattr(tiny.model, "encode_music",
                        lambda *a, **k: seen.append(a) or real_encode(*a, **k))
    monkeypatch.setattr(tiny.predictor, "generate", lambda p: calls.append(p) or real_gen(p))
    tiny.generate("jazz", steps=1, seed=0)
    beats, chords, times = seen[0]
    assert beats[0][0][:3] == [0.5, 1.0, 1.5] and beats[0][1][:4] == [1.0, 2.0, 3.0, 1.0]
    assert chords == [["Gm", "Eb", "F7"]] and times == [[0.46, 1.39, 3.16]]
    tiny.generate_for_batch(["a", "b", "a"], steps=1, batch_size=4, seed=0)
    assert calls == ["jazz", "a", "b"]


def test_quantized_pipeline_builds_int8(tiny):
    from tango_tpu_torch.ops.quant import QConv2d

    q = pm.Mustango.from_components(
        unet_config=TC.UNetConfig(**MUSIC_KW), vae_config=port_cfg(TC.VAEConfig, TINY_VAE),
        unet_params=tiny.model.unet.state_dict(), vae_params=tiny.vae.state_dict(),
        conditioner_params=tiny.model.conditioner.state_dict(),
        t5_config=port_cfg(TC.T5Config, TINY_T5), t5_params=tiny.t5.state_dict(),
        hifigan_config=port_cfg(TC.HiFiGANConfig, TINY_HIFI),
        hifigan_params=tiny.vocoder.state_dict(), predictor=stub_predictor(), latent_t_size=8,
        latent_f_size=4, device="cpu", quant="conv")
    assert q.model.unet.cfg.quant_int8 and q.model.unet.cfg.quant_scope == "conv"
    assert isinstance(q.model.unet.down_blocks_0.resnets_0.conv1, QConv2d)
    wav = q.generate("jazz", steps=1, seed=0)
    assert wav.shape == (WAV_LEN,) and np.abs(wav).max() > 0


# ----------------------------------------------------------- signatures

PORT_ONLY = {"device", "init_seed"}


@pytest.mark.parametrize("method", ["__init__", "from_components", "generate",
                                    "generate_for_batch"])
def test_signature_matches_jax(method):
    """JAX's parameters by name, order, kind and default; the port's own
    (`device`, `init_seed`) last, and from_components' params default to
    None (seeded random weights) where JAX requires them."""
    def params(cls):
        fn = getattr(cls, method)
        ps = list(inspect.signature(fn).parameters.values())[1:]
        return [p for p in ps if p.name not in PORT_ONLY]

    got, want = params(pm.Mustango), params(jpm.Mustango)
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        assert g.kind == w.kind, g.name
        if not (method == "from_components" and w.default is inspect.Parameter.empty):
            assert g.default == w.default, g.name
    names = list(inspect.signature(getattr(pm.Mustango, method)).parameters)
    assert [n for n in names if n in PORT_ONLY] == names[len(names) - len(
        [n for n in names if n in PORT_ONLY]):]
