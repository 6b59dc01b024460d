"""Tango 2's inference CLI in the port (tango_tpu_torch/inference_tango2.py)
and the batch CLI's CLAP re-ranking (tango_tpu_torch/inference.py) on the
reference-format tiny snapshot, on the CPU through --device cpu, with a
tiny LAION-format CLAP checkpoint written from the goldens (load_clap's
geometry cut to the goldens' towers) and, for the evaluation, seeded random
full-width Cnn14 and VGGish checkpoints. JAX's CLIs run on the same
generated waveforms (their Tango a stand-in that returns the port's) with
JAX's CLAP on the same tiny weights: the records' keys, the CLAP scores,
the metrics and the re-ranked choice are compared."""

import json
import os
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import tango_tpu.inference_tango2 as jtango2
import tango_tpu.pipeline as jpipeline
import tango_tpu_torch.pipeline as pipeline_mod
from tango_tpu import inference as jinference
from tango_tpu.models import clap as JC
from tango_tpu.models import htsat as JH
from tango_tpu_torch import inference, inference_tango2
from tango_tpu_torch.audio.wav import read_wav, write_wav
from tango_tpu_torch.eval import evaluator
from tango_tpu_torch.tokenizer import WordHashTokenizer, roberta_word_hash

from tests._torch_helpers import tiny_clap_geometry, write_extractor_ckpts, write_tiny_clap
from tests.conftest import GOLDEN
from tests.test_clap import TINY_ROBERTA
from tests.test_htsat import TINY_HTSAT

torch.set_num_threads(1)

SNAP = str(GOLDEN / "snapshot_tiny")
SHORT_T = 8
# 50 latent frames: 16032 samples, one VGGish example (96 frames need 15600)
LONG_T = 50
PROMPTS = ["a dog barks", "rain falls", "a car horn"]


@pytest.fixture(scope="module")
def clap_pt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clap") / "clap.pt")
    return path, write_tiny_clap(path)


@pytest.fixture(scope="module")
def extractors(tmp_path_factory):
    return write_extractor_ckpts(str(tmp_path_factory.mktemp("extractors")))


@pytest.fixture
def built(monkeypatch, tmp_path):
    """Every Tango the CLIs build: the real one from the snapshot, its
    latents cut to `frames[0]` frames, and the groups generate_for_batch
    returned. Runs in tmp_path (summary.jsonl); CLAP's geometry tiny."""
    made, frames, outputs = [], [SHORT_T], []
    real = pipeline_mod.Tango

    def short(name_or_path, tokenizer=None, **kw):
        t = real(name_or_path, tokenizer=tokenizer or WordHashTokenizer(128), **kw)
        t.model.latent_t_size = frames[0]
        gen = t.generate_for_batch
        t.generate_for_batch = lambda prompts, **k: outputs.append(gen(prompts, **k)) or outputs[-1]
        made.append((name_or_path, kw, t))
        return t

    monkeypatch.setattr(pipeline_mod, "Tango", short)
    monkeypatch.chdir(tmp_path)
    tiny_clap_geometry(monkeypatch)
    return types.SimpleNamespace(made=made, frames=frames, outputs=outputs)


def manifest(tmp_path, captions):
    path = tmp_path / "test.json"
    path.write_text("\n".join(json.dumps({"dataset": "t", "location": f"x{i}.wav",
                                          "captions": c}) for i, c in enumerate(captions)))
    return str(path)


def references(tmp_path, n, samples):
    """n ground-truth WAVs named as the outputs (the pairing gate)."""
    ref = tmp_path / "refs"
    ref.mkdir()
    rng = np.random.RandomState(0)
    t = np.arange(samples) / 16000.0
    for i in range(n):
        wav = 0.3 * np.sin(2 * np.pi * (200 + 150 * i) * t) + 0.02 * rng.randn(samples)
        write_wav(str(ref / f"output_{i}.wav"), wav.astype(np.float32))
    return str(ref)


def jax_clap(sd):
    """JAX's Clap on the same tiny weights and tokenizer."""
    return JC.Clap(JC.convert_clap_text(sd), JH.convert_clap_audio(sd, TINY_HTSAT),
                   roberta_word_hash(TINY_ROBERTA.vocab_size), TINY_ROBERTA, TINY_HTSAT)


def jax_tango_returning(outputs):
    """A stand-in for JAX's Tango that returns the port's generated groups."""
    class Stub:
        def __init__(self, name_or_path, **kw):
            pass

        def generate_for_batch(self, prompts, **kw):
            return outputs[-1]
    return Stub


def run2(tmp_path, *extra, **kw):
    out_dir = str(tmp_path / "gen")
    return out_dir, inference_tango2.main(
        ["--model", SNAP, "--test_file", manifest(tmp_path, PROMPTS), "--output_dir", out_dir,
         "--num_steps", "2", "--batch_size", "2", "--device", "cpu", *extra], **kw)


def test_cli_record_matches_jax(tmp_path, built, clap_pt, monkeypatch):
    """--clap_ckpt and --reference_dir (no extractors): output_{i}.wav, the
    record's keys, the CLAP score and the paired metrics as JAX's CLI gives
    them on the same waveforms; the CLAP fallback tokenizer warns."""
    path, sd = clap_pt
    ref = references(tmp_path, 3, 9000)
    with pytest.warns(UserWarning, match="RoBERTa"):
        out_dir, rec = run2(tmp_path, "--clap_ckpt", path, "--reference_dir", ref)
    (name, kw, _), = built.made
    assert name == SNAP and kw["device"] == "cpu"
    waves = [read_wav(os.path.join(out_dir, f"output_{i}.wav"))[0] for i in range(3)]
    assert all(w.shape == (2 * SHORT_T * 160 + 32,) and np.abs(w).max() > 0 for w in waves)
    assert -1.0 <= rec["clap_score"] <= 1.0
    # 2592 samples are too short for LSD's 2048-sample frames past its
    # 1120-sample offset: -1, as in JAX
    assert rec["metrics"]["psnr"] > 0 and rec["metrics"]["lsd"] == -1

    monkeypatch.setattr(jpipeline, "Tango", jax_tango_returning(built.outputs))
    monkeypatch.setattr(jtango2, "load_clap", lambda p: jax_clap(sd))
    jout = str(tmp_path / "jgen")
    jtango2.main(["--model", SNAP, "--test_file", str(tmp_path / "test.json"), "--output_dir",
                  jout, "--num_steps", "2", "--batch_size", "2", "--clap_ckpt", path,
                  "--reference_dir", ref])
    ours, theirs = [json.loads(line) for line in (tmp_path / "summary.jsonl").read_text()
                    .splitlines()]
    assert json.dumps(ours) == json.dumps(rec) and set(ours) == set(theirs)
    assert abs(ours["clap_score"] - theirs["clap_score"]) <= 2e-4 + 1e-4  # both rounded to 1e-4
    assert set(ours["metrics"]) == set(theirs["metrics"])
    for k, v in ours["metrics"].items():
        assert (np.isnan(v) and np.isnan(theirs["metrics"][k])) or v == theirs["metrics"][k], k
    for i in range(3):
        with open(os.path.join(out_dir, f"output_{i}.wav"), "rb") as a, \
                open(os.path.join(jout, f"output_{i}.wav"), "rb") as b:
            assert a.read() == b.read()


def test_cli_all_scorers(tmp_path, built, clap_pt, extractors, monkeypatch):
    """Every scorer at once, as the card runs it: the CLAP score with the
    caller's tokenizer, and FD, FAD, KL, KID, LSD, PSNR and SSIM from Cnn14
    and VGGish (IS needs 10 clips for its 10 splits: NaN here, as in JAX)."""
    built.frames[0] = LONG_T
    monkeypatch.setattr(evaluator.EvaluationHelper, "batch_size", 3)
    cnn14, vggish = extractors
    ref = references(tmp_path, 3, 20000)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)  # no fallback: the tokenizers are given
        _, rec = run2(tmp_path, "--clap_ckpt", clap_pt[0], "--reference_dir", ref,
                      "--cnn14_ckpt", cnn14, "--vggish_ckpt", vggish,
                      tokenizer=WordHashTokenizer(128),
                      clap_tokenizer=roberta_word_hash(TINY_ROBERTA.vocab_size))
    m = rec["metrics"]
    for k in ("frechet_distance", "frechet_audio_distance", "kl_sigmoid", "kl_softmax",
              "kid_mean", "lsd", "psnr", "ssim", "ssim_stft"):
        assert np.isfinite(m[k]), (k, m[k])
    assert np.isnan(m["is_mean"])
    assert set(rec) == {"model", "num_prompts", "num_steps", "gen_time_s", "x_realtime",
                        "output_dir", "clap_score", "metrics"}


def test_cli_with_tracking(tmp_path, built, clap_pt, monkeypatch):
    logged = []
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: types.SimpleNamespace(log=logged.append, finish=lambda: None)
    monkeypatch.setitem(sys.modules, "wandb", fake)
    with pytest.warns(UserWarning):
        _, rec = run2(tmp_path, "--clap_ckpt", clap_pt[0], "--with_tracking")
    (wb,) = logged
    assert (wb["Steps"], wb["Guidance Scale"], wb["Test Instances"]) == (2, 3.0, 3)
    assert wb["clap_score"] == rec["clap_score"] and "metrics" not in rec


def test_load_clap_strips_module_prefix(clap_pt, monkeypatch):
    tiny_clap_geometry(monkeypatch)
    path, sd = clap_pt
    with pytest.warns(UserWarning, match="RoBERTa"):
        clap = inference_tango2.load_clap(path, device="cpu")
    assert clap.text.tokenizer.bos_id == 0 and clap.text.tokenizer.pad_id == 1
    got = clap.audio_model.state_dict()
    assert torch.equal(got["proj_0.weight"], sd["audio_projection.0.weight"])
    assert torch.equal(got["htsat.bn0.var"], sd["audio_branch.bn0.running_var"])


def test_rerank_picks_clap_argmax_as_jax(tmp_path, built, clap_pt, monkeypatch):
    """`inference --num_samples 2 --clap_ckpt`: each output_{i}.wav is its
    prompt's sample with the highest CLAP similarity, recomputed here, and
    JAX's CLI picks the same sample from the same groups."""
    path, sd = clap_pt
    out_dir = str(tmp_path / "gen")
    inference.main(["--model", SNAP, "--test_file", manifest(tmp_path, PROMPTS), "--output_dir",
                    out_dir, "--num_steps", "2", "--batch_size", "2", "--num_samples", "2",
                    "--device", "cpu", "--clap_ckpt", path],
                   clap_tokenizer=roberta_word_hash(TINY_ROBERTA.vocab_size))
    groups = built.outputs[-1]
    assert len(groups) == 3 and all(len(g) == 2 for g in groups)
    clap = inference_tango2.load_clap(path, roberta_word_hash(TINY_ROBERTA.vocab_size), "cpu")
    picks = []
    for i, (prompt, group) in enumerate(zip(PROMPTS, groups)):
        sims = clap.similarity(np.stack([g.astype(np.float32) / 32768.0 for g in group]), prompt)
        picks.append(int(np.argmax(sims)))
        wav, _ = read_wav(os.path.join(out_dir, f"output_{i}.wav"))
        np.testing.assert_array_equal(np.round(wav * 32768).astype(np.int16), group[picks[-1]])
    assert any(not np.array_equal(g[0], g[1]) for g in groups)

    monkeypatch.setattr(jpipeline, "Tango", jax_tango_returning(built.outputs))
    monkeypatch.setattr(jtango2, "load_clap", lambda p: jax_clap(sd))
    jout = str(tmp_path / "jgen")
    jinference.main(["--model", SNAP, "--test_file", str(tmp_path / "test.json"),
                     "--output_dir", jout, "--num_steps", "2", "--batch_size", "2",
                     "--num_samples", "2", "--clap_ckpt", path])
    for i in range(3):
        jwav, _ = read_wav(os.path.join(jout, f"output_{i}.wav"))
        np.testing.assert_array_equal(np.round(jwav * 32768).astype(np.int16),
                                      groups[i][picks[i]])


def test_default_device_without_cuda_raises(tmp_path, clap_pt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny_clap_geometry(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference_tango2.load_clap(clap_pt[0], roberta_word_hash(120))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference_tango2.main(["--model", SNAP, "--test_file", manifest(tmp_path, ["x"]),
                               "--output_dir", str(tmp_path / "g")])
