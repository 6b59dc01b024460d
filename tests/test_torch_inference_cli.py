"""The port's batch-generation CLI (tango_tpu_torch/inference.py) on the
reference-format tiny snapshot, as tests/test_inference_cli.py drives JAX's:
manifest -> `Tango(--model)` -> generate_for_batch -> output_{i}.wav ->
one summary.jsonl record. On the CPU through --device cpu; the pipeline's
latents are cut to 8 frames to keep each run to about a second."""

import json
import os
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import tango_tpu_torch.pipeline as pipeline_mod
from tango_tpu_torch import inference
from tango_tpu_torch.audio.wav import read_wav, write_wav
from tango_tpu_torch.eval import evaluator
from tango_tpu_torch.tokenizer import WordHashTokenizer

from tests._torch_helpers import tiny_clap_geometry, write_tiny_clap
from tests.conftest import GOLDEN

torch.set_num_threads(1)

SNAP = str(GOLDEN / "snapshot_tiny")
SHORT_T = 8
WAV_LEN = 2 * SHORT_T * 160 + 32  # the tiny VAE doubles T; HiFi-GAN x160, +32 edge


@pytest.fixture
def built(monkeypatch, tmp_path):
    """Every Tango the CLI builds: the real one from the snapshot, its
    latents cut to SHORT_T frames. Runs in tmp_path (summary.jsonl)."""
    made = []
    real = pipeline_mod.Tango

    def short(name_or_path, **kw):
        t = real(name_or_path, tokenizer=WordHashTokenizer(128), **kw)
        t.model.latent_t_size = SHORT_T
        made.append((name_or_path, kw, t))
        return t

    monkeypatch.setattr(pipeline_mod, "Tango", short)
    monkeypatch.chdir(tmp_path)
    return made


def manifest(tmp_path, captions, key="captions"):
    path = tmp_path / "test.json"
    path.write_text("\n".join(json.dumps({"dataset": "t", "location": f"x{i}.wav", key: c})
                              for i, c in enumerate(captions)))
    return str(path)


def run(tmp_path, test_file, *extra):
    out_dir = str(tmp_path / "gen")
    return out_dir, inference.main(["--model", SNAP, "--test_file", test_file,
                                    "--output_dir", out_dir, "--num_steps", "2",
                                    "--batch_size", "2", "--device", "cpu", *extra])


def test_cli_end_to_end(tmp_path, built):
    test_file = manifest(tmp_path, ["a dog barks", "rain falls", "a car horn"])
    out_dir, _ = run(tmp_path, test_file)
    (name, kw, _), = built
    assert name == SNAP and kw["device"] == "cpu" and kw["unet_ckpt"] is None
    for i in range(3):
        wav, sr = read_wav(os.path.join(out_dir, f"output_{i}.wav"))
        assert sr == 16000 and wav.shape == (WAV_LEN,) and np.abs(wav).max() > 0
    rec = json.loads((tmp_path / "summary.jsonl").read_text().splitlines()[-1])
    assert rec["num_prompts"] == 3
    assert rec["num_steps"] == 2
    assert rec["x_realtime"] > 0
    assert rec["output_dir"] == out_dir


def test_cli_num_test_instances(tmp_path, built):
    test_file = manifest(tmp_path, [f"prompt {i}" for i in range(4)])
    out_dir, rec = run(tmp_path, test_file, "--num_test_instances", "2")
    assert os.path.exists(os.path.join(out_dir, "output_1.wav"))
    assert not os.path.exists(os.path.join(out_dir, "output_2.wav"))
    assert rec["num_prompts"] == 2


def test_cli_text_key(tmp_path, built, monkeypatch):
    test_file = manifest(tmp_path, ["music 0", "music 1"], key="main_caption")
    seen = []
    orig = pipeline_mod.Tango

    def spy(*a, **kw):
        t = orig(*a, **kw)
        gen = t.generate_for_batch
        t.generate_for_batch = lambda prompts, **k: seen.append(list(prompts)) or gen(prompts, **k)
        return t

    monkeypatch.setattr(pipeline_mod, "Tango", spy)
    run(tmp_path, test_file, "--text_key", "main_caption")
    assert seen == [["music 0", "music 1"]]
    with pytest.raises(KeyError):
        run(tmp_path, test_file, "--text_key", "no_such_column")


def test_cli_unet_ckpt_and_samples(tmp_path, built):
    from tango_tpu_torch.utils.checkpoint import load_main_weights, save_native

    params = load_main_weights(SNAP)["unet_params"]
    save_native(str(tmp_path / "best"), {k: v * 1.05 for k, v in params.items()})
    test_file = manifest(tmp_path, ["a dog barks"])
    out_dir, _ = run(tmp_path, test_file, "--unet_ckpt", str(tmp_path / "best"),
                     "--num_samples", "2", "--seed", "0")
    assert built[0][1]["unet_ckpt"] == str(tmp_path / "best")
    wav, _ = read_wav(os.path.join(out_dir, "output_0.wav"))
    assert wav.shape == (WAV_LEN,)


def test_cli_with_tracking(tmp_path, built, monkeypatch):
    """wandb absent: stdout, summary written; a stand-in wandb gets the
    reference's run metadata."""
    test_file = manifest(tmp_path, ["p 0", "p 1"])
    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    run(tmp_path, test_file, "--with_tracking")
    assert json.loads((tmp_path / "summary.jsonl").read_text().splitlines()[-1])[
        "num_prompts"] == 2
    logged, finished = [], []
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: types.SimpleNamespace(log=logged.append,
                                                   finish=lambda: finished.append(True))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    run(tmp_path, test_file, "--with_tracking")
    (wb,) = logged
    assert finished == [True]
    assert (wb["Steps"], wb["Guidance Scale"], wb["Test Instances"]) == (2, 3.0, 2)
    assert wb["x_realtime"] > 0


@pytest.mark.parametrize("flag,queue", [("--reference_dir", "#9"), ("--cnn14_ckpt", "#9"),
                                        ("--vggish_ckpt", "#9"), ("--clap_ckpt", "#6")])
def test_cli_eval_flags_raise(tmp_path, built, flag, queue, monkeypatch):
    """Each evaluation / CLAP flag, once refused (ROADMAP queue A `queue`),
    now runs: --reference_dir scores the outputs (the paired metrics; no
    extractor checkpoint, so Cnn14's and VGGish's metrics are NaN), the
    checkpoint flags reach EvaluationHelper with it, and --clap_ckpt re-ranks
    --num_samples 2 by CLAP (a tiny checkpoint from the goldens)."""
    test_file = manifest(tmp_path, ["a dog barks", "rain falls"])
    ref = tmp_path / "refs"
    ref.mkdir()
    for i in range(2):
        write_wav(str(ref / f"output_{i}.wav"),
                  0.3 * np.sin(np.arange(9000, dtype=np.float32) * (0.05 + 0.01 * i)))
    helpers = []

    class Spy(evaluator.EvaluationHelper):
        def __init__(self, *a, **kw):
            helpers.append(kw)
            super().__init__(*a, **kw)

    monkeypatch.setattr(evaluator, "EvaluationHelper", Spy)
    if flag == "--clap_ckpt":
        tiny_clap_geometry(monkeypatch)
        write_tiny_clap(str(tmp_path / "clap.pt"))
        extra = [flag, str(tmp_path / "clap.pt"), "--num_samples", "2"]
    elif flag == "--reference_dir":
        extra = [flag, str(ref)]
    else:
        extra = ["--reference_dir", str(ref), flag, str(tmp_path / "absent.pth")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the default CLAP tokenizer's
        out_dir, rec = run(tmp_path, test_file, *extra)
    assert built and all(os.path.exists(os.path.join(out_dir, f"output_{i}.wav"))
                         for i in range(2))
    if flag == "--clap_ckpt":
        assert "metrics" not in rec and not helpers
        return
    (kw,) = helpers
    assert kw["device"] == "cpu" and kw.get(flag[2:]) in (None, extra[-1])
    assert rec["metrics"]["psnr"] > 0 and np.isnan(rec["metrics"]["frechet_distance"])


def test_cli_default_device_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.main(["--model", SNAP, "--test_file", manifest(tmp_path, ["x"]),
                        "--output_dir", str(tmp_path / "g")])
