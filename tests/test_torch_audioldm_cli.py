"""The port's AudioLDM CLI (tango_tpu_torch/audioldm/cli.py) and model
registry (tango_tpu_torch/registry.py) on the CPU, after JAX's CLI tests
(tests/test_audioldm.py): the flags against JAX's `parse_args`; transfer
without -f exits before loading; --model_name resolves through the registry;
one run on the tiny monolithic checkpoint writes its WAVs; the registry's
entries, its local path, and its refusals. No test downloads anything: the
registry's fetch is replaced where it would run."""

import os
import urllib.request

import numpy as np
import pytest
import torch

from tango_tpu import registry as jregistry
from tango_tpu.audioldm import cli as jcli
from tango_tpu_torch import configs as TC
from tango_tpu_torch import registry
from tango_tpu_torch.audioldm import cli
from tango_tpu_torch.audioldm import pipeline as pl
from tango_tpu_torch.audio.wav import read_wav
from tango_tpu_torch.models import audioldm_unet as film

from tests._torch_helpers import tiny_clap_configs
from tests.test_torch_audioldm import (
    GOLDEN_FILM,
    GOLDEN_HIFI,
    GOLDEN_VAE,
    ClippedTok,
    _tiny_monolithic_ckpt,
)

torch.set_num_threads(1)

ARGV = ["--mode", "transfer", "-t", "x", "-tl", "p.txt", "-f", "a.wav", "--transfer_strength",
        "0.3", "-ckpt", "c.ckpt", "--model_name", "audioldm-m-full", "-s", "out", "-dur", "5",
        "-gs", "3.5", "-n", "2", "--ddim_steps", "20", "-b", "2", "--seed", "7"]


@pytest.mark.parametrize("argv", [[], ARGV], ids=["defaults", "set"])
def test_parse_args_matches_jax(argv):
    want = vars(jcli.parse_args(argv))
    got = vars(cli.parse_args(argv))
    assert set(got) - set(want) == {"device"} and got["device"] is None
    assert {k: got[k] for k in want} == want


def test_cli_transfer_requires_file_path(tmp_path):
    for mode in ("transfer", "inpainting"):
        with pytest.raises(SystemExit, match="requires a source audio"):
            cli.main(["--mode", mode, "-t", "x", "--ckpt", str(tmp_path / "nope.ckpt"),
                      "--save_path", str(tmp_path)])


def test_cli_model_name_resolves_via_registry(tmp_path, monkeypatch):
    calls = []

    def fake_resolve(name, download=True):
        calls.append(name)
        raise RuntimeError("stop-after-resolve")

    monkeypatch.setattr(registry, "resolve", fake_resolve)
    with pytest.raises(RuntimeError, match="stop-after-resolve"):
        cli.main(["-t", "x", "--model_name", "audioldm-s-full-v2", "--save_path", str(tmp_path),
                  "--device", "cpu"])
    assert calls == ["audioldm-s-full-v2"]


def test_cli_writes_wavs(tmp_path, monkeypatch):
    """Two prompts of a -tl file, 2 candidates each, through the tiny
    monolithic checkpoint (the pipeline's geometry cut to the goldens' by
    wrapping build_model); the names are `{i}_{prompt[:60]}_{j}.wav`."""
    path = _tiny_monolithic_ckpt(str(tmp_path / "tiny.ckpt"))
    text_cfg, audio_cfg = tiny_clap_configs()
    seen = {}

    def tiny_build(ckpt_path, conditioner=None, **kw):
        seen.update(kw)
        p = pl.AudioLDMPipeline.from_checkpoint(
            ckpt_path, conditioner, unet_config=film.FilmUNetConfig(**GOLDEN_FILM),
            vae_config=TC.VAEConfig(**GOLDEN_VAE), hifigan_config=TC.HiFiGANConfig(**GOLDEN_HIFI),
            stft_config=TC.StftConfig(n_mel_channels=8), latent_f_size=4,
            clap_text_cfg=text_cfg, clap_audio_cfg=audio_cfg, **kw)
        p.conditioner.audio_batch = 4
        return p

    monkeypatch.setattr(pl, "build_model", tiny_build)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a dog / barks\n\nwind chimes\n")
    out = tmp_path / "out"
    cli.main(["-tl", str(prompts), "--ckpt_path", path, "-s", str(out), "-dur", str(8 / 25.6),
              "--ddim_steps", "2", "-n", "2", "--device", "cpu"], tokenizer=ClippedTok())
    assert seen["device"] == "cpu" and isinstance(seen["tokenizer"], ClippedTok)
    assert sorted(os.listdir(out)) == ["0_a_dog___barks_0.wav", "1_wind_chimes_0.wav"]
    for name in os.listdir(out):
        wav, sr = read_wav(str(out / name))
        assert sr == 16000 and wav.shape == (2 * 8 * 160 + 32,) and np.abs(wav).max() > 0


def test_registry_matches_jax():
    assert registry.get_metadata() == jregistry.get_metadata()
    assert registry.CACHE_ROOT == jregistry.CACHE_ROOT
    for name in ("audioldm-s-full", "audioldm-l-full", "audioldm-s-full-v2", "audioldm-m-full"):
        assert registry.REGISTRY[name]["url"].startswith("https://zenodo.org/")
    assert "full-s-v2" in registry.REGISTRY["audioldm-s-full-v2"]["url"]


def test_registry_local_path_and_refusals(tmp_path, monkeypatch):
    cached = tmp_path / "cached.ckpt"
    cached.write_bytes(b"x")
    missing = tmp_path / "cache" / "missing.ckpt"
    monkeypatch.setitem(registry.REGISTRY, "audioldm-s-full",
                        {**registry.REGISTRY["audioldm-s-full"], "path": str(cached)})
    monkeypatch.setitem(registry.REGISTRY, "audioldm-l-full",
                        {**registry.REGISTRY["audioldm-l-full"], "path": str(missing)})
    assert registry.resolve("audioldm-s-full") == str(cached)
    assert registry.resolve("some/local/file.ckpt") == "some/local/file.ckpt"
    with pytest.raises(FileNotFoundError, match="not cached"):
        registry.resolve("audioldm-l-full", download=False)

    fetched = []

    def failing_fetch(url, dst):
        fetched.append((url, dst))
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlretrieve", failing_fetch)
    url = registry.REGISTRY["audioldm-l-full"]["url"]
    with pytest.raises(FileNotFoundError, match="Fetch it by hand") as e:
        registry.resolve("audioldm-l-full")
    assert url in str(e.value) and fetched == [(url, str(missing) + ".part")]
    assert not missing.exists()

    def fetch(url, dst):
        with open(dst, "wb") as f:
            f.write(b"ckpt")

    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    assert registry.resolve("audioldm-l-full") == str(missing)
    assert missing.read_bytes() == b"ckpt" and not os.path.exists(str(missing) + ".part")

    with pytest.raises(FileNotFoundError, match="declare-lab/tango2"):
        registry.resolve("declare-lab/tango2")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "declare-lab" / "tango2").mkdir(parents=True)
    assert registry.resolve("declare-lab/tango2") == "declare-lab/tango2"
