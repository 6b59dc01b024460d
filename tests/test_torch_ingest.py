"""Audio ingestion through the port's read path against the JAX package's:
`read_wav` / `read_wav_file` on every format, the SFT preflight
(`validate_manifest`) and the featurizing loader on a manifest that mixes
the formats, the constant stand-in for a file that fails to decode, and the
Opus gate on the system libopus. Also the committed fixtures of
tests/data/ingest/ (scripts/make_ingest_fixtures.py) against JAX's decode of
the same files, which chip_smoke.py's phase `ingest` reads on the card.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import pytest

import chip_smoke
from tango_tpu.audio import opus as jopus
from tango_tpu.audio import wav as jwav
from tango_tpu.train import data as jdata
from tango_tpu_torch.audio import opus as topus
from tango_tpu_torch.audio import wav as twav
from tango_tpu_torch.train import data as tdata

INGEST = pathlib.Path(chip_smoke.INGEST_DIR)
FORMATS = chip_smoke.INGEST_FORMATS

needs_libopus = pytest.mark.skipif(not jopus.libopus_available(),
                                   reason="system libopus not loadable")


def _skip_without_codec(name):
    if name == "opus" and not jopus.libopus_available():
        pytest.skip("system libopus not loadable")


def _wav(path, seconds=0.7, sr=22050, seed=0):
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(seed)
    twav.write_wav(str(path), (0.4 * np.sin(2 * np.pi * rng.uniform(100, 900) * t)
                               + 0.01 * rng.standard_normal(t.shape)).astype(np.float32), sr)
    return str(path)


@pytest.mark.parametrize("name", FORMATS)
def test_fixture_references_are_jax_decode(name):
    """reference.npz holds JAX's decode of the committed file bit for bit
    (so a fixture regenerated without its reference fails here), and the
    port's read_wav gives the same."""
    _skip_without_codec(name)
    ref = np.load(INGEST / "reference.npz")
    path = str(INGEST / f"clip.{name}")
    assert jwav.sniff_format(path) == twav.sniff_format(path) == name
    want = (ref[f"{name}_int16"].astype(np.float32) / 32768.0 if name in chip_smoke.INGEST_EXACT
            else ref[f"{name}_f32"])
    for read_wav in (jwav.read_wav, twav.read_wav):
        pcm, rate = read_wav(path)
        assert rate == int(ref[f"{name}_rate"])
        assert (pcm.dtype, pcm.shape) == (np.float32, want.shape)
        np.testing.assert_array_equal(pcm, want)


def test_fixtures_are_small_and_complete():
    files = sorted(p.name for p in INGEST.iterdir())
    assert files == sorted([f"clip.{n}" for n in FORMATS] + ["reference.npz"])
    assert sum(p.stat().st_size for p in INGEST.iterdir()) < 1 << 20
    ref = np.load(INGEST / "reference.npz")
    for name in FORMATS:
        pcm = ref[f"{name}_int16" if name in chip_smoke.INGEST_EXACT else f"{name}_f32"]
        assert 1.0 <= len(pcm) / int(ref[f"{name}_rate"]) <= 2.0  # 1-2 s clips


@pytest.mark.parametrize("segment", [None, 16000, 163840])
@pytest.mark.parametrize("name", FORMATS + ("wav",))
def test_read_wav_file_matches_jax(name, segment, tmp_path):
    """The reference read path (first channel, 16 kHz, normalise, pad or
    trim, peak 0.5) gives JAX's array on every format."""
    _skip_without_codec(name)
    path = _wav(tmp_path / "a.wav") if name == "wav" else str(INGEST / f"clip.{name}")
    got = twav.read_wav_file(path, segment)
    want = jwav.read_wav_file(path, segment)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _mixed_manifest(tmp_path, with_opus: bool):
    rows = []
    for name in FORMATS:
        if name == "opus" and not with_opus:
            continue
        rows.append({"dataset": "t", "location": str(INGEST / f"clip.{name}"),
                     "captions": f"a {name} clip"})
    for i in range(2):
        rows.append({"dataset": "t", "location": _wav(tmp_path / f"w{i}.wav", seed=i),
                     "captions": f"tone {i}"})
    manifest = tmp_path / "train.json"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(manifest)


def test_mixed_manifest_preflight_and_loader_match_jax(tmp_path):
    """A manifest of every format passes both preflights, and the port's
    loader gives the JAX loader's waveforms (bit for bit) and fbanks (the
    STFT's f32 summation order: 2e-4 / 1e-3, as the WAV loader test)."""
    manifest = _mixed_manifest(tmp_path, with_opus=jopus.libopus_available())
    mine_ex, ref_ex = tdata.load_manifest(manifest), jdata.load_manifest(manifest)
    tdata.validate_manifest(mine_ex)
    jdata.validate_manifest(ref_ex)
    mine = list(tdata.FeaturizedLoader(mine_ex, 2, target_length=64, shuffle=False,
                                       drop_last=False))
    ref = list(jdata.FeaturizedLoader(ref_ex, 2, target_length=64, shuffle=False,
                                      drop_last=False))
    assert len(mine) == len(ref) == (len(mine_ex) + 1) // 2
    for a, b in zip(mine, ref):
        assert a["captions"] == b["captions"]
        np.testing.assert_array_equal(a["waveforms"], np.asarray(b["waveforms"]))
        assert np.all(np.std(a["waveforms"], axis=1) > 0.01)  # decoded, not the stand-in
        np.testing.assert_allclose(a["fbank"], np.asarray(b["fbank"]), atol=2e-4, rtol=1e-3)


def test_undecodable_file_gives_the_constant_stand_in(tmp_path):
    """A file that sniffs as FLAC but fails to decode passes both preflights
    and becomes the reference's constant 0.5 waveform in both loaders; a file
    of no known format fails both preflights."""
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"fLaC" + b"\x00" * 60)
    ok = _wav(tmp_path / "ok.wav")
    examples = [tdata.Example(str(bad), "x"), tdata.Example(ok, "y")]
    tdata.validate_manifest(examples)
    jdata.validate_manifest([jdata.Example(e.location, e.caption) for e in examples])
    assert tdata._decode_one((str(bad), 160)) is None
    mine = next(iter(tdata.FeaturizedLoader(examples, 2, target_length=16, shuffle=False)))
    ref = next(iter(jdata.FeaturizedLoader([jdata.Example(e.location, e.caption)
                                            for e in examples], 2, target_length=16,
                                           shuffle=False)))
    np.testing.assert_array_equal(mine["waveforms"], np.asarray(ref["waveforms"]))
    np.testing.assert_array_equal(mine["waveforms"][0], 0.5)
    garbage = tmp_path / "noise.wav"
    garbage.write_bytes(b"not audio at all" * 4)
    missing = str(tmp_path / "missing.wav")
    for loc in (str(garbage), missing):
        for mod in (tdata, jdata):
            with pytest.raises(ValueError, match="preflight"):
                mod.validate_manifest([mod.Example(loc, "z")])


@needs_libopus
def test_opus_manifest_without_libopus_raises_in_both(tmp_path, monkeypatch):
    manifest = _mixed_manifest(tmp_path, with_opus=True)
    monkeypatch.setattr(jopus, "libopus_available", lambda: False)
    monkeypatch.setattr(topus, "libopus_available", lambda: False)
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="libopus") as err:
            mod.validate_manifest(mod.load_manifest(manifest))
        assert "clip.opus" in str(err.value)
    # without an Opus file the library is not needed
    manifest = _mixed_manifest(tmp_path, with_opus=False)
    tdata.validate_manifest(tdata.load_manifest(manifest))


def test_smoke_ingest_child_on_cpu(tmp_path):
    """chip_smoke.py's phase `ingest`, run here in-process: every fixture
    within its limit, rates logged, FLAC on the native path."""
    out = tmp_path / "ingest.json"
    assert chip_smoke.ingest_child(str(out)) == 0
    rec = json.loads(out.read_text())
    assert rec["problems"] == []
    assert rec["libopus"] == jopus.libopus_available()
    names = [n for n in FORMATS if n != "opus" or rec["libopus"]]
    assert sorted(k for k, v in rec["formats"].items() if "max_abs_err" in v) == sorted(names)
    for name in names:
        r = rec["formats"][name]
        assert r["max_abs_err"] <= r["limit"] and r["audio_s_per_s"] > 0
        assert len(r["decode_s"]) == chip_smoke.INGEST_REPS
    from tango_tpu_torch.audio import flac_native

    assert rec["formats"]["flac"]["path"] == ("native" if flac_native.available() else "python")


def test_smoke_ingest_child_without_libopus(tmp_path, monkeypatch):
    """Without libopus the phase records JAX's preflight refusal, not a
    failure."""
    monkeypatch.setattr(topus, "libopus_available", lambda: False)
    out = tmp_path / "ingest.json"
    chip_smoke.ingest_child(str(out))
    rec = json.loads(out.read_text())
    assert rec["problems"] == [] and rec["libopus"] is False
    assert rec["formats"]["opus"] == {"preflight_refused": True}


@pytest.mark.parametrize("libopus", [True, False])
def test_smoke_mixed_manifest(tmp_path, libopus):
    """chip_smoke.py's train_cli manifest: one clip of each format first, the
    WAVs for the rest and still on the disk (phase dpo reads them)."""
    manifest = chip_smoke.write_wavs(str(tmp_path), 8, 0.2, seed=0)
    exts = chip_smoke.mix_formats(manifest, libopus)
    names = [n for n in FORMATS if n != "opus" or libopus]
    assert exts == names + ["wav"] * (8 - len(names))
    assert all(os.path.exists(tmp_path / f"clip{i}.wav") for i in range(8))
    rows = [json.loads(line) for line in open(manifest)]
    for row, ext in zip(rows, exts):
        assert twav.sniff_format(row["location"]) == ext
    tdata.validate_manifest(tdata.load_manifest(manifest))
