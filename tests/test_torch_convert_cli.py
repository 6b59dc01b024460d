"""The port's conversion CLI (tango_tpu_torch/convert_cli.py), after
tests/test_export.py: `export-main` and `export-snapshot` of the snapshot's
own UNet give back the reference main bin bit for bit and key for key; a
trained UNet checkpoint goes in place of it; the exported snapshot reloads
through `Tango(path)`; `tango` writes the native directory with JAX's
manifest; Mustango's `mustango` and `export-mustango` convert and export
snapshot_tiny_mustango; `audioldm` (queue A #8, ported) writes the native
directory of a tiny monolithic AudioLDM checkpoint, each part equal to JAX's
loader's; `NOT_PORTED` is empty."""

import json
import os

import numpy as np
import pytest
import torch

from tango_tpu.utils.checkpoint import load_tango_snapshot as j_load_tango_snapshot
from tango_tpu_torch import convert_cli
from tango_tpu_torch.pipeline import Tango
from tango_tpu_torch.tokenizer import WordHashTokenizer
from tango_tpu_torch.utils.checkpoint import load_native, load_tango_snapshot, save_native
from tango_tpu_torch.utils.convert import load_torch_bin
from tango_tpu_torch.utils.export import export_unet

from tests.conftest import GOLDEN

torch.set_num_threads(1)

SNAP = GOLDEN / "snapshot_tiny"
MSNAP = GOLDEN / "snapshot_tiny_mustango"


def _assert_same(orig: dict, exported: dict):
    assert set(exported) == set(orig), (sorted(set(orig) - set(exported))[:5],
                                        sorted(set(exported) - set(orig))[:5])
    for k in orig:
        assert torch.equal(exported[k], orig[k]), k


def test_export_main_roundtrip(tmp_path):
    out = tmp_path / "main.bin"
    convert_cli.main(["export-main", str(SNAP), "-", str(out)])
    _assert_same(load_torch_bin(str(SNAP / "pytorch_model_main.bin")), load_torch_bin(str(out)))


def test_export_main_of_a_trained_unet(tmp_path):
    unet = load_tango_snapshot(str(SNAP))["unet_params"]
    trained = {k: v * 1.5 + 0.25 for k, v in unet.items()}
    save_native(str(tmp_path / "best"), trained, {"epoch": 0})
    out = tmp_path / "main.bin"
    convert_cli.main(["export-main", str(SNAP), str(tmp_path / "best"), str(out)])
    got = load_torch_bin(str(out))
    want = load_torch_bin(str(SNAP / "pytorch_model_main.bin"))
    assert set(got) == set(want)
    for k, v in export_unet(trained).items():
        assert torch.equal(got["unet." + k], v), k
    for k in want:
        if k.startswith("text_encoder."):
            assert torch.equal(got[k], want[k]), k


def test_export_snapshot_reloads(tmp_path):
    out = tmp_path / "snap_out"
    convert_cli.main(["export-snapshot", str(SNAP), "-", str(out)])
    assert sorted(os.listdir(out)) == sorted(os.listdir(SNAP))
    for name in os.listdir(SNAP):
        if name != "pytorch_model_main.bin":
            assert (out / name).read_bytes() == (SNAP / name).read_bytes(), name
    _assert_same(load_torch_bin(str(SNAP / "pytorch_model_main.bin")),
                 load_torch_bin(str(out / "pytorch_model_main.bin")))
    kw = dict(tokenizer=WordHashTokenizer(128), device="cpu")
    a, b = Tango(str(out), **kw), Tango(str(SNAP), **kw)
    for t in (a, b):
        t.model.latent_t_size = 8
    wa = a.generate("a dog barks", steps=2, seed=0)
    assert wa.dtype == np.int16 and np.abs(wa.astype(np.int32)).max() > 0
    np.testing.assert_array_equal(wa, b.generate("a dog barks", steps=2, seed=0))


def test_export_snapshot_keeps_the_scheduler(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in os.listdir(SNAP):
        (src / name).write_bytes((SNAP / name).read_bytes())
    (src / "scheduler").mkdir()
    (src / "scheduler" / "scheduler_config.json").write_text(
        json.dumps({"num_train_timesteps": 1000, "beta_schedule": "scaled_linear",
                    "prediction_type": "epsilon"}))
    out = tmp_path / "out"
    convert_cli.main(["export-snapshot", str(src), "-", str(out)])
    assert (out / "scheduler" / "scheduler_config.json").exists()
    assert load_tango_snapshot(str(out))["scheduler_config"].prediction_type == "epsilon"


def test_tango_kind_writes_native(tmp_path):
    convert_cli.main(["tango", str(SNAP), str(tmp_path / "native")])
    state, manifest = load_native(str(tmp_path / "native"))
    loaded = load_tango_snapshot(str(SNAP), with_encoder=True)
    for part, key in (("unet", "unet_params"), ("vae", "vae_params"), ("t5", "t5_params"),
                      ("hifigan", "hifigan_params")):
        sd = {k[len(part) + 1:]: v for k, v in state.items() if k.startswith(part + ".")}
        _assert_same(loaded[key], sd)
    assert any(k.startswith("vae.encoder.") for k in state)
    # JAX's manifest: its kind and config keys, and the same configs' values
    jloaded = j_load_tango_snapshot(str(SNAP))
    assert set(manifest) == {"kind", "unet_config", "vae_config", "stft_config", "main_config"}
    assert manifest["kind"] == "tango"
    for name in ("stft_config", "main_config"):
        assert manifest[name] == json.loads(json.dumps(jloaded[name].to_dict())), name
    for name in ("unet_config", "vae_config"):
        want = json.loads(json.dumps(jloaded[name].to_dict()))
        shared = set(want) & set(manifest[name])
        assert shared and {k: manifest[name][k] for k in shared} == {k: want[k] for k in shared}


def _convert_audioldm(tmp_path):
    import functools

    from tango_tpu.utils.checkpoint import load_audioldm_ckpt as j_load_audioldm_ckpt
    from tango_tpu_torch.models import audioldm_unet as film
    from tango_tpu_torch.utils.convert import from_jax_params

    from tests.test_torch_audioldm import GOLDEN_FILM, _tiny_monolithic_ckpt

    src = _tiny_monolithic_ckpt(str(tmp_path / "tiny.ckpt"))
    cfg = film.FilmUNetConfig(**GOLDEN_FILM)
    convert = film.convert_film_unet
    film.convert_film_unet = functools.partial(convert, cfg=cfg)
    try:
        convert_cli.main(["audioldm", src, str(tmp_path / "x")])
    finally:
        film.convert_film_unet = convert
    state, manifest = load_native(str(tmp_path / "x"))
    assert manifest == {"kind": "audioldm", "scale_factor": pytest.approx(0.87)}
    sd = load_torch_bin(src)
    pre = "model.diffusion_model."
    jvae, jhifi, _ = j_load_audioldm_ckpt(src)
    for part, want in (("unet", convert({k[len(pre):]: v for k, v in sd.items()
                                         if k.startswith(pre)}, cfg)),
                       ("vae", from_jax_params(jvae)), ("hifigan", from_jax_params(jhifi))):
        got = {k[len(part) + 1:]: v for k, v in state.items() if k.startswith(part + ".")}
        assert set(got) == set(want), part
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-7, msg=k)
    assert any(k.startswith("vae.encoder.") for k in state)


@pytest.mark.parametrize("kind,item", [("audioldm", "#8"), ("mustango", "#7"),
                                       ("export-mustango", "#7")])
def test_not_ported_kinds_raise(kind, item, tmp_path):
    """The kinds of queue A #8 and #7, once refused, are ported. `audioldm`
    writes the native directory of a monolithic checkpoint (the FiLM UNet's
    converter cut to the tiny goldens' geometry): the UNet as
    convert_film_unet gives it, the VAE with its encoder and the folded
    vocoder equal to JAX's `load_audioldm_ckpt` through from_jax_params, and
    JAX's manifest. `mustango` writes the native directory, every part
    equal to the loader's, and `export-mustango` of the snapshot's own UNet
    gives back the ldm bin bit for bit, with configs/ and vae/ copied."""
    from tango_tpu_torch.pipeline_music import load_mustango_snapshot

    assert convert_cli.NOT_PORTED == {}
    if kind == "audioldm":
        _convert_audioldm(tmp_path)
        return
    if kind == "mustango":
        convert_cli.main([kind, str(MSNAP), str(tmp_path / "x")])
        state, manifest = load_native(str(tmp_path / "x"))
        assert manifest["kind"] == "mustango" and manifest["unet_config"]["extra_cond_streams"] == 2
        loaded = load_mustango_snapshot(str(MSNAP), with_encoder=True)
        for part, key in (("unet", "unet_params"), ("t5", "t5_params"),
                          ("conditioner", "conditioner_params"), ("vae", "vae_params"),
                          ("hifigan", "hifigan_params")):
            sd = {k[len(part) + 1:]: v for k, v in state.items() if k.startswith(part + ".")}
            _assert_same(loaded[key], sd)
        assert any(k.startswith("unet.") and "_extra2." in k for k in state)
        return
    out = tmp_path / "y"
    convert_cli.main([kind, str(MSNAP), "-", str(out)])
    _assert_same(load_torch_bin(str(MSNAP / "ldm" / "pytorch_model_ldm.bin")),
                 load_torch_bin(str(out / "ldm" / "pytorch_model_ldm.bin")))
    for sub in ("configs", "vae"):
        for name in os.listdir(MSNAP / sub):
            assert (out / sub / name).read_bytes() == (MSNAP / sub / name).read_bytes(), name


def test_export_mustango_of_a_trained_unet_reloads(tmp_path):
    """A trained music UNet in place of the snapshot's, exported and loaded
    back by Mustango(path): its streams and the untouched T5 and conditioner."""
    from tango_tpu_torch.pipeline_music import Mustango, load_mustango_snapshot

    loaded = load_mustango_snapshot(str(MSNAP))
    trained = {k: v * 1.5 + 0.25 for k, v in loaded["unet_params"].items()}
    save_native(str(tmp_path / "best"), trained, {"epoch": 0})
    out = tmp_path / "out"
    convert_cli.main(["export-mustango", str(MSNAP), str(tmp_path / "best"), str(out)])
    m = Mustango(str(out), tokenizer=WordHashTokenizer(64), device="cpu")
    _assert_same(trained, m.model.unet.state_dict())
    _assert_same(loaded["conditioner_params"], m.model.conditioner.state_dict())
    _assert_same(loaded["t5_params"], m.t5.state_dict())
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        convert_cli.main(["mustango", "declare-lab/mustango", str(tmp_path / "z")])


def test_bad_arguments_raise(tmp_path):
    with pytest.raises(SystemExit, match="unknown kind"):
        convert_cli.main(["nope", str(SNAP), str(tmp_path / "x")])
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        convert_cli.main(["tango", "declare-lab/tango", str(tmp_path / "x")])
    with pytest.raises(SystemExit):
        convert_cli.main(["tango"])
