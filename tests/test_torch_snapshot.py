"""Reference-format snapshots in the port: the reference-name converters,
the loaders, the main-bin export and `Tango(path)`, against the JAX package.

Converters and loaders must give the same keys and bit-equal tensors as
`from_jax_params` of JAX's converters on the same reference state dicts
(the tiny goldens' `sd::` keys and tests/golden/snapshot_tiny); the export
must invert the converter bit for bit. `Tango(path)` on snapshot_tiny is held
to JAX's `Tango(path)` under one `noise_override`, f32 on the CPU, at the
tolerances of tests/test_torch_pipeline.py: text states and latents atol
2e-4 / rtol 1e-3, the mel and the float waveform 1e-4 / 1e-3.
"""

import json
import re
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

from tango_tpu import configs as JC
from tango_tpu.models.t5 import convert_t5_encoder as j_convert_t5
from tango_tpu.pipeline import Tango as JTango
from tango_tpu.utils import checkpoint as jckpt
from tango_tpu.utils import convert as jconv
from tango_tpu.utils import export as jexport
from tango_tpu_torch import configs as TC
from tango_tpu_torch.models.t5 import T5Encoder, convert_t5_encoder, t5_config_from_state_dict
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.ops.quant import QConv2d
from tango_tpu_torch.pipeline import Tango
from tango_tpu_torch.tokenizer import WordHashTokenizer
from tango_tpu_torch.utils import checkpoint as ckpt
from tango_tpu_torch.utils import convert as conv
from tango_tpu_torch.utils import export

from tests.conftest import GOLDEN

torch.set_num_threads(1)

SNAP = GOLDEN / "snapshot_tiny"
# 0.32 s of audio: 8 latent frames on the snapshot's 2-level UNet
SHORT_S, SHORT_T = 0.32, 8


def assert_same(got: dict, want: dict) -> None:
    """Same keys, and every tensor bit-equal with the same dtype and shape."""
    assert set(got) == set(want), (sorted(set(got) - set(want))[:5],
                                   sorted(set(want) - set(got))[:5])
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def as_torch(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def golden_sd(name: str) -> dict:
    g = np.load(GOLDEN / f"{name}.npz")
    return {k[4:]: g[k] for k in g.files if k.startswith("sd::")}


def snapshot_sd(part: str) -> dict:
    sd = jconv.load_torch_bin(str(SNAP / f"pytorch_model_{part}.bin"))
    unet, text, _ = jckpt.split_main_state_dict(sd)
    return {"main_unet": unet, "main_t5": text, "vae": sd,
            "vocoder": {k[8:]: v for k, v in sd.items() if k.startswith("vocoder.")}}


# (source, port converter, JAX converter to a tree): every reference layout
CONVERTERS = {
    "unet_tiny": (lambda: golden_sd("unet_tiny"), conv.convert_unet, jconv.convert_unet),
    "sampling_tiny": (lambda: golden_sd("sampling_tiny"), conv.convert_unet, jconv.convert_unet),
    "vae_tiny": (lambda: golden_sd("vae_tiny"),
                 lambda sd: conv.convert_vae(sd, with_encoder=True), jconv.convert_vae),
    "hifigan_tiny": (lambda: golden_sd("hifigan_tiny"), conv.convert_hifigan,
                     jconv.convert_hifigan),
    "t5_tiny": (lambda: golden_sd("t5_tiny"), convert_t5_encoder, j_convert_t5),
    "snapshot_main_unet": (lambda: snapshot_sd("main")["main_unet"], conv.convert_unet,
                           jconv.convert_unet),
    "snapshot_main_t5": (lambda: snapshot_sd("main")["main_t5"], convert_t5_encoder,
                         j_convert_t5),
    "snapshot_vae": (lambda: snapshot_sd("vae")["vae"],
                     lambda sd: conv.convert_vae(sd, with_encoder=True), jconv.convert_vae),
    "snapshot_vocoder": (lambda: snapshot_sd("vae")["vocoder"], conv.convert_hifigan,
                         jconv.convert_hifigan),
}


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converter_matches_jax(name):
    source, port_fn, jax_fn = CONVERTERS[name]
    sd = source()
    assert_same(port_fn(as_torch(sd)), conv.from_jax_params(jax_fn(sd)))


def test_serving_vae_drops_encoder_and_vocoder():
    sd = snapshot_sd("vae")["vae"]
    want = conv.from_jax_params(jconv.convert_vae(sd), skip=("encoder", "quant_conv"))
    assert_same(conv.convert_vae(as_torch(sd)), want)


@pytest.mark.parametrize("part", ["main", "vae"])
def test_load_torch_bin_matches_jax(part):
    got = conv.load_torch_bin(str(SNAP / f"pytorch_model_{part}.bin"))
    assert_same(got, as_torch(jconv.load_torch_bin(str(SNAP / f"pytorch_model_{part}.bin"))))
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in got.values())


def test_t5_config_from_state_dict_matches_jax():
    from tango_tpu.models.t5 import t5_config_from_state_dict as j_t5_config

    for sd in (golden_sd("t5_tiny"), snapshot_sd("main")["main_t5"]):
        want = TC.T5Config.from_dict(j_t5_config(sd).to_dict())
        assert t5_config_from_state_dict(as_torch(sd)) == want


def test_converters_refuse_what_the_port_lacks():
    sd = as_torch(golden_sd("unet_tiny"))
    deeper = {k.replace("transformer_blocks.0.", "transformer_blocks.1."): v for k, v in sd.items()}
    with pytest.raises(ValueError, match="transformer_layers_per_block"):
        conv.convert_unet({**sd, **deeper})
    # Mustango's streams (queue A #7) are ported: attentions2 keys convert
    # onto the _extra1 stream, the same tensors as the text stream's
    music = {k.replace(".attentions.", ".attentions2."): v for k, v in sd.items()
             if ".attentions." in k}
    plain, got = conv.convert_unet(sd), conv.convert_unet({**sd, **music})
    extra = {k: v for k, v in got.items() if "_extra1." in k}
    assert extra and set(got) == set(plain) | set(extra)
    assert all(torch.equal(v, plain[re.sub(r"_extra1\.", ".", k)]) for k, v in extra.items())
    with pytest.raises(NotImplementedError, match="act_fn"):
        TC.UNetConfig.from_dict({"act_fn": "gelu"})
    assert TC.UNetConfig.from_dict({"act_fn": "silu", "_class_name": "x"}) == TC.UNetConfig()


# ------------------------------------------------------------------ loaders

@pytest.fixture(scope="module")
def loaded():
    return ckpt.load_tango_snapshot(str(SNAP)), jckpt.load_tango_snapshot(str(SNAP))


CONFIGS = ("vae_config", "stft_config", "main_config", "scheduler_config", "unet_config",
           "t5_config", "hifigan_config")


@pytest.mark.parametrize("key", CONFIGS)
def test_snapshot_configs_match_jax(loaded, key):
    port, jax_loaded = loaded
    assert port[key] == type(port[key]).from_dict(jax_loaded[key].to_dict())


def test_snapshot_state_dicts_match_jax(loaded):
    port, jax_loaded = loaded
    assert_same(port["unet_params"], conv.from_jax_params(jax_loaded["unet_params"]))
    assert_same(port["t5_params"], conv.from_jax_params(jax_loaded["t5_params"]))
    assert_same(port["hifigan_params"], conv.from_jax_params(jax_loaded["hifigan_params"]))
    assert_same(port["vae_params"], conv.from_jax_params(jax_loaded["vae_params"],
                                                         skip=("encoder", "quant_conv")))


def _copy(tmp_path):
    snap = tmp_path / "snap"
    shutil.copytree(SNAP, snap)
    return snap


@pytest.mark.parametrize("case", ["default", "shipped", "other_name"])
def test_snapshot_scheduler_config(tmp_path, case):
    """SD-2.1 by default; a shipped scheduler/scheduler_config.json wins; a
    scheduler_name other than SD-2.1 with none shipped warns."""
    snap = _copy(tmp_path)
    if case == "shipped":
        (snap / "scheduler").mkdir()
        (snap / "scheduler" / "scheduler_config.json").write_text(json.dumps({
            "num_train_timesteps": 500, "beta_schedule": "linear",
            "prediction_type": "epsilon"}))
    if case == "other_name":
        main = json.loads((snap / "main_config.json").read_text())
        main["scheduler_name"] = "some/other-scheduler"
        (snap / "main_config.json").write_text(json.dumps(main))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sc = ckpt.load_tango_snapshot(str(snap))["scheduler_config"]
        jsc = jckpt.load_tango_snapshot(str(snap))["scheduler_config"]
    assert sc == TC.SchedulerConfig.from_dict(jsc.to_dict())
    warned = [x for x in w if "scheduler" in str(x.message)]
    assert len(warned) == (2 if case == "other_name" else 0)  # JAX's and the port's
    if case == "shipped":
        assert (sc.num_train_timesteps, sc.beta_schedule) == (500, "linear")
    else:
        assert sc == TC.SD21_SCHEDULER


def test_load_main_weights():
    """The --hf_model loader reads only pytorch_model_main.bin; its state
    dicts load straight into the port's modules and equal JAX's."""
    got = ckpt.load_main_weights(str(SNAP))
    want = jckpt.load_main_weights(str(SNAP))
    assert got["t5_config"].d_model == 32
    assert got["unet_config"] is not None and got["unet_config"].in_channels == 4
    assert got["unet_config"] == TC.UNetConfig.from_dict(want["unet_config"].to_dict())
    assert_same(got["unet_params"], conv.from_jax_params(want["unet_params"]))
    assert_same(got["t5_params"], conv.from_jax_params(want["t5_params"]))
    UNet2DConditionModel(got["unet_config"]).load_state_dict(got["unet_params"])
    T5Encoder(got["t5_config"]).load_state_dict(got["t5_params"])


def test_vocoder_less_snapshot_has_no_vocoder(tmp_path):
    snap = _copy(tmp_path)
    sd = torch.load(snap / "pytorch_model_vae.bin", weights_only=True)
    torch.save({k: v for k, v in sd.items() if not k.startswith("vocoder.")},
               snap / "pytorch_model_vae.bin")
    got = ckpt.load_tango_snapshot(str(snap))
    assert got["hifigan_params"] is None and got["hifigan_config"] is None
    tango = Tango(str(snap), tokenizer=WordHashTokenizer(128), device="cpu")
    assert tango.vocoder is None
    with pytest.raises(RuntimeError, match="vocoder"):
        tango.decode(torch.zeros(1, SHORT_T, 16, 4))


def test_stride4_vae_geometry_raises(tmp_path):
    snap = _copy(tmp_path)
    cfg = json.loads((snap / "vae_config.json").read_text())
    cfg["ddconfig"]["downsample_time_stride4_levels"] = [0]
    (snap / "vae_config.json").write_text(json.dumps(cfg))
    # JAX's VAE has no stride-4 variant either (tango_tpu/models/vae.py:103)
    with pytest.raises(NotImplementedError, match="neither here nor in the JAX package"):
        ckpt.load_tango_snapshot(str(snap))


# ------------------------------------------------------------------- export

def test_export_inverts_convert_bit_for_bit():
    sd = conv.load_torch_bin(str(SNAP / "pytorch_model_main.bin"))
    unet_sd, text_sd, rest = ckpt.split_main_state_dict(sd)
    assert not rest
    assert_same(export.export_unet(conv.convert_unet(unet_sd)), unet_sd)
    assert_same(export.export_t5_encoder(convert_t5_encoder(text_sd)), text_sd)
    assert_same(export.export_main_state_dict(conv.convert_unet(unet_sd),
                                              convert_t5_encoder(text_sd)), sd)


def test_save_main_bin_reloads_and_matches_jax_export(tmp_path):
    sd = conv.load_torch_bin(str(SNAP / "pytorch_model_main.bin"))
    unet_sd, text_sd, _ = ckpt.split_main_state_dict(sd)
    path = tmp_path / "pytorch_model_main.bin"
    export.save_main_bin(str(path), conv.convert_unet(unet_sd), convert_t5_encoder(text_sd))
    again = conv.load_torch_bin(str(path))
    assert_same(again, sd)
    jsd = jconv.load_torch_bin(str(SNAP / "pytorch_model_main.bin"))
    j_unet, j_text, _ = jckpt.split_main_state_dict(jsd)
    assert_same(again, as_torch(jexport.export_main_state_dict(jconv.convert_unet(j_unet),
                                                               j_convert_t5(j_text))))
    # the written snapshot loads as the original does
    snap = tmp_path / "snap"
    shutil.copytree(SNAP, snap)
    shutil.copy(path, snap / "pytorch_model_main.bin")
    assert_same(ckpt.load_main_weights(str(snap))["unet_params"], conv.convert_unet(unet_sd))


def test_export_refuses_int8_unet():
    with pytest.raises(ValueError, match="weight_scale"):
        export.export_unet({"conv_in.weight": torch.zeros(1), "conv_in.weight_scale": torch.ones(1)})


# ------------------------------------------------------------- Tango(path)

@pytest.fixture(scope="module")
def port():
    return Tango(str(SNAP), tokenizer=WordHashTokenizer(128), device="cpu")


def test_tango_path_matches_jax(port):
    jt = JTango(str(SNAP), tokenizer=WordHashTokenizer(128))
    prompts = ["a dog barks in the park", "rain on a tin roof"]
    steps = 2
    rng = np.random.RandomState(0)
    init = rng.randn(2, SHORT_T, 16, 4).astype(np.float32)
    noises = rng.randn(steps, 2, SHORT_T, 16, 4).astype(np.float32)

    j_cond, j_mask = jt.encode_text(prompts)
    j_unc, j_umask = jt.encode_text([""] * 2)
    j_lat = jt.model.sample(jt.unet_params, j_cond, j_mask, jax.random.PRNGKey(0),
                            num_steps=steps, guidance_scale=3.0, uncond_embeds=j_unc,
                            uncond_mask=j_umask, latent_t_size=SHORT_T,
                            noise_override=(init, noises))
    j_mel, j_wav = jt._decode_fn()(jt.vae_params, jt.hifigan_params, j_lat)

    p_cond, p_mask = port.encode_text(prompts)
    p_unc, p_umask = port.encode_text([""] * 2)
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(p_cond.numpy(), np.asarray(j_cond), atol=2e-4, rtol=1e-3)
    p_lat = port.model.sample(p_cond, p_mask, num_steps=steps, guidance_scale=3.0,
                              uncond_embeds=p_unc, uncond_mask=p_umask, latent_t_size=SHORT_T,
                              noise_override=(torch.from_numpy(init), torch.from_numpy(noises)))
    np.testing.assert_allclose(p_lat.numpy(), np.asarray(j_lat), atol=2e-4, rtol=1e-3)
    p_mel, p_wav = port.decode(torch.from_numpy(np.array(j_lat)))
    assert p_wav.shape == j_wav.shape == (2, 2 * SHORT_T * 160 + 32)
    np.testing.assert_allclose(p_mel.numpy(), np.asarray(j_mel), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(p_wav.numpy(), np.asarray(j_wav), atol=1e-4, rtol=1e-3)


def test_tango_path_keeps_snapshot_configs(port):
    assert port.main_config.unet_model_config_path == "unet_config.json"
    assert port.stft_config == TC.TANGO_STFT
    assert port.cast_params and port.dtype == torch.float32
    assert (port.model.latent_t_size, port.model.latent_f_size) == (256, 16)


def _from_components(loaded, unet_params=None, **kw):
    return Tango.from_components(
        unet_config=loaded["unet_config"], vae_config=loaded["vae_config"],
        unet_params=loaded["unet_params"] if unet_params is None else unet_params,
        vae_params=loaded["vae_params"], t5_config=loaded["t5_config"],
        t5_params=loaded["t5_params"], hifigan_config=loaded["hifigan_config"],
        hifigan_params=loaded["hifigan_params"], scheduler_config=loaded["scheduler_config"],
        tokenizer=WordHashTokenizer(128), device="cpu", **kw)


def test_tango_path_generate_equals_from_components(port, loaded):
    built = _from_components(loaded[0])
    a = port.generate("a dog barks", steps=2, seed=0, duration=SHORT_S)
    b = built.generate("a dog barks", steps=2, seed=0, duration=SHORT_S)
    assert a.shape == (2 * SHORT_T * 160 + 32,) and np.abs(a).max() > 0
    np.testing.assert_array_equal(a, b)


def test_unet_ckpt_replaces_the_snapshot_unet(port, loaded, tmp_path):
    """A natively trained UNet, as SFTTrainer.fit saves it, over the
    snapshot's VAE, T5 and vocoder."""
    trained = {k: v * 1.05 for k, v in loaded[0]["unet_params"].items()}
    ckpt.save_native(str(tmp_path / "best"), trained, manifest={"epoch": 3})
    tuned = Tango(str(SNAP), tokenizer=WordHashTokenizer(128), device="cpu",
                  unet_ckpt=str(tmp_path / "best"))
    kw = dict(steps=2, seed=0, duration=SHORT_S)
    w = tuned.generate("a dog barks", **kw)
    assert np.abs(w.astype(np.int32) - port.generate("a dog barks", **kw)).max() > 0
    np.testing.assert_array_equal(
        w, _from_components(loaded[0], unet_params=trained).generate("a dog barks", **kw))
    with pytest.raises(ValueError, match="unet_ckpt"):
        Tango(device="cpu", unet_ckpt=str(tmp_path / "best"))


def test_quant_conv_builds_from_snapshot():
    t = Tango(str(SNAP), tokenizer=WordHashTokenizer(128), device="cpu", quant="conv")
    assert t.model.unet_config.quant_conv
    assert any(isinstance(m, QConv2d) for m in t.model.unet.modules())
    w = t.generate("a dog barks", steps=2, seed=0, duration=SHORT_S)
    assert w.dtype == np.int16 and np.abs(w).max() > 0


def test_default_tokenizer_warns():
    with pytest.warns(UserWarning, match="WordHashTokenizer"):
        t = Tango(str(SNAP), device="cpu")
    assert isinstance(t.tokenizer, WordHashTokenizer) and t.tokenizer.vocab_size == 128
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Tango(str(SNAP), tokenizer=WordHashTokenizer(128), device="cpu")


def test_not_a_directory_raises(tmp_path):
    for name in ("declare-lab/tango", str(tmp_path / "missing")):
        with pytest.raises(FileNotFoundError, match="downloads nothing"):
            Tango(name, device="cpu")


def test_release_configs_match_jax():
    pairs = [(JC.TANGO_UNET_XL, TC.TANGO_UNET_XL), (JC.TANGO_STFT, TC.TANGO_STFT),
             (JC.DiffusionConfig(), TC.DiffusionConfig())]
    for jcfg, tcfg in pairs:
        assert type(tcfg).from_dict(jcfg.to_dict()) == tcfg
    assert TC.TANGO_UNET_XL.cross_attention_dim == 2048
