"""The port's text-to-audio slice vs the JAX pipeline, and its own contracts.

The end-to-end test builds JAX `Tango.from_components` and the port's from
the same tiny parameter trees and tokenizer, runs `AudioDiffusion.sample` on
both with the same `noise_override`, then the decode. All f32 on the CPU;
tolerances: text embeddings and latents atol 2e-4 / rtol 1e-3 (the UNet
parity tolerance of tests/test_models_parity.py), the float waveform atol
1e-4 / rtol 1e-3 (its HiFi-GAN tolerance).
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu import configs as JC
from tango_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from tango_tpu.models.t5 import T5Config as JT5Config
from tango_tpu.models.t5 import T5Encoder as JT5Encoder
from tango_tpu.models.unet import UNet2DConditionModel as JUNet
from tango_tpu.models.vae import AutoencoderKL as JVAE
from tango_tpu.pipeline import Tango as JTango
from tango_tpu_torch import configs as TC
from tango_tpu_torch.ops import attention as tattn
from tango_tpu_torch.pipeline import Tango
from tango_tpu_torch.tokenizer import WordHashTokenizer
from tango_tpu_torch.utils.convert import from_jax_params

from tests._torch_helpers import random_jax_params

REPO = pathlib.Path(__file__).resolve().parents[1]

UNET_KW = dict(
    in_channels=8,
    out_channels=8,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_dim=16,
    attention_head_dim=(2, 4),
    norm_num_groups=8,
)
VAE_KW = dict(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2), num_res_blocks=1,
              scale_factor=0.9)
T5_KW = dict(vocab_size=128, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4)
HIFI_KW = dict(num_mels=8, upsample_initial_channel=32)
# latent (64, 4): 256 tokens on level 0, so self-attention takes the kernel path;
# the tiny VAE doubles F to the vocoder's 8 mel bins
LT, LF = 64, 4

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_params():
    return dict(
        unet=random_jax_params(lambda k: JUNet(JC.UNetConfig(**UNET_KW)).init(
            k, jnp.zeros((1, LT, LF, 8)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 2, 16)))["params"], 0),
        vae=random_jax_params(lambda k: JVAE(JC.VAEConfig(**VAE_KW)).init(
            k, jnp.zeros((1, 32, 16, 1)), k)["params"], 1),
        t5=random_jax_params(lambda k: JT5Encoder(JT5Config(**T5_KW)).init(
            k, jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))["params"], 2),
        hifi=random_jax_params(lambda k: JHiFiGAN(JC.HiFiGANConfig(**HIFI_KW)).init(
            k, jnp.zeros((1, 8, 8)))["params"], 3),
    )


@pytest.fixture(scope="module")
def port(jax_params):
    return Tango.from_components(
        unet_config=TC.UNetConfig(**UNET_KW), vae_config=TC.VAEConfig(**VAE_KW),
        t5_config=TC.T5Config(**T5_KW), hifigan_config=TC.HiFiGANConfig(**HIFI_KW),
        unet_params=from_jax_params(jax_params["unet"]),
        vae_params=from_jax_params(jax_params["vae"], skip=("encoder", "quant_conv")),
        t5_params=from_jax_params(jax_params["t5"]),
        hifigan_params=from_jax_params(jax_params["hifi"]),
        device="cpu", latent_t_size=LT, latent_f_size=LF,
    )


@pytest.fixture(scope="module")
def jt(jax_params):
    return JTango.from_components(
        unet_config=JC.UNetConfig(**UNET_KW), vae_config=JC.VAEConfig(**VAE_KW),
        unet_params=jax_params["unet"], vae_params=jax_params["vae"],
        t5_config=JT5Config(**T5_KW), t5_params=jax_params["t5"],
        hifigan_config=JC.HiFiGANConfig(**HIFI_KW), hifigan_params=jax_params["hifi"],
        tokenizer=WordHashTokenizer(vocab_size=128), latent_t_size=LT, latent_f_size=LF,
    )


def test_slice_matches_jax(jt, port):
    prompts = ["a dog barks in the park", "rain on a tin roof"]
    steps = 3
    rng = np.random.RandomState(0)
    init = rng.randn(2, LT, LF, 8).astype(np.float32)
    noises = rng.randn(steps, 2, LT, LF, 8).astype(np.float32)

    j_cond, j_mask = jt.encode_text(prompts)
    j_unc, j_umask = jt.encode_text([""] * 2)
    j_lat = jt.model.sample(jt.unet_params, j_cond, j_mask, jax.random.PRNGKey(0),
                            num_steps=steps, guidance_scale=3.0, uncond_embeds=j_unc,
                            uncond_mask=j_umask, noise_override=(init, noises))
    j_mel, j_wav = jt._decode_fn()(jt.vae_params, jt.hifigan_params, j_lat)

    p_cond, p_mask = port.encode_text(prompts)
    p_unc, p_umask = port.encode_text([""] * 2)
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(p_cond.numpy(), np.asarray(j_cond), atol=2e-4, rtol=1e-3)
    p_lat = port.model.sample(p_cond, p_mask, num_steps=steps, guidance_scale=3.0,
                              uncond_embeds=p_unc, uncond_mask=p_umask,
                              noise_override=(torch.from_numpy(init), torch.from_numpy(noises)))
    np.testing.assert_allclose(p_lat.numpy(), np.asarray(j_lat), atol=2e-4, rtol=1e-3)

    p_mel, p_wav = port.decode(torch.from_numpy(np.array(j_lat)))
    assert p_wav.shape == j_wav.shape == (2, 2 * LT * 160 + 32)
    np.testing.assert_allclose(p_mel.numpy(), np.asarray(j_mel), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(p_wav.numpy(), np.asarray(j_wav), atol=1e-4, rtol=1e-3)


def _generate_both(jt, port, monkeypatch, steps, latent_t, **kw):
    """`generate(PROMPT, **kw)` through both packages with the same seeded
    noise (`noise_override`) for a latent length of `latent_t`; returns the
    (latents, float waveform) pairs the two decodes saw, and the int16
    waveforms."""
    rng = np.random.RandomState(1)
    init = rng.randn(1, latent_t, LF, 8).astype(np.float32)
    noises = rng.randn(steps, 1, latent_t, LF, 8).astype(np.float32)
    seen = {}

    def j_sample_fn(num_steps, cfg, latent_t_size=None):
        assert cfg and latent_t_size in (None, latent_t)

        def f(unet_params, cond, cond_mask, uncond, uncond_mask, rng_key, guidance):
            return jt.model.sample(unet_params, cond, cond_mask, rng_key, num_steps=num_steps,
                                   guidance_scale=guidance, uncond_embeds=uncond,
                                   uncond_mask=uncond_mask, latent_t_size=latent_t_size,
                                   noise_override=(init, noises))
        return f

    j_decode = jt._decode_fn()

    def j_decode_fn():
        def f(vae_params, hifigan_params, latents):
            mel, wav = j_decode(vae_params, hifigan_params, latents)
            seen["jax"] = (np.asarray(latents), np.asarray(wav))
            return mel, wav
        return f

    p_sample, p_decode = port.model.sample, port.decode

    def p_sample_spy(*a, **k):
        return p_sample(*a, noise_override=(torch.from_numpy(init), torch.from_numpy(noises)),
                        **k)

    def p_decode_spy(latents):
        mel, wav = p_decode(latents)
        seen["port"] = (latents.numpy(), wav.numpy())
        return mel, wav

    monkeypatch.setattr(jt, "_sample_fn", j_sample_fn)
    monkeypatch.setattr(jt, "_decode_fn", j_decode_fn)
    monkeypatch.setattr(port.model, "sample", p_sample_spy)
    monkeypatch.setattr(port, "decode", p_decode_spy)
    j_wav = jt.generate("a dog barks", steps=steps, seed=0, **kw)
    p_wav = port.generate("a dog barks", steps=steps, seed=0, **kw)
    return seen, j_wav, p_wav


def _spy_kernel(monkeypatch, name):
    calls = []
    fn = getattr(tattn, name)
    monkeypatch.setattr(tattn, name, lambda *a, **k: calls.append(a[0].shape) or fn(*a, **k))
    return calls


def test_long_clip_matches_jax(jt, port, monkeypatch):
    """generate(duration=45.0): 1152 latent frames on the 2-level tiny UNet,
    so level 0 has 1152 x 4 = 4608 tokens, over 4096 and a multiple of 512:
    the port's self-attention there takes the blocked-KV kernel's route
    (attn_fwd_v2; JAX would take flash_attention_v2 on a TPU and XLA here),
    and the clip equals JAX's under the same noise."""
    calls = _spy_kernel(monkeypatch, "attn_fwd_v2")
    seen, j_wav, p_wav = _generate_both(jt, port, monkeypatch, 2, 1152, duration=45.0)
    assert calls and all(shape[1] == 4608 for shape in calls)
    (j_lat, j_float), (p_lat, p_float) = seen["jax"], seen["port"]
    assert p_lat.shape == j_lat.shape == (1, 1152, LF, 8)
    np.testing.assert_allclose(p_lat, j_lat, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(p_float, j_float, atol=1e-4, rtol=1e-3)
    assert p_wav.dtype == j_wav.dtype == np.int16
    assert p_wav.shape == j_wav.shape == (2 * 1152 * 160 + 32,)


def test_long_prompt_matches_jax(jt, port, monkeypatch):
    """max_text_length = 256: the UNet's masked cross-attention at the
    256-token level has 256 keys, so it takes the biased kernel's route
    (attn_fwd_bias; JAX's `_attn_kernel_bias` on a TPU), and the clip equals
    JAX's under the same noise."""
    monkeypatch.setattr(jt, "max_text_length", 256)
    monkeypatch.setattr(port, "max_text_length", 256)
    calls = _spy_kernel(monkeypatch, "attn_fwd_bias")
    seen, j_wav, p_wav = _generate_both(jt, port, monkeypatch, 3, LT)
    assert calls and all(shape[1:] == (LT * LF, 16) for shape in calls)
    (j_lat, j_float), (p_lat, p_float) = seen["jax"], seen["port"]
    np.testing.assert_allclose(p_lat, j_lat, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(p_float, j_float, atol=1e-4, rtol=1e-3)
    assert p_wav.shape == j_wav.shape == (2 * LT * 160 + 32,)


def test_generate_shapes_and_batch_row_matches_single(port):
    single = port.generate("a dog barks", steps=2, seed=11)
    assert single.dtype == np.int16 and single.shape == (2 * LT * 160 + 32,)
    batched = port.generate_for_batch(["a dog barks", "rain falls"], steps=2, batch_size=2,
                                      seed=11)
    # int16 scale; batched and unbatched CPU matmuls may differ in the last bits
    np.testing.assert_allclose(batched[0].astype(np.float32), single.astype(np.float32),
                               atol=2.0)
    assert not np.array_equal(batched[0], batched[1])


def test_tail_chunk_pads_to_full_batch(port, monkeypatch):
    seen = []
    orig = port._generate_batch

    def spy(prompts, *a, **kw):
        seen.append(len(prompts))
        return orig(prompts, *a, **kw)

    monkeypatch.setattr(port, "_generate_batch", spy)
    outs = port.generate_for_batch([f"p{i}" for i in range(5)], steps=2, batch_size=4, seed=3)
    assert seen == [4, 4] and len(outs) == 5
    # row 4 equals the tail chunk run unpadded with the same seed and chunk index
    ref = orig(["p4"], 2, 3.0, 1, 3, 1)
    np.testing.assert_allclose(outs[4].astype(np.float32), ref[0].astype(np.float32), atol=2.0)
    seen.clear()
    port.generate_for_batch(["a", "b", "c"], steps=2, batch_size=8)
    assert seen == [3]  # no full chunk: the caller's own size


def test_seed_varies_across_chunks_and_reproduces(port):
    a = port.generate_for_batch(["same prompt"] * 2, steps=2, batch_size=1, seed=7)
    b = port.generate_for_batch(["same prompt"] * 2, steps=2, batch_size=1, seed=7)
    assert not np.array_equal(a[0], a[1])
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_samples_and_duration(port):
    multi = port.generate("x", steps=2, samples=2, seed=1)
    assert multi.shape[0] == 2 and not np.array_equal(multi[0], multi[1])
    # 2-level UNet -> factor 2; 0.5 s -> 12 latent frames -> 24 mel frames
    assert port.generate("short", steps=2, duration=0.5, seed=1).shape == (24 * 160 + 32,)
    grouped = port.generate_for_batch(["a", "b"], steps=2, samples=2, batch_size=2, seed=1)
    assert len(grouped) == 2 and all(len(g) == 2 for g in grouped)


def test_not_ported_options_raise():
    # snapshot loading is ported (tests/test_torch_snapshot.py); a hub name
    # is not a directory, and the port downloads nothing
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        Tango("declare-lab/tango", device="cpu")
    # int8 serving is ported (tests/test_torch_quant.py); an unknown scope raises
    assert Tango(device="cpu", quant="conv").quant == "conv"
    with pytest.raises(ValueError, match="quant must be"):
        Tango(device="cpu", quant="int8")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Tango()
    with pytest.raises(RuntimeError, match="CUDA"):
        Tango.from_components(unet_config=TC.UNetConfig(**UNET_KW),
                              vae_config=TC.VAEConfig(**VAE_KW))


def test_tokenizer_pads_truncates_and_appends_eos():
    tok = WordHashTokenizer(vocab_size=50)
    out = tok(["one two three four five", ""], max_length=4)
    ids, mask = out["input_ids"], out["attention_mask"]
    assert ids.shape == mask.shape == (2, 4)
    assert ids[0, 3] == 1 and mask[0].tolist() == [1, 1, 1, 1]  # 3 words + EOS
    assert ids[1].tolist() == [1, 0, 0, 0] and mask[1].tolist() == [1, 0, 0, 0]
    assert ((ids[0, :3] >= 2) & (ids[0, :3] < 50)).all()
    np.testing.assert_array_equal(tok(["one two"], max_length=4)["input_ids"][0, :2],
                                  ids[0, :2])


def test_import_hygiene():
    """Importing the port (every module, the evaluation, CLAP's, Mustango's
    and its DeBERTa, AudioLDM's pipeline and CLI, the registry, the EMA, the
    device mesh, the audio decoders and the profiling module included),
    chip_smoke and examples/demo_torch.py loads no JAX, no JAX package and no
    transformers / huggingface_hub / sklearn / sentencepiece."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import tango_tpu_torch, chip_smoke\n"
        "sys.path.insert(0, 'examples')\n"
        "import demo_torch\n"
        "for m in pkgutil.walk_packages(tango_tpu_torch.__path__, 'tango_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'tango_tpu', 'transformers', 'huggingface_hub',\n"
        "              'sklearn', 'sentencepiece'))\n"
        "assert 'tango_tpu_torch.eval.evaluator' in sys.modules\n"
        "assert 'tango_tpu_torch.inference_tango2' in sys.modules\n"
        "assert 'tango_tpu_torch.pipeline_music' in sys.modules\n"
        "assert 'tango_tpu_torch.models.deberta' in sys.modules\n"
        "for m in ('audioldm.pipeline', 'audioldm.cli', 'registry', 'utils.ema',\n"
        "          'models.audioldm_unet', 'schedulers.ddim', 'parallel.mesh',\n"
        "          'parallel.dryrun', 'parallel.launch', 'audio.flac', 'audio.flac_native',\n"
        "          'audio.mp3', 'audio.mp3_tables', 'audio.vorbis', 'audio.aiff', 'audio.opus',\n"
        "          'utils.profiling'):\n"
        "    assert 'tango_tpu_torch.' + m in sys.modules, m\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
