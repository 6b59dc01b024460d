"""Port models vs the JAX package on the CPU, on tiny configs.

Seeded random JAX parameter trees (tests/_torch_helpers.py) go through
`tango_tpu_torch.utils.convert.from_jax_params` into the port's modules, and
the same numpy inputs go through both. Everything is f32. Model tolerances
are those of tests/test_models_parity.py (atol 2e-4 / rtol 1e-3 for the UNet,
1e-4 / 1e-3 for the VAE and HiFi-GAN; the T5 encoder uses the VAE's); the
scheduler is elementwise f32 arithmetic on the same tables, held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu import configs as JC
from tango_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from tango_tpu.models.hifigan import waveform_to_int16 as jax_waveform_to_int16
from tango_tpu.models.t5 import T5Config as JT5Config
from tango_tpu.models.t5 import T5Encoder as JT5Encoder
from tango_tpu.models.unet import UNet2DConditionModel as JUNet
from tango_tpu.models.vae import AutoencoderKL as JVAE
from tango_tpu.schedulers.ddpm import DDPMScheduler as JDDPM
from tango_tpu_torch import configs as TC
from tango_tpu_torch.models.hifigan import HiFiGANGenerator, waveform_to_int16
from tango_tpu_torch.models.t5 import T5Encoder
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.models.vae import AutoencoderKL
from tango_tpu_torch.ops import attention as tattn
from tango_tpu_torch.schedulers.ddpm import DDPMScheduler
from tango_tpu_torch.utils.convert import from_jax_params

from tests._torch_helpers import random_jax_params

# tests/test_pipeline.py's tiny UNet with two layers a level (a mid block,
# a resnet shortcut and three skip concatenations per up level)
UNET_KW = dict(
    in_channels=8,
    out_channels=8,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(32, 64),
    layers_per_block=2,
    cross_attention_dim=24,
    attention_head_dim=(2, 4),
    norm_num_groups=8,
)
T5_KW = dict(vocab_size=128, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4)
VAE_KW = dict(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2), num_res_blocks=1,
              scale_factor=0.9)
HIFI_KW = dict(num_mels=8, upsample_initial_channel=32)

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)


def _load(module, jax_params, skip=()):
    module.load_state_dict(from_jax_params(jax_params, skip=skip))
    return module.eval()


def test_unet_matches_jax(monkeypatch):
    """A (32, 8) latent puts 256 tokens on level 0, so the UNet's
    self-attention takes the kernel path there and the plain path below."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 8, 8).astype(np.float32)
    t = np.array([10, 700], np.int64)
    ctx = rng.randn(2, 7, 24).astype(np.float32)
    mask = np.ones((2, 7), np.int64)
    mask[1, 4:] = 0

    jmodel = JUNet(JC.UNetConfig(**UNET_KW))
    params = random_jax_params(
        lambda k: jmodel.init(k, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))["params"], 0)
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(ctx), encoder_attention_mask=jnp.asarray(mask))

    flash_calls = []
    orig = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: flash_calls.append(a[0].shape) or orig(*a, **kw))
    model = _load(UNet2DConditionModel(TC.UNetConfig(**UNET_KW)), params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                    torch.from_numpy(mask))
    assert flash_calls and all(s[2] == 256 for s in flash_calls)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)


def test_t5_encoder_matches_jax():
    rng = np.random.RandomState(1)
    ids = rng.randint(2, 128, (2, 12))
    mask = np.ones((2, 12), np.int64)
    mask[0, 7:] = 0
    jmodel = JT5Encoder(JT5Config(**T5_KW))
    params = random_jax_params(
        lambda k: jmodel.init(k, jnp.asarray(ids), jnp.asarray(mask))["params"], 1)
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    model = _load(T5Encoder(TC.T5Config(**T5_KW)), params)
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)


def test_vae_decode_first_stage_matches_jax():
    rng = np.random.RandomState(2)
    z = rng.randn(2, 8, 4, 8).astype(np.float32)
    jmodel = JVAE(JC.VAEConfig(**VAE_KW))
    params = random_jax_params(
        lambda k: jmodel.init(k, jnp.zeros((1, 32, 16, 1)), k)["params"], 2)
    ref = jax.jit(lambda p, z: jmodel.apply({"params": p}, z, method=jmodel.decode_first_stage))(
        params, jnp.asarray(z))
    model = _load(AutoencoderKL(TC.VAEConfig(**VAE_KW)), params, skip=("encoder", "quant_conv"))
    with torch.no_grad():
        out = model.decode_first_stage(torch.from_numpy(z))
    assert out.shape == (2, 16, 8, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)


def test_hifigan_matches_jax():
    rng = np.random.RandomState(3)
    mel = rng.randn(2, 16, 8).astype(np.float32)
    jmodel = JHiFiGAN(JC.HiFiGANConfig(**HIFI_KW))
    params = random_jax_params(lambda k: jmodel.init(k, jnp.asarray(mel))["params"], 3)
    ref = np.array(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(mel)))
    model = _load(HiFiGANGenerator(TC.HiFiGANConfig(**HIFI_KW)), params)
    with torch.no_grad():
        out = model(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 16 * 160 + 32)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-3)
    np.testing.assert_array_equal(waveform_to_int16(torch.from_numpy(ref)),
                                  jax_waveform_to_int16(ref))


@pytest.mark.parametrize(
    "overrides",
    [
        dict(),  # SD-2.1: scaled_linear, v_prediction, fixed_small
        dict(beta_schedule="linear", prediction_type="epsilon", variance_type="fixed_large"),
        dict(beta_schedule="squaredcos_cap_v2", prediction_type="sample",
             variance_type="fixed_small_log", clip_sample=True),
        dict(beta_schedule="sigmoid", variance_type="fixed_large_log", thresholding=True),
        dict(variance_type="learned"),
        dict(variance_type="learned_range", prediction_type="epsilon"),
    ],
)
def test_ddpm_step_matches_jax(overrides):
    jcfg = JC.SchedulerConfig(**overrides)
    js = JDDPM.create(jcfg)
    ts = DDPMScheduler.create(TC.SchedulerConfig(**overrides))
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    np.testing.assert_array_equal(ts.timesteps(25), js.timesteps(25))
    rng = np.random.RandomState(4)
    sample = rng.randn(2, 8, 4, 8).astype(np.float32)
    noise = rng.randn(2, 8, 4, 8).astype(np.float32)
    learned = jcfg.variance_type in ("learned", "learned_range")
    out_ch = 16 if learned else 8
    model_out = rng.randn(2, 8, 4, out_ch).astype(np.float32)
    if learned:  # variance channels: positive for `learned`, a fraction for `learned_range`
        model_out[..., 8:] = rng.uniform(0.1, 0.9, (2, 8, 4, 8))
    for t in (960, 480, 40, 0):
        jp, jx0 = js.step(jnp.asarray(model_out), t, jnp.asarray(sample), jnp.asarray(noise), 25)
        tp, tx0 = ts.step(torch.from_numpy(model_out), t, torch.from_numpy(sample),
                          torch.from_numpy(noise), 25)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-5, rtol=1e-5)


def test_ddpm_forward_process_matches_jax():
    js, ts = JDDPM.create(), DDPMScheduler.create()
    rng = np.random.RandomState(5)
    x = rng.randn(3, 8, 4, 8).astype(np.float32)
    n = rng.randn(3, 8, 4, 8).astype(np.float32)
    t = np.array([0, 500, 999])
    for jf, tf in ((js.add_noise, ts.add_noise), (js.get_velocity, ts.get_velocity)):
        np.testing.assert_allclose(
            tf(torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(t)).numpy(),
            np.asarray(jf(jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))),
            atol=1e-6, rtol=1e-6)


def test_release_configs_rebuild_from_jax():
    """The port's config constants equal the JAX ones, field by field."""
    from tango_tpu.models.t5 import FLAN_T5_LARGE as J_FLAN

    pairs = [(JC.TANGO_UNET, TC.TANGO_UNET), (JC.TANGO_VAE, TC.TANGO_VAE),
             (JC.TANGO_HIFIGAN, TC.TANGO_HIFIGAN), (JC.SD21_SCHEDULER, TC.SD21_SCHEDULER),
             (J_FLAN, TC.FLAN_T5_LARGE)]
    for jcfg, tcfg in pairs:
        assert type(tcfg).from_dict(jcfg.to_dict()) == tcfg
