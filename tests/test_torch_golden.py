"""The port's modules against the reference's own outputs.

The goldens in tests/golden/*.npz were captured from the reference's torch
modules: the weights under the reference's names (`sd::` keys), the inputs
and the outputs. Here the weights go through the port's reference-name
converters (tango_tpu_torch/utils/convert.py, models/t5.py) into the port's
modules with a strict `load_state_dict`, f32 on the CPU, and the outputs are
held to the tolerances the JAX package's tests use for the same files
(tests/test_models_parity.py, test_t5.py, test_diffusion.py,
test_schedulers.py). Goldens are NCHW; the port's public layouts are NHWC,
as JAX's.
"""

import numpy as np
import pytest
import torch

from tango_tpu_torch import configs as TC
from tango_tpu_torch.models.diffusion import AudioDiffusion
from tango_tpu_torch.models.hifigan import HiFiGANGenerator
from tango_tpu_torch.models.t5 import T5Encoder, convert_t5_encoder
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.models.vae import AutoencoderKL
from tango_tpu_torch.schedulers.ddpm import DDPMScheduler, make_betas
from tango_tpu_torch.utils.convert import convert_hifigan, convert_unet, convert_vae

from tests.conftest import load_golden

torch.set_num_threads(1)

# the configs the goldens were captured with (tests/test_models_parity.py,
# tests/test_t5.py)
TINY_UNET = TC.UNetConfig(
    in_channels=8,
    out_channels=8,
    down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(32, 64, 64),
    layers_per_block=2,
    cross_attention_dim=24,
    attention_head_dim=(2, 4, 4),
    use_linear_projection=True,
    upcast_attention=True,
    norm_num_groups=8,
)
TINY_VAE = TC.VAEConfig(embed_dim=4, z_channels=4, resolution=32, ch=32, ch_mult=(1, 2),
                        num_res_blocks=1)
TINY_HIFI = TC.HiFiGANConfig(num_mels=8, upsample_initial_channel=64)
TINY_T5 = TC.T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=48, num_layers=3, num_heads=4,
                      relative_attention_num_buckets=8, relative_attention_max_distance=16)


def reference_sd(g) -> dict:
    return {k[4:]: torch.from_numpy(np.array(g[k], np.float32)) for k in g.files
            if k.startswith("sd::")}


def nhwc(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))))


def nchw(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 3, 1, 2).numpy()


def load(module: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    module.load_state_dict(state_dict)  # strict: every key, no more
    return module.eval()


@pytest.mark.parametrize("masked", [True, False], ids=["out", "out_nomask"])
def test_unet_matches_reference(masked):
    g = load_golden("unet_tiny")
    unet = load(UNet2DConditionModel(TINY_UNET), convert_unet(reference_sd(g)))
    mask = torch.from_numpy(g["mask"]) if masked else None
    with torch.no_grad():
        out = unet(nhwc(g["x"]), torch.from_numpy(g["t"]), torch.from_numpy(g["ehs"]), mask)
    ref = g["out"] if masked else g["out_nomask"]
    np.testing.assert_allclose(nchw(out), ref, atol=2e-4, rtol=1e-3)


def test_unet_parameter_count():
    """Every reference tensor lands in the converted state dict; fusion
    merges attn1's q, k, v (3 -> 1) and attn2's k, v (2 -> 1)."""
    sd = reference_sd(load_golden("unet_tiny"))
    converted = convert_unet(sd)
    n_attn1 = sum("attn1.to_q.weight" in k for k in sd)
    n_attn2 = sum("attn2.to_q.weight" in k for k in sd)
    assert len(converted) == len(sd) - 2 * n_attn1 - n_attn2
    assert set(converted) == set(UNet2DConditionModel(TINY_UNET).state_dict())


def test_vae_matches_reference():
    g = load_golden("vae_tiny")
    vae = load(AutoencoderKL(TINY_VAE, with_encoder=True),
               convert_vae(reference_sd(g), with_encoder=True))
    with torch.no_grad():
        mean, logvar = vae.encode_moments(nhwc(g["x"]))
        rec = vae.decode(nhwc(g["z"]))
    ref_mean, ref_logvar = np.split(g["moments"], 2, axis=1)
    np.testing.assert_allclose(nchw(mean), ref_mean, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(nchw(logvar), ref_logvar, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(nchw(rec), g["rec"], atol=1e-4, rtol=1e-3)


def test_hifigan_matches_reference():
    """The golden's generator is weight-normed: the converter folds it."""
    g = load_golden("hifigan_tiny")
    sd = reference_sd(g)
    assert any(k.endswith("weight_g") for k in sd)
    vocoder = load(HiFiGANGenerator(TINY_HIFI), convert_hifigan(sd))
    mel = torch.from_numpy(np.ascontiguousarray(np.transpose(g["mel"], (0, 2, 1))))
    with torch.no_grad():
        wav = vocoder(mel)
    np.testing.assert_allclose(wav.numpy(), g["wav"][:, 0, :], atol=1e-4, rtol=1e-3)


def test_t5_matches_reference_at_valid_positions():
    g = load_golden("t5_tiny")
    t5 = load(T5Encoder(TINY_T5), convert_t5_encoder(reference_sd(g)))
    with torch.no_grad():
        out = t5(torch.from_numpy(g["ids"]).long(), torch.from_numpy(g["mask"]).long())
    mask = g["mask"].astype(bool)  # padded positions are masked downstream
    np.testing.assert_allclose(out.numpy()[mask], g["out"][mask], atol=2e-4, rtol=1e-3)


def test_cfg_sampler_matches_reference_loop():
    """4 CFG DDPM steps of the reference loop, the same noise fed in."""
    g = load_golden("sampling_tiny")
    unet = load(UNet2DConditionModel(TINY_UNET), convert_unet(reference_sd(g)))
    diffusion = AudioDiffusion(unet, TC.SD21_SCHEDULER, latent_t_size=16, latent_f_size=4)
    step_noises = np.ascontiguousarray(np.transpose(g["step_noises"], (0, 1, 3, 4, 2)))
    out = diffusion.sample(
        torch.from_numpy(g["cond"]), torch.from_numpy(g["cond_mask"]), num_steps=4,
        guidance_scale=3.0, uncond_embeds=torch.from_numpy(g["uncond"]),
        uncond_mask=torch.from_numpy(g["uncond_mask"]),
        noise_override=(nhwc(g["init"]), torch.from_numpy(step_noises)))
    np.testing.assert_allclose(nchw(out), g["final"], atol=5e-4, rtol=1e-3)


SCHEDULERS = {
    "sd21": TC.SchedulerConfig(),
    "eps_linear": TC.SchedulerConfig(beta_start=0.0001, beta_end=0.02, beta_schedule="linear",
                                     prediction_type="epsilon", clip_sample=True),
}


def _t(g, key):
    return torch.from_numpy(g[key])


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_ddpm_matches_reference(name):
    g = load_golden("schedulers")
    s = DDPMScheduler.create(SCHEDULERS[name])
    np.testing.assert_allclose(s.betas.numpy(), g[f"{name}_betas"], atol=1e-7)
    np.testing.assert_array_equal(s.timesteps(10), g[f"{name}_timesteps"])
    ts = torch.tensor([3, 700])
    noisy = s.add_noise(_t(g, f"{name}_x0"), _t(g, f"{name}_noise"), ts)
    np.testing.assert_allclose(noisy.numpy(), g[f"{name}_noisy"], atol=1e-5)
    if name == "sd21":
        vel = s.get_velocity(_t(g, f"{name}_x0"), _t(g, f"{name}_noise"), ts)
        np.testing.assert_allclose(vel.numpy(), g[f"{name}_velocity"], atol=1e-5)
    prev, _ = s.step(_t(g, f"{name}_model_out"), 700, _t(g, f"{name}_x"),
                     _t(g, f"{name}_var_noise"), num_inference_steps=10)
    np.testing.assert_allclose(prev.numpy(), g[f"{name}_step700"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("vt", ["learned", "learned_range"])
def test_ddpm_learned_variance_matches_reference(vt):
    """(B, 2C) model outputs split on the last axis; t = 3 has prev_t < 0."""
    g = load_golden("schedulers")
    s = DDPMScheduler.create(TC.SchedulerConfig(
        beta_start=0.0001, beta_end=0.02, beta_schedule="linear", prediction_type="epsilon",
        clip_sample=False, variance_type=vt))
    for t in (700, 3):
        prev, _ = s.step(_t(g, f"{vt}_model_out"), t, _t(g, f"{vt}_x"), _t(g, f"{vt}_var_noise"),
                         num_inference_steps=10)
        assert torch.isfinite(prev).all()
        np.testing.assert_allclose(prev.numpy(), g[f"{vt}_step{t}"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("schedule", ["squaredcos_cap_v2", "sigmoid"])
def test_remaining_beta_schedules_match_reference(schedule):
    betas = make_betas(TC.SchedulerConfig(beta_start=0.0001, beta_end=0.02,
                                          beta_schedule=schedule))
    np.testing.assert_allclose(betas, load_golden("schedulers")[f"betas_{schedule}"], atol=1e-7)


def test_dynamic_thresholding_matches_reference():
    g = load_golden("schedulers")
    s = DDPMScheduler.create(TC.SchedulerConfig(
        beta_start=0.0001, beta_end=0.02, beta_schedule="linear", prediction_type="epsilon",
        clip_sample=False, thresholding=True, dynamic_thresholding_ratio=0.9,
        sample_max_value=0.5))
    prev, _ = s.step(_t(g, "thresh_model_out"), 700, _t(g, "thresh_x"),
                     _t(g, "thresh_var_noise"), num_inference_steps=10)
    np.testing.assert_allclose(prev.numpy(), g["thresh_step700"], atol=1e-5, rtol=1e-5)
