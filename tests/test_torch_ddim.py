"""The port's DDIM scheduler (tango_tpu_torch/schedulers/ddim.py) against
JAX's and the reference's schedulers golden, and AudioDiffusion.sample with
scheduler="ddim" against JAX's through the same noise_override. f32 on the
CPU; tolerances: the golden's 1e-4 (tests/test_schedulers.py) and 1e-5 for
thresholding, JAX's own tables to 1e-7, one step against JAX's to 1e-6, and
the sampler's latents the slice's 2e-4 / 1e-3 (tests/test_torch_pipeline.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu import configs as JC
from tango_tpu.models.diffusion import AudioDiffusion as JAudioDiffusion
from tango_tpu.models.unet import UNet2DConditionModel as JUNet
from tango_tpu.schedulers import DDIMScheduler as JDDIM
from tango_tpu_torch import configs as TC
from tango_tpu_torch.models.diffusion import AudioDiffusion
from tango_tpu_torch.schedulers import DDIMScheduler
from tango_tpu_torch.utils.convert import from_jax_params

from tests._torch_helpers import random_jax_params
from tests.conftest import load_golden

torch.set_num_threads(1)

# every beta schedule and prediction type the JAX tests cover, and AudioLDM's
SCHED_KW = {
    "sd21": {},
    "eps_linear": dict(beta_start=0.0001, beta_end=0.02, beta_schedule="linear",
                       prediction_type="epsilon", clip_sample=True),
    "audioldm": dict(beta_start=0.0015, beta_end=0.0195, beta_schedule="scaled_linear",
                     prediction_type="epsilon"),
    "sample_cos": dict(beta_schedule="squaredcos_cap_v2", prediction_type="sample",
                       set_alpha_to_one=True),
    "sigmoid_thresh": dict(beta_start=0.0001, beta_end=0.02, beta_schedule="sigmoid",
                           prediction_type="epsilon", thresholding=True,
                           dynamic_thresholding_ratio=0.9, sample_max_value=0.5),
}


def both(name):
    return (DDIMScheduler.create(TC.SchedulerConfig(**SCHED_KW[name])),
            JDDIM.create(JC.SchedulerConfig(**SCHED_KW[name])))


@pytest.mark.parametrize("name", list(SCHED_KW))
def test_tables_and_timesteps_match_jax(name):
    ours, theirs = both(name)
    np.testing.assert_allclose(ours.betas.numpy(), np.asarray(theirs.betas), atol=1e-7)
    np.testing.assert_array_equal(ours.alphas_cumprod.numpy(), np.asarray(theirs.alphas_cumprod))
    assert float(ours.final_alpha_cumprod) == float(theirs.final_alpha_cumprod)
    for n in (1, 10, 200, 1000):
        np.testing.assert_array_equal(ours.timesteps(n), theirs.timesteps(n))
    with pytest.raises(ValueError, match="num_train_timesteps"):
        ours.timesteps(1001)


@pytest.mark.parametrize("name", list(SCHED_KW))
@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("steps,t", [(10, 901), (10, 1), (200, 996), (50, 21)])
def test_step_matches_jax(name, eta, steps, t):
    """One step at the grid's top, at its last step (prev_t < 0: the final
    alpha) and inside, with the same injected noise."""
    ours, theirs = both(name)
    rng = np.random.RandomState(t)
    x, out, noise = (rng.randn(2, 4, 8, 2).astype(np.float32) for _ in range(3))
    p_prev, p_x0 = ours.step(torch.from_numpy(out), t, torch.from_numpy(x),
                             torch.from_numpy(noise), steps, eta=eta)
    j_prev, j_x0 = theirs.step(out, t, x, noise, steps, eta=eta)
    np.testing.assert_allclose(p_x0.numpy(), np.asarray(j_x0), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(p_prev.numpy(), np.asarray(j_prev), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["sd21", "audioldm"])
def test_add_noise_matches_jax(name):
    ours, theirs = both(name)
    rng = np.random.RandomState(5)
    x, noise = (rng.randn(3, 4, 8, 2).astype(np.float32) for _ in range(2))
    ts = np.array([1, 500, 999])
    got = ours.add_noise(torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs.add_noise(x, noise, ts)),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["sd21", "eps_linear"])
def test_golden_timesteps_and_step701(name):
    g = load_golden("schedulers")
    s, _ = both(name)
    np.testing.assert_array_equal(s.timesteps(10), g[f"{name}_ddim_timesteps"])
    prev, _ = s.step(torch.from_numpy(g[f"{name}_model_out"]), 701,
                     torch.from_numpy(g[f"{name}_x"]),
                     torch.zeros_like(torch.from_numpy(g[f"{name}_x"])), 10, eta=0.0)
    np.testing.assert_allclose(prev.numpy(), g[f"{name}_ddim_step701"], atol=1e-4, rtol=1e-4)


def test_golden_thresholded_step701():
    g = load_golden("schedulers")
    s = DDIMScheduler.create(TC.SchedulerConfig(
        beta_start=0.0001, beta_end=0.02, beta_schedule="linear", prediction_type="epsilon",
        clip_sample=False, thresholding=True, dynamic_thresholding_ratio=0.9,
        sample_max_value=0.5, set_alpha_to_one=False, steps_offset=1))
    prev, _ = s.step(torch.from_numpy(g["thresh_model_out"]), 701,
                     torch.from_numpy(g["thresh_x"]), torch.zeros(2, 4, 8), 10, eta=0.0)
    np.testing.assert_allclose(prev.numpy(), g["thresh_ddim_step701"], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------- AudioDiffusion.sample

UNET_KW = dict(in_channels=8, out_channels=8,
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
               block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=16,
               attention_head_dim=(2, 4), norm_num_groups=8)
LT, LF = 8, 4


@pytest.fixture(scope="module")
def unet_params():
    return random_jax_params(lambda k: JUNet(JC.UNetConfig(**UNET_KW)).init(
        k, jnp.zeros((1, LT, LF, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 2, 16)))["params"], 0)


@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("name", ["sd21", "audioldm"])
def test_sample_ddim_matches_jax(unet_params, eta, name):
    steps = 3
    jd = JAudioDiffusion(JC.UNetConfig(**UNET_KW), JC.SchedulerConfig(**SCHED_KW[name]),
                         latent_t_size=LT, latent_f_size=LF)
    pd = AudioDiffusion(TC.UNetConfig(**UNET_KW), TC.SchedulerConfig(**SCHED_KW[name]),
                        latent_t_size=LT, latent_f_size=LF, device="cpu")
    pd.unet.load_state_dict(from_jax_params(unet_params))
    rng = np.random.RandomState(2)
    cond, unc = (rng.randn(2, 5, 16).astype(np.float32) for _ in range(2))
    mask = np.ones((2, 5), np.int64)
    mask[1, 3:] = 0
    init = rng.randn(2, LT, LF, 8).astype(np.float32)
    noises = rng.randn(steps, 2, LT, LF, 8).astype(np.float32)
    j_lat = jd.sample(unet_params, cond, mask, jax.random.PRNGKey(0), num_steps=steps,
                      guidance_scale=2.5, uncond_embeds=unc, uncond_mask=mask,
                      scheduler="ddim", eta=eta, noise_override=(init, noises))
    p_lat = pd.sample(torch.from_numpy(cond), torch.from_numpy(mask), num_steps=steps,
                      guidance_scale=2.5, uncond_embeds=torch.from_numpy(unc),
                      uncond_mask=torch.from_numpy(mask), scheduler="ddim", eta=eta,
                      noise_override=(torch.from_numpy(init), torch.from_numpy(noises)))
    np.testing.assert_allclose(p_lat.numpy(), np.asarray(j_lat), atol=2e-4, rtol=1e-3)
    if eta == 0.0:
        # deterministic: other step noise changes nothing
        p2 = pd.sample(torch.from_numpy(cond), torch.from_numpy(mask), num_steps=steps,
                       guidance_scale=2.5, uncond_embeds=torch.from_numpy(unc),
                       uncond_mask=torch.from_numpy(mask), scheduler="ddim", eta=eta,
                       noise_override=(torch.from_numpy(init), torch.zeros(noises.shape)))
        assert torch.equal(p2, p_lat)
