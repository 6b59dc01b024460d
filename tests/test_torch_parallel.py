"""The port's device mesh on 2 and 4 CPU ranks (gloo, one process a rank,
tests/_torch_mesh_child.py) against JAX's meshless functions on the same
numpy weights and inputs, or against the port's meshless run:

  * the UNet of tests/test_parallel.py:174-200 at model = 4, whose first
    level's 2 heads leave two ranks without a head, against JAX's forward at
    atol 1e-5; its shards gathered back bit-equal to the whole weights;
  * a 2 x 2 DP x TP SFT step against JAX's meshless `SFTTrainer.train_step`
    with JAX's draws, at tests/test_parallel.py:159-171's bounds: loss rtol
    2e-5; gradients rtol 2e-4, atol 1e-5; updated parameters rtol 1e-3,
    atol 2.5 lr (Adam's first step is about lr sign(g), so reduction-order
    noise on a near-zero gradient can move a parameter by up to 2 lr);
  * `Tango.generate_for_batch` at DP = 2 on 10 prompts at batch 8 (the tail
    chunk pads), and a batch-1 `generate` (replicated), against JAX's
    `Tango` fed the port's per-row noise, waveforms at atol 2.0
    (tests/test_parallel.py:254-306);
  * `Mustango` at TP = 2 and `AudioLDMPipeline` at DP = 2 (a batch of 3
    padded to 4) against their meshless runs, waveforms at atol 2.0;
  * one `DPOTrainer` step at DP = 2 against the meshless step (whose loss
    and gradients tests/test_torch_dpo.py holds to JAX's): loss rtol 1e-4,
    the same implicit accuracy, parameters at the SFT step's bounds;
  * a tiny T5 encoder at TP = 2 against JAX's, at the pipeline test's
    text-embedding tolerance (atol 2e-4, rtol 1e-3).

Each launch of ranks has its own time limit, and each rank's process group
a 120 s timeout, so a hung collective cannot eat the suite's limit.
"""

import functools
import os
import pathlib
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tango_tpu import configs as JC
from tango_tpu.models.diffusion import AudioDiffusion as JAudioDiffusion
from tango_tpu.models.t5 import T5Config as JT5Config
from tango_tpu.models.t5 import T5Encoder as JT5Encoder
from tango_tpu.models.unet import UNet2DConditionModel as JUNet
from tango_tpu.models.vae import AutoencoderKL as JVAE
from tango_tpu.train import sft as jsft
from tango_tpu_torch import configs as TC
from tango_tpu_torch.audioldm import pipeline as pl
from tango_tpu_torch.configs import DPOConfig
from tango_tpu_torch.models import audioldm_unet as film
from tango_tpu_torch.models.dpo import DPOAudioDiffusion, make_reference
from tango_tpu_torch.models.vae import AutoencoderKL
from tango_tpu_torch.parallel.launch import check, launch
from tango_tpu_torch.parallel.mesh import split_span
from tango_tpu_torch.pipeline import _row_seed
from tango_tpu_torch.pipeline_music import Mustango
from tango_tpu_torch.train.dpo import DPOTrainer
from tango_tpu_torch.utils.convert import from_jax_params
from tango_tpu_torch.utils.init import init_random_

from tests._torch_helpers import random_jax_params
from tests._torch_mesh_child import FixedConditioner
from tests.test_torch_audioldm import FILM_KW, HIFI_KW as A_HIFI_KW, LT as A_LT, LF as A_LF
from tests.test_torch_audioldm import VAE_KW as A_VAE_KW
from tests.test_torch_pipeline import HIFI_KW, LF, LT, T5_KW, UNET_KW, VAE_KW
from tests.test_torch_pipeline_music import MUSIC_KW
from tests.test_torch_train import LOSS_UNET
from tests.test_torch_train import VAE_KW as TRAIN_VAE_KW

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CHILD = str(REPO / "tests" / "_torch_mesh_child.py")
LAUNCH_TIMEOUT_S = 240

# tests/test_parallel.py's tiny UNet
PAR_UNET = dict(in_channels=4, out_channels=4,
                down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                block_out_channels=(16, 32), layers_per_block=1, cross_attention_dim=16,
                attention_head_dim=(2, 4), norm_num_groups=8)
PAR_VAE = dict(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2), num_res_blocks=1)
GEN = dict(prompts=[f"q{i}" for i in range(10)], steps=2, batch_size=8, seed=7)
MUSIC_CALL = dict(prompts=["jazz", "slow piano", "fast drums"], steps=2, guidance=3.0,
                  batch_size=2, seed=1,
                  beats=[[[[0.5, 1.0, 1.5], [1.0, 2.0, 3.0]]]] * 3,
                  chords=[["Gm", "F7"], ["C"], ["Am", "Dm"]],
                  chords_times=[[0.46, 1.39], [0.0], [0.3, 2.0]])
AUDIOLDM_CALL = dict(text="a cat meows", duration=A_LT / 25.6, ddim_steps=3, batchsize=3,
                     n_candidate_gen_per_text=1, seed=5)
DPO_LR = 1e-4
DPO_BETA = 2000.0


# ------------------------------------------------------------------ the jobs

def _par_unet_case():
    """The job, and a function computing JAX's reference."""
    cfg = JC.UNetConfig(**PAR_UNET)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 4, 4).astype(np.float32)
    t = np.array([5, 500])
    c = rng.randn(2, 6, 16).astype(np.float32)
    params = random_jax_params(lambda k: JUNet(cfg).init(
        k, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c))["params"], 2)
    job = dict(cfg=TC.UNetConfig(**PAR_UNET), sd=from_jax_params(params), x=torch.from_numpy(x),
               t=torch.from_numpy(t), c=torch.from_numpy(c), model=4)
    return job, lambda: np.asarray(jax.jit(JUNet(cfg).apply)({"params": params}, x, t, c))


def _sft_case():
    """The draws JAX's meshless step (tests/test_parallel.py:116-171) makes
    from its key, for the port's 2 x 2 step on the same numpy weights, and a
    function computing that step."""
    diff = JAudioDiffusion(JC.UNetConfig(**PAR_UNET), latent_t_size=8, latent_f_size=4)
    vae = JVAE(JC.VAEConfig(**PAR_VAE))
    params = random_jax_params(lambda k: diff.unet.init(
        k, jnp.zeros((1, 8, 4, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5, 16)))["params"],
        5)
    vae_params = random_jax_params(lambda k: vae.init(k, jnp.zeros((1, 16, 8, 1)), k)["params"], 6)
    rng = np.random.RandomState(1)
    batch = {"fbank": (rng.randn(8, 16, 8) * 0.1).astype(np.float32),
             "text_embeds": (rng.randn(8, 5, 16) * 0.02).astype(np.float32),
             "text_mask": np.ones((8, 5), np.int32)}
    tc = JC.TrainConfig(gradient_accumulation_steps=1)
    key = jax.random.PRNGKey(3)
    k_vae, k_loss = jax.random.split(key)

    def step_loss(p):
        lat = vae.apply({"params": vae_params}, jnp.asarray(batch["fbank"])[..., None], k_vae,
                        method=vae.encode_first_stage)
        return diff.loss(p, jax.lax.stop_gradient(lat), batch["text_embeds"],
                         batch["text_mask"], k_loss)

    def reference():
        # SFTTrainer.train_step's body (tango_tpu/train/sft.py): the value and
        # gradient of its loss, then its optimizer's update
        loss, grads = jax.jit(jax.value_and_grad(step_loss))(params)
        tx = jsft.make_optimizer(tc, 10)
        new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
            grads, params)
        return {"loss": float(loss), "grads": from_jax_params(jax.device_get(grads)),
                "params": from_jax_params(jax.device_get(new)), "lr": tc.learning_rate}
    mean = jax.eval_shape(lambda x: vae.apply({"params": vae_params}, x,
                                              method=vae.encode_moments)[0],
                          jnp.asarray(batch["fbank"])[..., None])
    k_t, k_noise, _ = jax.random.split(k_loss, 3)
    draws = {"posterior": np.array(jax.random.normal(k_vae, mean.shape, mean.dtype)),
             "timesteps": np.array(jax.random.randint(k_t, (8,), 0, 1000)),
             "noise": np.array(jax.random.normal(k_noise, mean.shape, jnp.float32))}
    job = dict(cfg=TC.UNetConfig(**PAR_UNET), vae_cfg=TC.VAEConfig(**PAR_VAE),
               sd=from_jax_params(params), vae_sd=from_jax_params(vae_params),
               batch={k: torch.from_numpy(np.asarray(v, np.int64 if k == "text_mask" else None))
                      for k, v in batch.items()},
               draws={k: torch.from_numpy(v) for k, v in draws.items()}, lr=tc.learning_rate,
               snr_gamma=None, data=2, model=2)
    return job, reference


def _pipeline_kwargs():
    from tango_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN

    jparams = dict(
        unet=random_jax_params(lambda k: JUNet(JC.UNetConfig(**UNET_KW)).init(
            k, jnp.zeros((1, LT, LF, 8)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 2, 16)))["params"], 0),
        vae=random_jax_params(lambda k: JVAE(JC.VAEConfig(**VAE_KW)).init(
            k, jnp.zeros((1, 32, 16, 1)), k)["params"], 1),
        t5=random_jax_params(lambda k: JT5Encoder(JT5Config(**T5_KW)).init(
            k, jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))["params"], 2),
        hifi=random_jax_params(lambda k: JHiFiGAN(JC.HiFiGANConfig(**HIFI_KW)).init(
            k, jnp.zeros((1, 8, 8)))["params"], 3))
    kwargs = dict(
        unet_config=TC.UNetConfig(**UNET_KW), vae_config=TC.VAEConfig(**VAE_KW),
        t5_config=TC.T5Config(**T5_KW), hifigan_config=TC.HiFiGANConfig(**HIFI_KW),
        unet_params=from_jax_params(jparams["unet"]),
        vae_params=from_jax_params(jparams["vae"], skip=("encoder", "quant_conv")),
        t5_params=from_jax_params(jparams["t5"]),
        hifigan_params=from_jax_params(jparams["hifi"]), latent_t_size=LT, latent_f_size=LF)
    return jparams, kwargs


def _jax_generate(jparams):
    """JAX's Tango on the same weights, each chunk's sampler fed the noise the
    port's per-row generators draw: row r of chunk c from
    torch.Generator().manual_seed(_row_seed(seed, c, r)), the initial latents
    first, then one draw a step."""
    from tango_tpu.pipeline import Tango as JTango
    from tango_tpu_torch.tokenizer import WordHashTokenizer

    jt = JTango.from_components(
        unet_config=JC.UNetConfig(**UNET_KW), vae_config=JC.VAEConfig(**VAE_KW),
        unet_params=jparams["unet"], vae_params=jparams["vae"],
        t5_config=JT5Config(**T5_KW), t5_params=jparams["t5"],
        hifigan_config=JC.HiFiGANConfig(**HIFI_KW), hifigan_params=jparams["hifi"],
        tokenizer=WordHashTokenizer(vocab_size=128), latent_t_size=LT, latent_f_size=LF)
    chunk = [0]

    @functools.partial(jax.jit, static_argnums=(0, 1))
    def sample(num_steps, guidance, unet_params, cond, cond_mask, uncond, uncond_mask, rng_key,
               init, noises):
        return jt.model.sample(unet_params, cond, cond_mask, rng_key, num_steps=num_steps,
                               guidance_scale=guidance, uncond_embeds=uncond,
                               uncond_mask=uncond_mask, noise_override=(init, noises))

    def j_sample_fn(num_steps, cfg, latent_t_size=None):
        def f(unet_params, cond, cond_mask, uncond, uncond_mask, rng_key, guidance):
            init, noises = [], []
            for r in range(cond.shape[0]):
                g = torch.Generator().manual_seed(_row_seed(GEN["seed"], chunk[0], r))
                init.append(torch.randn((1, LT, LF, 8), generator=g))
                noises.append(torch.stack([torch.randn((1, LT, LF, 8), generator=g)
                                           for _ in range(num_steps)]))
            chunk[0] += 1
            return sample(num_steps, float(guidance), unet_params, cond, cond_mask, uncond,
                          uncond_mask, rng_key, torch.cat(init).numpy(),
                          torch.cat(noises, 1).numpy())
        return f

    jt._sample_fn = j_sample_fn
    outs = jt.generate_for_batch(GEN["prompts"], steps=GEN["steps"], batch_size=GEN["batch_size"],
                                 seed=GEN["seed"])
    chunk[0] = 0
    single = jt.generate(GEN["prompts"][0], steps=GEN["steps"], seed=GEN["seed"])
    return {"waveforms": outs, "single": single}


def _music_kwargs():
    from tests.test_pipeline import TINY_HIFI, TINY_T5, TINY_VAE

    return dict(unet_config=TC.UNetConfig(**MUSIC_KW),
                vae_config=TC.VAEConfig.from_dict(TINY_VAE.to_dict()),
                t5_config=TC.T5Config.from_dict(TINY_T5.to_dict()),
                hifigan_config=TC.HiFiGANConfig.from_dict(TINY_HIFI.to_dict()),
                latent_t_size=8, latent_f_size=4, init_seed=3)


def _audioldm_kwargs():
    from tango_tpu.models import audioldm_unet as jfilm
    from tango_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN

    trees = dict(
        unet=random_jax_params(lambda k: jfilm.FilmUNet(jfilm.FilmUNetConfig(**FILM_KW)).init(
            k, jnp.zeros((1, A_LT, A_LF, 8)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 32)))["params"], 0),
        vae=random_jax_params(lambda k: JVAE(JC.VAEConfig(**A_VAE_KW)).init(
            k, jnp.zeros((1, 16, 8, 1)), k)["params"], 1),
        hifi=random_jax_params(lambda k: JHiFiGAN(JC.HiFiGANConfig(**A_HIFI_KW)).init(
            k, jnp.zeros((1, 8, 8)))["params"], 2))
    return dict(unet_config=film.FilmUNetConfig(**FILM_KW), vae_config=TC.VAEConfig(**A_VAE_KW),
                hifigan_config=TC.HiFiGANConfig(**A_HIFI_KW),
                stft_config=TC.StftConfig(n_mel_channels=8), latent_f_size=A_LF,
                conditioner=FixedConditioner(
                    np.random.RandomState(5).randn(1, 32).astype(np.float32),
                    pl.StubClapConditioner(dim=32).unconditional_embed(1)),
                unet_params=from_jax_params(trees["unet"]),
                vae_params=from_jax_params(trees["vae"]),
                hifigan_params=from_jax_params(trees["hifi"]))


def _dpo_job():
    diff = DPOAudioDiffusion(TC.UNetConfig(**LOSS_UNET), device="cpu")
    init_random_(diff.unet, torch.Generator().manual_seed(1))
    vae = AutoencoderKL(TC.VAEConfig(**TRAIN_VAE_KW), with_encoder=True)
    init_random_(vae, torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(4)
    batch = {"fbank_w": torch.randn(4, 64, 16, generator=g) * 0.5,
             "fbank_l": torch.randn(4, 64, 16, generator=g) * 0.5,
             "text_embeds": torch.randn(4, 7, 16, generator=g) * 0.1,
             "text_mask": torch.ones(4, 7, dtype=torch.long)}
    return dict(cfg=TC.UNetConfig(**LOSS_UNET), vae_cfg=TC.VAEConfig(**TRAIN_VAE_KW),
                sd=diff.unet.state_dict(), vae_sd=vae.state_dict(), batch=batch, lr=DPO_LR,
                beta=DPO_BETA, seed=9)


def _dpo_meshless(j):
    diff = DPOAudioDiffusion(j["cfg"], remat=True, beta_dpo=j["beta"], uncondition=True,
                             device="cpu")
    diff.unet.load_state_dict(j["sd"])
    vae = AutoencoderKL(j["vae_cfg"], with_encoder=True)
    vae.load_state_dict(j["vae_sd"])
    trainer = DPOTrainer(diff, vae.eval(), DPOConfig(gradient_accumulation_steps=1,
                                                     learning_rate=j["lr"]), total_steps=4)
    ref = make_reference(diff.unet)
    state = trainer.init_state()
    state, loss, metrics = trainer.dpo_step(state, ref, j["batch"],
                                            torch.Generator().manual_seed(j["seed"]))
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "params": state.params.state_dict()}


def _t5_case():
    cfg = JT5Config(**T5_KW)
    rng = np.random.RandomState(7)
    ids = rng.randint(2, 128, (2, 6))
    mask = np.ones((2, 6), np.int64)
    mask[1, 4:] = 0
    params = random_jax_params(lambda k: JT5Encoder(cfg).init(
        k, jnp.zeros((1, 6), jnp.int32), jnp.ones((1, 6), jnp.int32))["params"], 8)
    job = dict(cfg=TC.T5Config(**T5_KW), sd=from_jax_params(params),
               ids=torch.from_numpy(ids), mask=torch.from_numpy(mask), model=2)
    return job, lambda: np.asarray(jax.jit(JT5Encoder(cfg).apply)({"params": params}, ids, mask))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's job written once; the 4-rank cases in one launch, the
    2-rank ones in another, in a thread while this process computes the
    references; each case's rank-0 result and its reference."""
    root = tmp_path_factory.mktemp("mesh")
    job, reference = {}, {}
    job["tp_forward"], reference["tp_forward"] = _par_unet_case()
    job["sft_step"], reference["sft_step"] = _sft_case()
    jparams, kwargs = _pipeline_kwargs()
    job["generate"] = dict(kwargs=kwargs, **GEN)
    reference["generate"] = lambda: _jax_generate(jparams)
    job["mustango"] = dict(kwargs=_music_kwargs(), call=MUSIC_CALL, model=2)
    reference["mustango"] = lambda: {"waveforms": Mustango.from_components(
        **job["mustango"]["kwargs"], device="cpu").generate_for_batch(**MUSIC_CALL)}
    job["audioldm"] = dict(kwargs=_audioldm_kwargs(), call=AUDIOLDM_CALL)
    reference["audioldm"] = lambda: {"waveforms": pl.text_to_audio(
        pl.AudioLDMPipeline(**job["audioldm"]["kwargs"], device="cpu"), **AUDIOLDM_CALL)}
    job["dpo_step"] = _dpo_job()
    reference["dpo_step"] = lambda: _dpo_meshless(job["dpo_step"])
    job["t5"], reference["t5"] = _t5_case()
    torch.save(job, root / "job.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    launched = {}

    def run():
        for world, cases in ((4, ["tp_forward", "sft_step"]),
                             (2, ["generate", "mustango", "audioldm", "dpo_step", "t5"])):
            launched[world] = launch(
                [sys.executable, CHILD, str(root / "job.pt"), str(root), *cases], world,
                LAUNCH_TIMEOUT_S, env=env, cwd=str(REPO))

    thread = threading.Thread(target=run)
    thread.start()
    try:
        refs = {case: fn() for case, fn in reference.items()}
    finally:
        thread.join()
    for world in (4, 2):
        check(launched[world], f"{world}-rank launch")
    got = {c: torch.load(root / f"{c}.pt", weights_only=False) for c in job}
    return got, refs


def _close_params(got, want, lr, what):
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=1e-3, atol=2.5 * lr,
                                   err_msg=f"{what} {name}")


def test_tp_forward_with_headless_ranks_matches_jax(runs):
    got, refs = runs
    out = got["tp_forward"]
    np.testing.assert_allclose(out["out"].numpy(), refs["tp_forward"], atol=1e-5)
    # level 0 has 2 heads over 4 ranks: ranks 2 and 3 hold none of them
    first = [heads[0] for heads in out["local_heads"]]
    assert first == [split_span(2, 4, r)[1] - split_span(2, 4, r)[0] for r in range(4)]
    assert first == [1, 1, 0, 0]
    assert out["gathered_equal"]


def test_dp_tp_sft_step_matches_jax(runs):
    got, refs = runs
    g, r = got["sft_step"], refs["sft_step"]
    np.testing.assert_allclose(g["loss"], r["loss"], rtol=2e-5)
    assert set(g["grads"]) == set(r["grads"])
    for name, v in r["grads"].items():
        np.testing.assert_allclose(g["grads"][name].numpy(), v.numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=f"grad {name}")
    _close_params(g["params"], r["params"], r["lr"], "updated param")


@pytest.mark.parametrize("what", ["waveforms", "single"])
def test_dp_generation_matches_jax(runs, what):
    got, refs = runs
    g, r = got["generate"][what], refs["generate"][what]
    if what == "waveforms":
        assert len(g) == len(r) == len(GEN["prompts"])
    else:
        g, r = [g], [r]
    for i, (a, b) in enumerate(zip(g, r)):
        assert a.dtype == np.int16 and a.shape == b.shape
        np.testing.assert_allclose(a.astype(np.float32), np.asarray(b, np.float32), atol=2.0,
                                   err_msg=f"waveform {i}")


@pytest.mark.parametrize("case", ["mustango", "audioldm"])
def test_pipeline_matches_meshless(runs, case):
    got, refs = runs
    g, r = got[case]["waveforms"], refs[case]["waveforms"]
    assert len(g) == len(r)
    for a, b in zip(g, r):
        assert a.dtype == np.int16 and a.shape == b.shape and np.abs(a).max() > 0
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), atol=2.0)


def test_dpo_step_matches_meshless(runs):
    got, refs = runs
    g, r = got["dpo_step"], refs["dpo_step"]
    np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-4)
    assert g["metrics"]["implicit_acc"] == r["metrics"]["implicit_acc"]
    for k in ("raw_model_loss", "raw_ref_loss"):
        np.testing.assert_allclose(g["metrics"][k], r["metrics"][k], rtol=1e-5)
    _close_params(g["params"], r["params"], DPO_LR, "DPO param")


def test_t5_tp_matches_jax(runs):
    got, refs = runs
    np.testing.assert_allclose(got["t5"]["out"].numpy(), refs["t5"], atol=2e-4, rtol=1e-3)
