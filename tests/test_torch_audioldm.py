"""AudioLDM's pipeline in the port (tango_tpu_torch/audioldm/pipeline.py)
against JAX's (tango_tpu/audioldm/pipeline.py) on the same tiny parameter
trees, on the CPU in f32, and the parameter EMA (utils/ema.py) against JAX's.

Tolerances: latents the sampler parity's 2e-4 / 1e-3
(tests/test_torch_pipeline.py), int16 waveforms 2 steps (tests/test_pipeline.py's
int16 bar), encoded latents the VAE parity's 1e-4 / 1e-3
(tests/test_torch_golden.py), the DDPM tables and steps 1e-6. JAX draws its
noise inside its jit, so the stochastic paths are held to their formulas with
given noise, and the deterministic ones (eta 0 from given latents) to JAX's
outputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu import configs as JC
from tango_tpu.audioldm import pipeline as jpl
from tango_tpu.models import audioldm_unet as jfilm
from tango_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from tango_tpu.models.vae import AutoencoderKL as JVAE
from tango_tpu.utils.ema import ema_init as j_ema_init
from tango_tpu.utils.ema import ema_update as j_ema_update
from tango_tpu_torch import configs as TC
from tango_tpu_torch.audio.wav import write_wav
from tango_tpu_torch.audioldm import pipeline as pl
from tango_tpu_torch.models import audioldm_unet as film
from tango_tpu_torch.parallel.mesh import make_mesh, shard_latents_seq
from tango_tpu_torch.utils import ema
from tango_tpu_torch.utils.convert import from_jax_params

from tests._torch_helpers import random_jax_params, tiny_clap_configs
from tests.conftest import load_golden

torch.set_num_threads(1)

# tests/test_audioldm.py's tiny geometry
FILM_KW = dict(in_channels=8, out_channels=8, model_channels=32, num_res_blocks=1,
               attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=16,
               extra_film_condition_dim=32, extra_film_use_concat=True)
VAE_KW = dict(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2), num_res_blocks=1,
              scale_factor=0.9)
HIFI_KW = dict(num_mels=8, upsample_initial_channel=32)
LT, LF = 8, 4
# 16 mel frames -> 8 latent frames (the VAE halves), as tests/test_audioldm.py
SRC_DURATION = 16 / 102.4


@pytest.fixture(scope="module")
def trees():
    return dict(
        unet=random_jax_params(lambda k: jfilm.FilmUNet(jfilm.FilmUNetConfig(**FILM_KW)).init(
            k, jnp.zeros((1, LT, LF, 8)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 32)))["params"], 0),
        vae=random_jax_params(lambda k: JVAE(JC.VAEConfig(**VAE_KW)).init(
            k, jnp.zeros((1, 16, 8, 1)), k)["params"], 1),
        hifi=random_jax_params(lambda k: JHiFiGAN(JC.HiFiGANConfig(**HIFI_KW)).init(
            k, jnp.zeros((1, 8, 8)))["params"], 2),
    )


@pytest.fixture(scope="module")
def jpipe(trees):
    p = jpl.AudioLDMPipeline(
        unet_config=jfilm.FilmUNetConfig(**FILM_KW), vae_config=JC.VAEConfig(**VAE_KW),
        hifigan_config=JC.HiFiGANConfig(**HIFI_KW), stft_config=JC.StftConfig(n_mel_channels=8),
        latent_f_size=LF, conditioner=jpl.StubClapConditioner(dim=32))
    p.unet_params, p.vae_params, p.hifigan_params = trees["unet"], trees["vae"], trees["hifi"]
    return p


def port_pipe(trees, **kw):
    return pl.AudioLDMPipeline(
        unet_config=film.FilmUNetConfig(**FILM_KW), vae_config=TC.VAEConfig(**VAE_KW),
        hifigan_config=TC.HiFiGANConfig(**HIFI_KW), stft_config=TC.StftConfig(n_mel_channels=8),
        latent_f_size=LF, conditioner=pl.StubClapConditioner(dim=32),
        unet_params=from_jax_params(trees["unet"]), vae_params=from_jax_params(trees["vae"]),
        hifigan_params=from_jax_params(trees["hifi"]), device="cpu", **kw)


@pytest.fixture(scope="module")
def pipe(trees):
    return port_pipe(trees)


@pytest.fixture(scope="module")
def source_wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("src") / "src.wav")
    t = np.linspace(0, 1, 16000, endpoint=False)
    write_wav(path, (0.5 * np.sin(2 * np.pi * 330 * t)).astype(np.float32))
    return path


def test_duration_mapping():
    assert pl.duration_to_latent_t_size(10) == jpl.duration_to_latent_t_size(10) == 256
    assert pl.AUDIOLDM_SCHEDULER.to_dict() == dataclasses.asdict(jpl.AUDIOLDM_SCHEDULER)


@pytest.mark.parametrize("t_start", [None, 501])
def test_sample_latents_eta0_matches_jax(jpipe, pipe, t_start):
    """Deterministic DDIM (eta 0) from the same initial latents, also started
    part-way (t_start, as style transfer does)."""
    rng = np.random.RandomState(3)
    fc = rng.randn(2, 32).astype(np.float32)
    fu = np.zeros((2, 32), np.float32)
    init = rng.randn(2, LT, LF, 8).astype(np.float32)
    kw = dict(latent_t_size=LT, ddim_steps=4, guidance_scale=2.5, init_latents=init,
              t_start=t_start, eta=0.0)
    want = np.asarray(jpipe.sample_latents(jnp.asarray(fc), jnp.asarray(fu),
                                           jax.random.PRNGKey(0), **kw))
    got = pipe.sample_latents(fc, fu, None, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


def test_decode_matches_jax(jpipe, pipe):
    lat = np.random.RandomState(4).randn(2, LT, LF, 8).astype(np.float32)
    want = jpipe.decode(jnp.asarray(lat))
    got = pipe.decode(lat)
    assert got.dtype == want.dtype == np.int16
    assert got.shape == want.shape == (2, 2 * LT * 160 + 32)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=2.0)


def test_encode_first_stage_with_given_noise_matches_jax(jpipe, pipe):
    mel = np.random.RandomState(5).randn(2, 16, 8, 1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jpipe.encode_first_stage(jnp.asarray(mel), key))
    # JAX's draw: one standard normal of the posterior's shape from the key
    noise = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    got = pipe.encode_first_stage(mel, noise=noise)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)
    # with a generator it draws: finite, and seeded
    a = pipe.encode_first_stage(mel, pipe.generator(1))
    assert torch.equal(a, pipe.encode_first_stage(mel, pipe.generator(1)))


def test_stochastic_encode_timesteps_match_jax(pipe):
    for steps in (4, 10, 200):
        desc = pipe.scheduler.timesteps(steps)
        for t_enc in range(1, steps + 2):  # style transfer calls it with t_enc >= 1
            assert (pl.stochastic_encode_timesteps(desc, t_enc)
                    == jpl.stochastic_encode_timesteps(desc, t_enc))


def _jax_tables(cfg):
    """JAX's p_sample_loop tables (tango_tpu/audioldm/pipeline.py:330-350)."""
    from tango_tpu.schedulers import DDPMScheduler as JDDPM

    s = JDDPM.create(cfg)
    betas, ac = s.betas, s.alphas_cumprod
    ac_prev = jnp.concatenate([jnp.ones((1,), ac.dtype), ac[:-1]])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    return dict(ac=ac, coef1=betas * jnp.sqrt(ac_prev) / (1.0 - ac),
                coef2=(1.0 - ac_prev) * jnp.sqrt(1.0 - betas) / (1.0 - ac),
                post_logvar=jnp.log(jnp.maximum(post_var, 1e-20)))


@pytest.mark.parametrize("clip", [False, True])
def test_p_sample_tables_and_step_match_jax_formulas(pipe, clip):
    ours, theirs = pipe.p_sample_tables(), _jax_tables(jpl.AUDIOLDM_SCHEDULER)
    for k in ("ac", "coef1", "coef2", "post_logvar"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=1e-6, err_msg=k)
    rng = np.random.RandomState(6)
    lat, eps, noise = (rng.randn(2, LT, LF, 8).astype(np.float32) for _ in range(3))
    for t in (999, 500, 1, 0):
        # the body of JAX's scan (pipeline.py:371-385)
        ac = theirs["ac"]
        x0 = (lat - jnp.sqrt(1.0 - ac[t]) * eps) / jnp.sqrt(ac[t])
        if clip:
            x0 = jnp.clip(x0, -1.0, 1.0)
        mean = theirs["coef1"][t] * x0 + theirs["coef2"][t] * lat
        want = mean + (t > 0) * jnp.exp(0.5 * theirs["post_logvar"][t]) * noise
        got = pipe.p_sample_step(torch.from_numpy(lat), t, torch.from_numpy(eps),
                                 torch.from_numpy(noise), ours, clip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_p_sample_loop_runs_full_t(trees):
    """Every training timestep, CFG and not, seeded and finite
    (tests/test_audioldm.py's, at 12 train timesteps)."""
    p = port_pipe(trees, scheduler_config=dataclasses.replace(pl.AUDIOLDM_SCHEDULER,
                                                              num_train_timesteps=12))
    calls = []
    unet = p.unet
    orig = type(unet).forward
    p.unet.forward = lambda *a, **k: calls.append(a[1][0].item()) or orig(unet, *a, **k)
    cond, uncond = np.full((2, 32), 0.1, np.float32), np.zeros((2, 32), np.float32)
    lat = p.p_sample_loop(cond, uncond, p.generator(0), latent_t_size=LT, guidance_scale=2.0)
    assert calls == list(range(11, -1, -1))
    assert lat.shape == (2, LT, LF, 8) and torch.isfinite(lat).all()
    lat2 = p.p_sample_loop(cond, uncond, p.generator(0), latent_t_size=LT, guidance_scale=2.0)
    assert torch.equal(lat, lat2)
    lat3 = p.p_sample_loop(cond, None, p.generator(1), latent_t_size=LT, clip_denoised=True)
    assert torch.isfinite(lat3).all()


def test_text_to_audio_and_style_transfer_run(pipe, source_wav):
    wavs = pl.text_to_audio(pipe, "a cat meows", duration=LT / 25.6, ddim_steps=3,
                            batchsize=1, n_candidate_gen_per_text=2)
    assert wavs.shape == (1, 2 * LT * 160 + 32) and wavs.dtype == np.int16
    again = pl.text_to_audio(pipe, "a cat meows", duration=LT / 25.6, ddim_steps=3,
                             batchsize=1, n_candidate_gen_per_text=2)
    np.testing.assert_array_equal(wavs, again)  # seeded
    wavs = pl.style_transfer(pipe, "lo-fi beat", source_wav, transfer_strength=0.5,
                             duration=SRC_DURATION, ddim_steps=4, batchsize=1)
    # the last 3 of the 8 latent frames are trimmed before decoding
    assert wavs.shape == (1, 2 * (LT - 3) * 160 + 32) and wavs.dtype == np.int16
    with pytest.raises(ValueError, match="audio tower"):
        pl.text_to_audio(pipe, "x", original_audio_file_path=source_wav,
                         duration=LT / 25.6, ddim_steps=2)


def test_style_transfer_starts_from_noised_source(pipe, source_wav, monkeypatch):
    """The partial loop starts below the noising timestep, from the source
    latent noised there, and strength 0 decodes the source itself."""
    seen = {}
    sample, encode = pipe.sample_latents, pipe.encode_first_stage
    monkeypatch.setattr(pipe, "sample_latents",
                        lambda *a, **k: seen.update(k) or sample(*a, **k))
    monkeypatch.setattr(pipe, "encode_first_stage",
                        lambda *a, **k: seen.setdefault("z0", encode(*a, **k)))
    monkeypatch.setattr(pipe, "decode", lambda lat: [seen.setdefault("dec", lat)])
    pl.style_transfer(pipe, "x", source_wav, 0.5, duration=SRC_DURATION, ddim_steps=4)
    desc = pipe.scheduler.timesteps(4)
    t_noise, t_denoise = jpl.stochastic_encode_timesteps(desc, 2)
    assert seen["t_start"] == t_denoise < t_noise
    assert seen["init_latents"].shape == (1, LT, LF, 8)
    seen.clear()
    pl.style_transfer(pipe, "x", source_wav, 0.0, duration=SRC_DURATION, ddim_steps=4)
    assert "t_start" not in seen and torch.equal(seen["dec"], seen["z0"][:, :-3])


def test_candidate_ranking_uses_similarity(pipe):
    class PrefersLast(pl.StubClapConditioner):
        def similarity(self, wavs, prompt):
            return np.arange(len(wavs), dtype=np.float64)

    class PrefersFirst(pl.StubClapConditioner):
        def similarity(self, wavs, prompt):
            return -np.arange(len(wavs), dtype=np.float64)

    kw = dict(duration=LT / 25.6, ddim_steps=2, batchsize=1, n_candidate_gen_per_text=3, seed=5)
    pipe_last = dataclasses.replace(pipe, conditioner=PrefersLast(dim=32), device="cpu")
    pipe_first = dataclasses.replace(pipe, conditioner=PrefersFirst(dim=32), device="cpu")
    w_last, w_first = (pl.text_to_audio(p, "x", **kw) for p in (pipe_last, pipe_first))
    assert w_last.shape[0] == w_first.shape[0] == 1
    assert not np.array_equal(w_last, w_first)


def test_candidate_ranking_is_per_slot(pipe, monkeypatch):
    """Slot i's candidates sit at i::batchsize; the best of each, in slot
    order: rows [2, 1] here, where a global top-2 would give [1, 2]."""
    sims = np.asarray([0.1, 0.9, 0.8, 0.2])

    class Crafted(pl.StubClapConditioner):
        def similarity(self, wavs, prompt):
            return sims

    p = dataclasses.replace(pipe, conditioner=Crafted(dim=32), device="cpu")
    monkeypatch.setattr(p, "decode",
                        lambda lat: np.arange(lat.shape[0], dtype=np.int16)[:, None])
    wavs = pl.text_to_audio(p, "x", duration=LT / 25.6, ddim_steps=2, batchsize=2,
                            n_candidate_gen_per_text=2, seed=0)
    np.testing.assert_array_equal(wavs[:, 0], [2, 1])
    assert pl.rerank(wavs, sims, 2) == [2, 1]


@pytest.mark.parametrize("time_ratio,freq_ratio", [((0.25, 0.75), (1.0, 1.0)),
                                                   ((0.1, 0.15), (0.5, 1.0))])
def test_inpainting_keeps_the_source_outside_the_mask(pipe, source_wav, monkeypatch,
                                                      time_ratio, freq_ratio):
    seen = {}
    encode, decode = pipe.encode_first_stage, pipe.decode
    monkeypatch.setattr(pipe, "encode_first_stage",
                        lambda *a, **k: seen.setdefault("z0", encode(*a, **k)))
    monkeypatch.setattr(pipe, "decode",
                        lambda lat: seen.setdefault("lat", lat) is None or decode(lat))
    wavs = pl.super_resolution_and_inpainting(
        pipe, "birds chirping", source_wav, duration=SRC_DURATION, ddim_steps=3, batchsize=1,
        time_mask_ratio_start_and_end=time_ratio, freq_mask_ratio_start_and_end=freq_ratio)
    assert wavs.shape == (1, 2 * LT * 160 + 32) and wavs.dtype == np.int16
    mask = pl.inpainting_mask(LT, LF, time_ratio, freq_ratio)
    # JAX's mask (pipeline.py:596-603)
    t_idx, f_idx = np.arange(LT) / LT, np.arange(LF) / LF
    want = (((t_idx >= time_ratio[0]) & (t_idx < time_ratio[1]))[:, None]
            | ((f_idx >= freq_ratio[0]) & (f_idx < freq_ratio[1]))[None, :])
    np.testing.assert_array_equal(mask[0, :, :, 0], want.astype(np.float32))
    keep = torch.from_numpy(mask == 0).expand_as(seen["lat"])
    assert keep.any() and (~keep).any()
    assert torch.equal(seen["lat"][keep], seen["z0"][keep])
    assert not torch.equal(seen["lat"][~keep], seen["z0"][~keep])


# ------------------------------------------------------ from_checkpoint

def _tiny_monolithic_ckpt(path):
    """tests/test_audioldm.py:test_from_checkpoint_monolithic_ckpt_e2e's file:
    the goldens' FiLM UNet, VAE, weight-normed vocoder and CLAP towers under
    the released prefixes, and scale_factor 0.87."""
    from tests.test_audioldm import _tiny_monolithic_clap_sd

    sd = {}
    for name, prefix in (("film_unet_tiny", "model.diffusion_model."),
                         ("vae_tiny", "first_stage_model."),
                         ("hifigan_tiny", "first_stage_model.vocoder.")):
        g = load_golden(name)
        sd.update({prefix + k[4:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("sd::")})
    clap_sd, _, _ = _tiny_monolithic_clap_sd()
    sd.update({k: torch.from_numpy(np.asarray(v)) for k, v in clap_sd.items()})
    sd["scale_factor"] = torch.tensor(0.87)
    torch.save({"state_dict": sd}, path)
    return path


GOLDEN_FILM = dict(image_size=16, in_channels=4, out_channels=4, model_channels=32,
                   num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                   num_head_channels=16, extra_film_condition_dim=16, extra_film_use_concat=True)
GOLDEN_VAE = dict(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                  resolution=32)
GOLDEN_HIFI = dict(num_mels=8, upsample_initial_channel=64)


class ClippedTok:
    """tests/test_audioldm.py's tokenizer: word hashes clipped to the tiny vocabulary."""

    def __call__(self, texts, max_length=12, **kw):
        from tests.test_pipeline import StubTokenizer

        out = StubTokenizer()(texts, max_length=12)
        out["input_ids"] = np.clip(out["input_ids"], 0, 119)
        return out


def test_from_checkpoint_monolithic_matches_jax(tmp_path, source_wav):
    from tango_tpu_torch.models.clap import Clap

    path = _tiny_monolithic_ckpt(str(tmp_path / "tiny-audioldm-full.ckpt"))
    text_cfg, audio_cfg = tiny_clap_configs()
    p = pl.build_model(
        path, unet_config=film.FilmUNetConfig(**GOLDEN_FILM), vae_config=TC.VAEConfig(**GOLDEN_VAE),
        hifigan_config=TC.HiFiGANConfig(**GOLDEN_HIFI), stft_config=TC.StftConfig(n_mel_channels=8),
        latent_f_size=4, clap_text_cfg=text_cfg, clap_audio_cfg=audio_cfg,
        tokenizer=ClippedTok(), device="cpu")
    assert isinstance(p.conditioner, Clap)
    assert p.vae_config.scale_factor == pytest.approx(0.87)
    j = jpl.AudioLDMPipeline.from_checkpoint(
        path, conditioner=jpl.StubClapConditioner(16),
        unet_config=jfilm.FilmUNetConfig(**GOLDEN_FILM), vae_config=JC.VAEConfig(**GOLDEN_VAE),
        hifigan_config=JC.HiFiGANConfig(**GOLDEN_HIFI), latent_f_size=4)
    for name in ("unet", "vae", "hifigan"):
        ours, theirs = getattr(p, f"{name}_params"), from_jax_params(getattr(j, f"{name}_params"))
        assert set(ours) == set(theirs), name
        for k in ours:
            torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=1e-7, msg=k)
    assert p.vae.encoder is not None  # the encoder came with the VAE
    p.conditioner.audio_batch = 4
    wavs = pl.text_to_audio(p, "wind chimes", duration=8 / 25.6, ddim_steps=2, batchsize=1,
                            n_candidate_gen_per_text=2)
    assert wavs.shape[0] == 1 and wavs.dtype == np.int16 and np.abs(wavs).max() > 0
    # the CLAP audio embedding of a file conditions in place of the text
    wavs = pl.text_to_audio(p, "", original_audio_file_path=source_wav, duration=8 / 25.6,
                            ddim_steps=2, n_candidate_gen_per_text=1)
    assert wavs.shape[0] == 1


def test_conditioner_from_ckpt_without_tokenizer_warns(tmp_path):
    from tests.test_audioldm import _tiny_monolithic_clap_sd

    sd, _, _ = _tiny_monolithic_clap_sd()
    with pytest.warns(UserWarning, match="stub"):
        assert pl.build_clap_conditioner_from_ckpt(sd) is None
    assert pl.build_clap_conditioner_from_ckpt({"model.diffusion_model.x": 0}) is None
    text_cfg, _ = tiny_clap_configs()
    text_only = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items() if "audio_" not in k}
    from tango_tpu_torch.models.clap import ClapTextConditioner

    cond = pl.build_clap_conditioner_from_ckpt(text_only, text_cfg=text_cfg,
                                                tokenizer=ClippedTok(), device="cpu")
    assert isinstance(cond, ClapTextConditioner) and cond.max_length == 512


def test_stub_conditioner_matches_jax_in_one_process():
    ours, theirs = pl.StubClapConditioner(dim=32), jpl.StubClapConditioner(dim=32)
    np.testing.assert_array_equal(ours.text_embed(["a", "b c"]), theirs.text_embed(["a", "b c"]))
    np.testing.assert_array_equal(ours.unconditional_embed(3), theirs.unconditional_embed(3))


def test_mesh_raises(tmp_path):
    """The mesh is ported (tests/test_torch_parallel.py holds AudioLDM at DP=2
    to its meshless run), and so is sequence parallelism
    (tests/test_torch_sp.py): on a one-process mesh `shard_latents_seq` is
    the identity. A missing checkpoint still raises; a one-process mesh
    pads nothing."""
    mesh = make_mesh(device="cpu")
    assert pl.AudioLDMPipeline(mesh=mesh, device="cpu").pad_batch(5) == 5
    with pytest.raises(FileNotFoundError):
        pl.AudioLDMPipeline.from_checkpoint(str(tmp_path / "none.ckpt"), mesh=mesh,
                                            device="cpu")
    x = torch.zeros(2, 8, 4, 4)
    assert shard_latents_seq(x, mesh) is x
    assert pl.AudioLDMPipeline(device="cpu").pad_batch(5) == 5


def test_missing_weights_raise():
    p = pl.AudioLDMPipeline(device="cpu")
    with pytest.raises(RuntimeError, match="unet_params"):
        p.unet
    with pytest.raises(RuntimeError, match="hifigan_params"):
        p.decode(np.zeros((1, 4, 16, 8), np.float32))


def test_modules_follow_their_params(trees):
    p = port_pipe(trees)
    first = p.unet
    assert p.unet is first
    p.unet_params = {k: v * 0 for k, v in p.unet_params.items()}
    assert p.unet is not first and all((v == 0).all() for v in p.unet.state_dict().values())


# ----------------------------------------------------------------- EMA

@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_matches_jax(use_num_updates):
    rng = np.random.RandomState(8)
    tree = {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    js = j_ema_init({k: jnp.asarray(v) for k, v in tree.items()}, use_num_updates)
    ps = ema.ema_init({k: torch.from_numpy(v) for k, v in tree.items()}, use_num_updates)
    for i in range(4):
        cur = {k: rng.randn(*v.shape).astype(np.float32) for k, v in tree.items()}
        js = j_ema_update(js, {k: jnp.asarray(v) for k, v in cur.items()}, decay=0.99)
        ps = ema.ema_update(ps, {k: torch.from_numpy(v) for k, v in cur.items()}, decay=0.99)
        assert ps.num_updates == int(js.num_updates)
        for k in tree:
            np.testing.assert_allclose(ema.ema_params(ps)[k].numpy(), np.asarray(js.shadow[k]),
                                       rtol=1e-6, atol=1e-7)
    # the shadow is a copy: the update leaves the params alone
    assert not torch.equal(ema.ema_params(ps)["w"], torch.from_numpy(tree["w"]))
