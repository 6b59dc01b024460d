"""AudioLDM's pipeline, port of tango_tpu/audioldm/pipeline.py: text to
audio, style transfer, and super-resolution and inpainting.

AudioLDM conditions its FiLM UNet (models/audioldm_unet.py) on one CLAP
embedding a sample, not on a token sequence:

  * `text_to_audio`: the CLAP text embedding (or, with
    `original_audio_file_path`, the CLAP audio embedding of that file) ->
    CFG DDIM sampling with eta 1.0 -> the guard against extreme latents ->
    VAE decode -> HiFi-GAN -> int16 16 kHz; the candidates of each slot
    re-ranked by CLAP similarity. 10 s is 256 latent frames (25.6 a second).
  * `style_transfer`: the source mel encoded to a latent, noised to the
    strength's DDIM step, denoised under the text from there; the last 3
    latent frames dropped before decoding, as the reference does.
  * `super_resolution_and_inpainting`: the masked region regenerated under
    the text while the rest is pinned to the source latent, re-noised to
    each step's level, and blended back exactly at the end.
  * `AudioLDMPipeline.p_sample_loop`: full-T DDPM ancestral sampling.

The scheduler is the LDM 'linear' schedule (scaled_linear betas in
[0.0015, 0.0195], epsilon prediction). `from_checkpoint` loads a monolithic
audioldm-*-full `.ckpt`: the FiLM UNet under `model.diffusion_model.`, the
VAE (with its encoder) and the weight-normed vocoder under
`first_stage_model.`, CLAP under `cond_stage_model.model.`, and
`scale_factor`; it downloads nothing. The conditioner built from CLAP's
weights is the port's native CLAP (models/clap.py), which needs the caller's
RoBERTa tokenizer: without one it warns and the hash-embedding stub
conditions instead, as JAX does when no tokenizer is available offline.

Runs on CUDA unless the caller passes `device="cpu"`; the compute dtype is
f32 unless `dtype` names another, scheduler math f32 always. Random draws
come from a torch.Generator seeded from `seed`.

The device mesh (`mesh=`, parallel.mesh): the parameters are replicated
(the FiLM UNet is small, and JAX's pipeline replicates it too); every UNet
evaluation and the decode spread their rows over 'data', the batch padded
to a multiple of it (`pad_batch`) by repeating rows, and the results are
gathered back. The random draws are made whole on every rank, as without
a mesh, so a run under a mesh draws the meshless run's numbers. Every rank
must embed alike: the native CLAP does; the hash stub, salted per process,
does only with one PYTHONHASHSEED for all ranks.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tango_tpu_torch import configs as C
from tango_tpu_torch.audio.stft import MelSpectrogram, wav_batch_to_fbank
from tango_tpu_torch.configs import SchedulerConfig, VAEConfig
from tango_tpu_torch.models.audioldm_unet import AUDIOLDM_S_UNET, FilmUNet, FilmUNetConfig
from tango_tpu_torch.models.diffusion import randn_rows
from tango_tpu_torch.models.hifigan import HiFiGANGenerator, waveform_to_int16
from tango_tpu_torch.models.layers import frozen
from tango_tpu_torch.models.vae import AutoencoderKL, sample_diagonal_gaussian
from tango_tpu_torch.parallel import mesh as pmesh
from tango_tpu_torch.schedulers import DDIMScheduler, DDPMScheduler

AUDIOLDM_SCHEDULER = SchedulerConfig(
    beta_start=0.0015,
    beta_end=0.0195,
    beta_schedule="scaled_linear",
    prediction_type="epsilon",
    clip_sample=False,
    set_alpha_to_one=False,
    steps_offset=1,
)
# the reference's guard: a latent past this magnitude would decode to NaN,
# so the latents are clipped to +-10 first
EXTREME_LATENT = 1e2


def duration_to_latent_t_size(duration: float) -> int:
    return int(duration * 25.6)


class ClapConditioner:
    """Protocol: prompts -> (B, dim) embeddings, and the unconditional one."""

    dim: int = 512

    def text_embed(self, prompts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def unconditional_embed(self, batch: int) -> np.ndarray:
        raise NotImplementedError

    def similarity(self, waveforms: np.ndarray, prompt: str) -> np.ndarray:
        """For candidate re-ranking; by default no preference."""
        return np.zeros(len(waveforms))


class StubClapConditioner(ClapConditioner):
    """Deterministic text-hash embeddings, for tests and checkpoints without
    CLAP. Python's string hash is salted per process."""

    def __init__(self, dim: int = 512):
        self.dim = dim

    def text_embed(self, prompts):
        out = np.zeros((len(prompts), self.dim), np.float32)
        for i, p in enumerate(prompts):
            v = np.random.RandomState(abs(hash(p)) % (2**31)).randn(self.dim)
            out[i] = v / np.linalg.norm(v)
        return out

    def unconditional_embed(self, batch):
        return np.zeros((batch, self.dim), np.float32)


_CLAP_PREFIX = "cond_stage_model.model."


def build_clap_conditioner_from_ckpt(sd, text_cfg=None, audio_cfg=None, tokenizer=None,
                                     dtype=torch.float32, device=None):
    """The native CLAP conditioner from a monolithic checkpoint's
    `cond_stage_model.model.*` weights: a `Clap` (text and audio towers, with
    the similarity the re-ranking needs) where both towers are there, a
    text-only `ClapTextConditioner` where only the text tower is, and None
    where the checkpoint has no CLAP or no tokenizer is given. The
    conditioning tokenizes at max_length 512 (the reference's vendored CLAP),
    the unconditional embedding is that of "". The towers run in f32
    whatever `dtype` (JAX's parameter) says."""
    from tango_tpu_torch.models.clap import (
        ROBERTA_BASE,
        Clap,
        ClapTextConditioner,
        convert_clap_text,
    )

    if f"{_CLAP_PREFIX}text_branch.embeddings.word_embeddings.weight" not in sd:
        return None
    if tokenizer is None:
        warnings.warn(
            "the checkpoint has CLAP weights but no tokenizer was given (the port loads no "
            "RoBERTa tokenizer); falling back to the hash-embedding stub conditioner",
            UserWarning, stacklevel=2)
        return None
    text_cfg = text_cfg or ROBERTA_BASE
    text_params = convert_clap_text(sd, prefix=_CLAP_PREFIX)
    if not any(k.startswith(f"{_CLAP_PREFIX}audio_branch.") for k in sd):
        return ClapTextConditioner(text_params, tokenizer, text_cfg, max_length=512,
                                   device=device)
    from tango_tpu_torch.models.htsat import HTSAT_TINY, convert_clap_audio

    audio_cfg = audio_cfg or HTSAT_TINY
    audio_params = convert_clap_audio(sd, audio_cfg, prefix=_CLAP_PREFIX)
    return Clap(text_params, audio_params, tokenizer, text_cfg=text_cfg, audio_cfg=audio_cfg,
                max_length=512, device=device)


@dataclasses.dataclass(eq=False)
class AudioLDMPipeline:
    """The LatentDiffusion equivalent. The modules (`unet`, `vae`,
    `vocoder`) are built on the device in `dtype` from the `*_params` state
    dicts at first use, and again whenever a `*_params` field is given
    another state dict, as JAX applies whatever parameters the field holds.
    The VAE is built with its encoder where its state dict has one."""

    unet_config: FilmUNetConfig = AUDIOLDM_S_UNET
    vae_config: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    hifigan_config: C.HiFiGANConfig = dataclasses.field(default_factory=C.HiFiGANConfig)
    scheduler_config: SchedulerConfig = AUDIOLDM_SCHEDULER
    stft_config: C.StftConfig = dataclasses.field(default_factory=C.StftConfig)
    latent_f_size: int = 16
    dtype: torch.dtype = torch.float32
    mesh: Optional[object] = None

    unet_params: Optional[dict] = None
    vae_params: Optional[dict] = None
    hifigan_params: Optional[dict] = None
    conditioner: Optional[ClapConditioner] = None
    device: object = None

    def __post_init__(self):
        self.device = C.resolve_device(self.device)
        self.scheduler = DDIMScheduler.create(self.scheduler_config)
        self.stft = MelSpectrogram(self.stft_config)
        self._modules = {}

    # --------------------------------------------------------------- modules
    def _module(self, name: str, make):
        params = getattr(self, f"{name}_params")
        cached = self._modules.get(name)
        if cached is None or cached[0] is not params:
            if params is None:
                raise RuntimeError(f"AudioLDMPipeline has no {name} weights ({name}_params)")
            self._modules.pop(name, None)
            m = frozen(lambda: make(params), params, self.device).to(self.dtype)
            self._modules[name] = (params, m)
        return self._modules[name][1]

    @property
    def unet(self) -> FilmUNet:
        return self._module("unet", lambda p: FilmUNet(self.unet_config))

    @property
    def vae(self) -> AutoencoderKL:
        return self._module("vae", lambda p: AutoencoderKL(
            self.vae_config, with_encoder=any(k.startswith("encoder.") for k in p)))

    @property
    def vocoder(self) -> HiFiGANGenerator:
        return self._module("hifigan", lambda p: HiFiGANGenerator(self.hifigan_config))

    def pad_batch(self, n: int) -> int:
        """n rounded up to the mesh's 'data' multiple; n without a mesh."""
        return pmesh.pad_rows(n, self.mesh)

    def _rows_split(self, fn, *xs):
        """fn over the rows of xs (each with the same leading n rows), spread
        over 'data': the rows padded to `pad_batch(n)` by repeating them, this
        rank's share computed, the results gathered and cut back to n."""
        if self.mesh is None or self.mesh.data_group is None:
            return fn(*xs)
        n = xs[0].shape[0]
        n_pad = self.pad_batch(n)
        index = torch.arange(n_pad, device=xs[0].device) % n
        rows = pmesh.local_rows(self.mesh, n_pad)
        out = fn(*(x[index][rows] for x in xs))
        return pmesh.gather_rows(out, self.mesh, n_pad)[:n]

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _rows(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, conditioner: Optional[ClapConditioner] = None,
                        dtype=torch.float32, clap_text_cfg=None, clap_audio_cfg=None,
                        tokenizer=None, unet_config: FilmUNetConfig = AUDIOLDM_S_UNET,
                        vae_config: Optional[VAEConfig] = None,
                        hifigan_config: Optional[C.HiFiGANConfig] = None,
                        stft_config: Optional[C.StftConfig] = None,
                        latent_f_size: int = 16, mesh=None, device=None) -> "AudioLDMPipeline":
        """Load a monolithic audioldm-*-full `.ckpt`. Where it holds CLAP
        weights (every released one does), the conditioner is the native
        CLAP built from them with `tokenizer`; an explicit `conditioner`
        comes first, and the hash stub serves a checkpoint without CLAP or a
        call without a tokenizer. The parameters are JAX's, in its order;
        `device`, the port's own, comes last."""
        from tango_tpu_torch.models.audioldm_unet import convert_film_unet
        from tango_tpu_torch.utils import convert as conv

        sd = conv.load_torch_bin(ckpt_path)
        vae_sd, scale = conv.split_audioldm_ckpt(sd)
        pre = "model.diffusion_model."
        unet_sd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        vocoder_sd = {k[len("vocoder."):]: v for k, v in vae_sd.items()
                      if k.startswith("vocoder.")}
        if conditioner is None:
            conditioner = build_clap_conditioner_from_ckpt(
                sd, text_cfg=clap_text_cfg, audio_cfg=clap_audio_cfg, tokenizer=tokenizer,
                dtype=dtype, device=device)
        return cls(
            unet_config=unet_config,
            vae_config=dataclasses.replace(vae_config or VAEConfig(), scale_factor=scale),
            hifigan_config=hifigan_config or C.HiFiGANConfig(),
            stft_config=stft_config or C.StftConfig(),
            latent_f_size=latent_f_size,
            dtype=dtype,
            unet_params=convert_film_unet(unet_sd, unet_config),
            vae_params=conv.convert_vae(vae_sd, with_encoder=True),
            hifigan_params=conv.convert_hifigan(vocoder_sd) if vocoder_sd else None,
            conditioner=conditioner or StubClapConditioner(),
            mesh=mesh,
            device=device,
        )

    # -------------------------------------------------------------- sampling
    def _guided(self, lat: torch.Tensor, t: int, film: torch.Tensor,
                guidance_scale: float) -> torch.Tensor:
        """The CFG prediction at timestep t: the UNet on [lat, lat] under
        film = [uncond, cond], upcast to f32, then u + g (c - u); the rows
        spread over the mesh's 'data'."""

        def guided(lat, film_u, film_c):
            lat_in = torch.cat([lat, lat]).to(self.dtype)
            t_b = torch.full((lat_in.shape[0],), int(t), dtype=torch.long, device=self.device)
            pu, pc = self.unet(lat_in, t_b, torch.cat([film_u, film_c])).float().chunk(2)
            return pu + guidance_scale * (pc - pu)

        return self._rows_split(guided, lat, *film.chunk(2))

    @torch.inference_mode()
    def sample_latents(self, film_cond, film_uncond, generator: Optional[torch.Generator] = None,
                       *, latent_t_size: int, ddim_steps: int, guidance_scale: float,
                       init_latents=None, t_start: Optional[int] = None,
                       eta: float = 1.0) -> torch.Tensor:
        """CFG DDIM loop over the FiLM UNet -> latents (B, T, F, C) f32;
        `init_latents` and `t_start` start it part-way (style transfer).
        eta 1.0 by default, as the reference samples; with eta 0 and
        `init_latents` nothing is drawn."""
        all_ts = self.scheduler.timesteps(ddim_steps)
        if t_start is not None:
            all_ts = all_ts[all_ts <= t_start]
        film_cond, film_uncond = self._rows(film_cond), self._rows(film_uncond)
        shape = (film_cond.shape[0], latent_t_size, self.latent_f_size,
                 self.unet_config.in_channels)
        lat = (self._rows(init_latents) if init_latents is not None
               else randn_rows(shape, generator, self.device))
        film = torch.cat([film_uncond, film_cond]).to(self.dtype)
        for t in all_ts.tolist():
            pred = self._guided(lat, t, film, guidance_scale)
            noise = randn_rows(lat.shape, generator, self.device) if eta > 0 else None
            lat, _ = self.scheduler.step(pred, t, lat, noise, ddim_steps, eta=eta)
        return lat

    def p_sample_tables(self) -> dict:
        """The DDPM posterior's f32 tables, indexed by timestep: alphas_cumprod
        `ac`, `coef1` (of x0), `coef2` (of x_t) and `post_logvar` (the
        posterior variance's log, clipped at 1e-20)."""
        sched = DDPMScheduler.create(self.scheduler_config)
        betas, ac = sched.betas, sched.alphas_cumprod
        ac_prev = torch.cat([torch.ones(1), ac[:-1]])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        return {"ac": ac,
                "coef1": betas * torch.sqrt(ac_prev) / (1.0 - ac),
                "coef2": (1.0 - ac_prev) * torch.sqrt(1.0 - betas) / (1.0 - ac),
                "post_logvar": torch.log(torch.clamp(post_var, min=1e-20))}

    @staticmethod
    def p_sample_step(lat, t: int, eps, noise, tables: dict, clip_denoised: bool = False):
        """One ancestral step x_t -> x_{t-1} from the model's eps, f32; the
        noise is zeroed at t == 0."""
        ac = tables["ac"][t]
        x0 = (lat - torch.sqrt(1.0 - ac) * eps) / torch.sqrt(ac)
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        mean = tables["coef1"][t] * x0 + tables["coef2"][t] * lat
        if t == 0:
            return mean
        return mean + torch.exp(0.5 * tables["post_logvar"][t]) * noise

    @torch.inference_mode()
    def p_sample_loop(self, film_cond, film_uncond, generator: Optional[torch.Generator] = None,
                      *, latent_t_size: int, guidance_scale: float = 1.0,
                      clip_denoised: bool = False) -> torch.Tensor:
        """Full-T DDPM ancestral sampling over every training timestep, the
        reference's non-DDIM sampler; CFG where `film_uncond` is given and
        guidance_scale != 1."""
        tables = self.p_sample_tables()
        n = self.scheduler_config.num_train_timesteps
        film_cond = self._rows(film_cond)
        cfg = film_uncond is not None and guidance_scale != 1.0
        shape = (film_cond.shape[0], latent_t_size, self.latent_f_size,
                 self.unet_config.in_channels)
        lat = randn_rows(shape, generator, self.device)
        if cfg:
            film = torch.cat([self._rows(film_uncond), film_cond]).to(self.dtype)
        for t in range(n - 1, -1, -1):
            if cfg:
                eps = self._guided(lat, t, film, guidance_scale)
            else:
                eps = self._rows_split(lambda x, c: self.unet(
                    x.to(self.dtype), torch.full((x.shape[0],), t, dtype=torch.long,
                                                 device=self.device), c.to(self.dtype)).float(),
                    lat, film_cond)
            noise = randn_rows(lat.shape, generator, self.device)
            lat = self.p_sample_step(lat, t, eps, noise, tables, clip_denoised)
        return lat

    @torch.inference_mode()
    def sample_masked(self, z0, film_cond, film_uncond, mask,
                      generator: Optional[torch.Generator] = None, *, ddim_steps: int,
                      guidance_scale: float) -> torch.Tensor:
        """The inpainting loop: stochastic DDIM (eta 1.0) from noise, after
        each step the region where `mask` is 0 replaced by the source latent
        `z0` re-noised to the step's level; at the end that region is `z0`
        exactly. mask (1, T, F, 1), 1 where the latent is regenerated."""
        sched = self.scheduler
        z0, mask = self._rows(z0), self._rows(mask)
        lat = randn_rows(z0.shape, generator, self.device)
        film = torch.cat([self._rows(film_uncond), self._rows(film_cond)]).to(self.dtype)
        stride = sched.config.num_train_timesteps // ddim_steps
        for t in sched.timesteps(ddim_steps).tolist():
            pred = self._guided(lat, t, film, guidance_scale)
            lat, _ = sched.step(pred, t, lat, randn_rows(lat.shape, generator, self.device),
                                ddim_steps, eta=1.0)
            known = sched.add_noise(z0, randn_rows(z0.shape, generator, self.device),
                                    torch.full((z0.shape[0],), max(t - stride, 0)))
            lat = mask * lat + (1.0 - mask) * known
        return mask * lat + (1.0 - mask) * z0

    # ---------------------------------------------------------- first stage
    @torch.inference_mode()
    def decode(self, latents) -> np.ndarray:
        """latents (B, T, F, C) -> int16 waveforms (B, T_wav)."""
        if self.hifigan_params is None:
            raise RuntimeError("AudioLDMPipeline has no vocoder weights (hifigan_params)")
        wav = self._rows_split(
            lambda z: self.vocoder(self.vae.decode_first_stage(z)[..., 0]).float(),
            self._rows(latents))
        return waveform_to_int16(wav)

    @torch.inference_mode()
    def encode_first_stage(self, mel, generator: Optional[torch.Generator] = None,
                           noise=None) -> torch.Tensor:
        """mel (B, T, F, 1) -> scaled latent drawn from the posterior with
        `generator` (or with `noise` in place of the standard normal draw), f32."""
        mean, logvar = self.vae.encode_moments(self._rows(mel))
        if noise is not None:
            noise = self._rows(noise).to(mean.dtype)
        z = sample_diagonal_gaussian(mean, logvar, generator, noise)
        return (self.vae_config.scale_factor * z).float()

    def source_mel(self, path: str, duration: float) -> torch.Tensor:
        """A source file's fbank (1, 102.4 duration frames, n_mels, 1)."""
        from tango_tpu_torch.audio.wav import read_wav_file

        target_len = int(duration * 102.4)
        wav = read_wav_file(path, target_len * 160)
        fbank, _ = wav_batch_to_fbank(self.stft, torch.from_numpy(wav).to(self.device),
                                      target_len)
        return fbank[..., None]


def _guard(latents: torch.Tensor) -> torch.Tensor:
    """The extreme-latent guard: clip to +-10 only past EXTREME_LATENT."""
    if float(latents.abs().max()) > EXTREME_LATENT:
        return latents.clamp(-10.0, 10.0)
    return latents


def build_model(ckpt_path: str, conditioner=None, **kw) -> AudioLDMPipeline:
    """The reference's build_model: `AudioLDMPipeline.from_checkpoint`."""
    return AudioLDMPipeline.from_checkpoint(ckpt_path, conditioner=conditioner, **kw)


def rerank(wavs: np.ndarray, sims, batchsize: int) -> list:
    """The reference's selection: the best candidate of each slot, in slot
    order (slot i's candidates are rows i, i + batchsize, ...)."""
    sims = np.asarray(sims)
    return [i + int(np.argmax(sims[i::batchsize])) * batchsize for i in range(batchsize)]


def text_to_audio(
    pipeline: AudioLDMPipeline,
    text: str,
    original_audio_file_path: Optional[str] = None,
    seed: int = 42,
    ddim_steps: int = 200,
    duration: float = 10.0,
    batchsize: int = 1,
    guidance_scale: float = 2.5,
    n_candidate_gen_per_text: int = 3,
) -> np.ndarray:
    """Text (or, with `original_audio_file_path`, the CLAP audio embedding of
    that file) -> int16 waveforms (batchsize, T_wav), the best of
    `n_candidate_gen_per_text` candidates a slot by CLAP similarity."""
    cond = pipeline.conditioner
    n = batchsize * max(n_candidate_gen_per_text, 1)
    if original_audio_file_path is not None:
        if not hasattr(cond, "audio_embed"):
            raise ValueError("original_audio_file_path needs a conditioner with an audio tower "
                             "(models.clap.Clap); this one only embeds text")
        from tango_tpu_torch.audio.wav import read_wav_file

        wav = read_wav_file(original_audio_file_path, int(duration * 102.4) * 160)
        film_cond = np.repeat(cond.audio_embed(np.asarray(wav, np.float32)), n, axis=0)
    else:
        film_cond = np.repeat(cond.text_embed([text]), n, axis=0)
    film_uncond = cond.unconditional_embed(n)
    latents = pipeline.sample_latents(
        film_cond, film_uncond, pipeline.generator(seed),
        latent_t_size=duration_to_latent_t_size(duration), ddim_steps=ddim_steps,
        guidance_scale=guidance_scale)
    wavs = pipeline.decode(_guard(latents))[:n]
    if n_candidate_gen_per_text > 1:
        sims = cond.similarity(wavs.astype(np.float32) / 32768.0, text)
        return wavs[rerank(wavs, sims, batchsize)]
    return wavs[:batchsize]


def stochastic_encode_timesteps(all_ts_desc, t_enc: int) -> Tuple[int, int]:
    """(noising timestep, first denoising timestep) for style transfer: the
    reference noises at the ascending DDIM index t_enc and then denoises
    every step strictly below it. For t_enc past the schedule (strength
    >= 1.0) both saturate at its top."""
    n_ts = len(all_ts_desc)
    if t_enc < n_ts:
        return int(all_ts_desc[n_ts - t_enc - 1]), int(all_ts_desc[n_ts - t_enc])
    return int(all_ts_desc[0]), int(all_ts_desc[0])


def style_transfer(
    pipeline: AudioLDMPipeline,
    text: str,
    original_audio_file_path: str,
    transfer_strength: float,
    seed: int = 42,
    duration: float = 10.0,
    batchsize: int = 1,
    guidance_scale: float = 2.5,
    ddim_steps: int = 200,
) -> np.ndarray:
    """Noise the source's latent to strength * steps and denoise it under
    the text -> int16 waveforms (batchsize, T_wav)."""
    gen = pipeline.generator(seed)
    z0 = _guard(pipeline.encode_first_stage(
        pipeline.source_mel(original_audio_file_path, duration), gen))
    z0 = z0.repeat_interleave(batchsize, 0)
    t_start_idx = int(transfer_strength * ddim_steps)
    if t_start_idx <= 0:
        # zero denoising steps: the reference returns the un-noised source
        latents = z0
    else:
        t_noise, t_denoise = stochastic_encode_timesteps(
            pipeline.scheduler.timesteps(ddim_steps), t_start_idx)
        noise = randn_rows(z0.shape, gen, pipeline.device)
        noisy = pipeline.scheduler.add_noise(z0, noise, torch.full((z0.shape[0],), t_noise))
        cond = pipeline.conditioner
        latents = pipeline.sample_latents(
            np.repeat(cond.text_embed([text]), batchsize, axis=0),
            cond.unconditional_embed(batchsize), gen, latent_t_size=z0.shape[1],
            ddim_steps=ddim_steps, guidance_scale=guidance_scale, init_latents=noisy,
            t_start=t_denoise)
    # the reference drops the last 3 latent frames before decoding
    return pipeline.decode(latents[:, :-3])[:batchsize]


def inpainting_mask(lt: int, lf: int, time_ratio: Tuple[float, float],
                    freq_ratio: Tuple[float, float]) -> np.ndarray:
    """(1, lt, lf, 1) f32, 1 where the latent is regenerated: the time span
    [t0, t1) of the clip and the frequency span [f0, f1) of the bins."""
    t_idx, f_idx = np.arange(lt) / lt, np.arange(lf) / lf
    regen_t = (t_idx >= time_ratio[0]) & (t_idx < time_ratio[1])
    regen_f = (f_idx >= freq_ratio[0]) & (f_idx < freq_ratio[1])
    return (regen_t[:, None] | regen_f[None, :]).astype(np.float32)[None, :, :, None]


def super_resolution_and_inpainting(
    pipeline: AudioLDMPipeline,
    text: str,
    original_audio_file_path: str,
    seed: int = 42,
    ddim_steps: int = 200,
    duration: float = 10.0,
    batchsize: int = 1,
    guidance_scale: float = 2.5,
    time_mask_ratio_start_and_end: Tuple[float, float] = (0.10, 0.15),
    freq_mask_ratio_start_and_end: Tuple[float, float] = (1.0, 1.0),
) -> np.ndarray:
    """Masked regeneration: the latent inside the time or frequency ratios
    regenerated under the text, the rest pinned to the source ->
    int16 waveforms (batchsize, T_wav). A time span (0.10, 0.15) inpaints
    10%..15% of the clip; a frequency span (0.75, 1.0) regenerates the top
    quarter of the mel bins (super-resolution)."""
    gen = pipeline.generator(seed)
    mel = pipeline.source_mel(original_audio_file_path, duration).repeat_interleave(batchsize, 0)
    z0 = pipeline.encode_first_stage(mel, gen)
    mask = inpainting_mask(z0.shape[1], z0.shape[2], time_mask_ratio_start_and_end,
                           freq_mask_ratio_start_and_end)
    cond = pipeline.conditioner
    latents = pipeline.sample_masked(
        z0, np.repeat(cond.text_embed([text]), batchsize, axis=0),
        cond.unconditional_embed(batchsize), mask, gen, ddim_steps=ddim_steps,
        guidance_scale=guidance_scale)
    return pipeline.decode(latents)[:batchsize]
