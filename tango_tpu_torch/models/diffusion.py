"""AudioDiffusion, port of tango_tpu/models/diffusion.py: the SFT loss and
CFG sampling.

`loss` is the training objective: uniform timesteps (n // 2 in validation
mode), q-sample noising, epsilon or v targets, optional min-SNR-gamma
weights and the 10% unconditional dropout of the text embeddings (and of
every extra conditioning stream of the same samples, Mustango's). The
sampling loop runs in Python over the host-side timestep grid (JAX compiles
it into one `lax.scan`). Latents are (B, T, F, C) f32; the UNet sees the
model dtype and its output is upcast to f32 before guidance, the scheduler
step and the loss.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from tango_tpu_torch.configs import SchedulerConfig, UNetConfig, resolve_device
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.parallel.mesh import seq_mesh
from tango_tpu_torch.schedulers.ddim import DDIMScheduler
from tango_tpu_torch.schedulers.ddpm import DDPMScheduler
from tango_tpu_torch.utils.init import init_random_

Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def randn_rows(shape, generator: Generators, device) -> torch.Tensor:
    """Standard normal f32 noise of `shape`. With a sequence of generators,
    row i of the batch comes from generator i alone, so a row's noise does not
    depend on what else is in the batch."""
    if generator is None or isinstance(generator, torch.Generator):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    if len(generator) != shape[0]:
        raise ValueError(f"{len(generator)} generators for a batch of {shape[0]}")
    return torch.cat([torch.randn((1, *shape[1:]), generator=g, device=device,
                                  dtype=torch.float32) for g in generator])


@dataclasses.dataclass(eq=False)
class AudioDiffusion:
    """The UNet with its schedulers. `unet` is a module, or a UNetConfig from
    which one is built on `device` in `dtype` (with `remat`), its weights
    left uninitialised until `init_params` or a `load_state_dict`.
    `latent_sharder` (sequence parallelism, JAX's field:
    `functools.partial(parallel.mesh.shard_latents_seq, mesh=mesh)`) goes to
    the UNet, built or given; its forward returns the whole prediction on
    every rank, so the sampler and the schedulers run as without it."""

    unet: Union[UNet2DConditionModel, UNetConfig]
    scheduler_config: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    snr_gamma: Optional[float] = None
    uncondition: bool = False
    latent_t_size: int = 256
    latent_f_size: int = 16
    dtype: torch.dtype = torch.float32
    remat: bool = False
    latent_sharder: Optional[Callable] = None
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if isinstance(self.unet, UNetConfig):
            with torch.device("meta"):
                unet = UNet2DConditionModel(self.unet, remat=self.remat,
                                            latent_sharder=self.latent_sharder)
            self.unet = unet.to_empty(device=resolve_device(self.device)).to(self.dtype)
        elif self.latent_sharder is not None:
            seq_mesh(self.latent_sharder)
            self.unet.latent_sharder = self.latent_sharder
        self.noise_scheduler = DDPMScheduler.create(self.scheduler_config)
        self.inference_scheduler = DDPMScheduler.create(self.scheduler_config)

    @property
    def unet_config(self) -> UNetConfig:
        return self.unet.cfg

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> dict:
        """Seeded random UNet weights (utils.init), in place; returns the state dict."""
        return init_random_(self.unet, generator).state_dict()

    def loss(
        self,
        latents: torch.Tensor,
        text_embeds: torch.Tensor,
        text_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        validation_mode: bool = False,
        extra_contexts: Sequence[torch.Tensor] = (),
        extra_masks: Sequence[torch.Tensor] = (),
        *,
        timesteps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        drop: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Diffusion MSE loss on latents (B, T, F, C), reduced in f32.

        The timesteps, the noise and the (B,) uncondition drop mask are drawn
        from `generator` in that order unless given (the tests feed both
        packages the same draws). `extra_contexts` are the UNet's extra
        streams after the text, each with its mask in `extra_masks`."""
        # an extra stream without its own mask would take the text's padding
        assert len(extra_masks) == len(extra_contexts), (
            f"extra_masks ({len(extra_masks)}) must match extra_contexts "
            f"({len(extra_contexts)})")
        sched = self.noise_scheduler
        n = sched.config.num_train_timesteps
        bsz, device = latents.shape[0], latents.device
        if validation_mode:
            timesteps = torch.full((bsz,), n // 2, dtype=torch.long, device=device)
        elif timesteps is None:
            timesteps = torch.randint(0, n, (bsz,), generator=generator, device=device)
        timesteps = torch.as_tensor(timesteps, dtype=torch.long, device=device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=device,
                                dtype=torch.float32)
        if self.uncondition and not validation_mode:
            # zero the embeddings of ~10% of the samples, the same samples in
            # every stream; the masks stay
            if drop is None:
                drop = torch.rand((bsz,), generator=generator, device=device) < 0.1
            drop = torch.as_tensor(drop, dtype=torch.bool, device=device)
            text_embeds = torch.where(drop[:, None, None], 0.0, text_embeds)
            extra_contexts = [torch.where(drop[:, None, None], 0.0, c) for c in extra_contexts]

        latents = latents.float()
        noisy = sched.add_noise(latents, noise, timesteps)
        p = sched.config.prediction_type
        if p == "epsilon":
            target = noise
        elif p == "v_prediction":
            target = sched.get_velocity(latents, noise, timesteps)
        else:
            raise ValueError(f"Unknown prediction type {p}")

        contexts = [text_embeds, *extra_contexts] if extra_contexts else text_embeds
        masks = [text_mask, *extra_masks] if extra_masks else text_mask
        pred = self.unet(noisy.to(self.unet.conv_in.weight.dtype), timesteps, contexts, masks)
        err = (pred.float() - target) ** 2
        if self.snr_gamma is None:
            return err.mean()
        snr = sched.snr(timesteps.cpu()).to(device)
        weights = torch.clamp(snr, max=self.snr_gamma) / snr
        per_sample = err.mean(dim=tuple(range(1, err.dim())))
        return (per_sample * weights).mean()

    @torch.no_grad()
    def sample(
        self,
        cond_embeds: torch.Tensor,
        cond_mask: torch.Tensor,
        generator: Generators = None,
        num_steps: int = 100,
        guidance_scale: float = 3.0,
        uncond_embeds: Optional[torch.Tensor] = None,
        uncond_mask: Optional[torch.Tensor] = None,
        scheduler: str = "ddpm",
        eta: float = 0.0,
        extra_contexts: Sequence[torch.Tensor] = (),
        extra_masks: Sequence[torch.Tensor] = (),
        uncond_extra_contexts: Sequence[torch.Tensor] = (),
        uncond_extra_masks: Sequence[torch.Tensor] = (),
        noise_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        latent_t_size: Optional[int] = None,
    ) -> torch.Tensor:
        """CFG denoising loop -> latents (B, T, F, C) f32.

        CFG runs when `uncond_embeds` is given, with the batch ordered
        [uncond, cond]. `scheduler="ddim"` steps a DDIM scheduler built from
        `scheduler_config` with `eta` (0: deterministic) instead of DDPM. The extra streams (Mustango's beats and chords) come
        with a mask each and, under CFG, an unconditional context each; their
        unconditional masks default to the conditional ones.
        `noise_override=(init_latents, step_noises)` replaces the random
        draws (step_noises is (num_steps, B, T, F, C)), so that a test can
        feed the JAX sampler and this one the same noise."""
        sched = (DDIMScheduler.create(self.scheduler_config) if scheduler == "ddim"
                 else self.inference_scheduler)
        device = cond_embeds.device
        timesteps = sched.timesteps(num_steps)
        bsz = cond_embeds.shape[0]
        shape = (bsz, latent_t_size or self.latent_t_size, self.latent_f_size,
                 self.unet_config.in_channels)
        if noise_override is not None:
            init_latents, step_noises = noise_override
            latents = torch.as_tensor(init_latents, dtype=torch.float32, device=device)
            latents = latents * sched.init_noise_sigma
            step_noises = torch.as_tensor(step_noises, dtype=torch.float32, device=device)
        else:
            step_noises = None
            latents = randn_rows(shape, generator, device) * sched.init_noise_sigma

        cfg = uncond_embeds is not None
        if cfg:
            ctx = torch.cat([uncond_embeds, cond_embeds])
            msk = torch.cat([uncond_mask, cond_mask])
            if extra_contexts:
                # zip would drop streams on a mismatch
                assert len(uncond_extra_contexts) == len(extra_contexts), (
                    "CFG with extra conditioning streams needs one unconditional context "
                    f"per stream ({len(uncond_extra_contexts)} vs {len(extra_contexts)})")
            extra = [torch.cat([u, c]) for u, c in zip(uncond_extra_contexts, extra_contexts)]
            um = uncond_extra_masks or extra_masks
            if extra_masks:
                assert len(um) == len(extra_masks), (
                    "CFG with extra conditioning streams needs one unconditional mask per "
                    f"stream ({len(um)} vs {len(extra_masks)})")
            extra_m = [torch.cat([u, m]) for u, m in zip(um, extra_masks)]
        else:
            ctx, msk = cond_embeds, cond_mask
            extra, extra_m = list(extra_contexts), list(extra_masks)
        # a bare text mask would otherwise apply to every extra stream
        assert len(extra_m) == len(extra), (
            f"extra masks ({len(extra_m)}) must match extra contexts ({len(extra)})")
        if extra:
            ctx, msk = [ctx, *extra], [msk, *extra_m]

        for i, t in enumerate(timesteps.tolist()):
            lat_in = torch.cat([latents, latents]) if cfg else latents
            lat_in = sched.scale_model_input(lat_in, t)
            t_b = torch.full((lat_in.shape[0],), t, dtype=torch.long, device=device)
            pred = self.unet(lat_in, t_b, ctx, msk).float()
            if cfg:
                pred_uncond, pred_text = pred.chunk(2)
                pred = pred_uncond + guidance_scale * (pred_text - pred_uncond)
            noise = (step_noises[i] if step_noises is not None
                     else randn_rows(latents.shape, generator, device))
            if scheduler == "ddim":
                latents, _ = sched.step(pred, t, latents, noise, num_steps, eta=eta)
            else:
                latents, _ = sched.step(pred, t, latents, noise, num_steps)
        return latents
