"""AudioDiffusion CFG sampling, port of `sample` in tango_tpu/models/diffusion.py.

The loop runs in Python over the host-side timestep grid (JAX compiles it
into one `lax.scan`). Latents are (B, T, F, C) f32; the UNet sees the model
dtype and its output is upcast to f32 before guidance and the scheduler step.
The training loss is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from tango_tpu_torch.configs import SchedulerConfig, UNetConfig
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.schedulers.ddpm import DDPMScheduler

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
    unet: UNet2DConditionModel
    scheduler_config: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    latent_t_size: int = 256
    latent_f_size: int = 16

    def __post_init__(self):
        self.inference_scheduler = DDPMScheduler.create(self.scheduler_config)

    @property
    def unet_config(self) -> UNetConfig:
        return self.unet.cfg

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
        noise_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        latent_t_size: Optional[int] = None,
    ) -> torch.Tensor:
        """CFG denoising loop -> latents (B, T, F, C) f32.

        CFG runs when `uncond_embeds` is given, with the batch ordered
        [uncond, cond]. `noise_override=(init_latents, step_noises)` replaces
        the random draws (step_noises is (num_steps, B, T, F, C)), so that a
        test can feed the JAX sampler and this one the same noise."""
        sched = self.inference_scheduler
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
        else:
            ctx, msk = cond_embeds, cond_mask

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
            latents, _ = sched.step(pred, t, latents, noise, num_steps)
        return latents
