"""Diffusion-DPO preference alignment (Tango 2), port of tango_tpu/models/dpo.py.

The reference's DPOAudioDiffusion (tango2/models.py:339-487), Diffusion-DPO
(arXiv 2311.12908): the winner and loser latents are stacked to 2B and share
each pair's timestep and noise; the trained UNet and the frozen reference
UNet each score both halves, and the loss is
-logsigmoid(-0.5 * beta * (model_diff - ref_diff)). The reference UNet is a
second module (a frozen copy of the starting UNet, `make_reference`), run
under no_grad.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tango_tpu_torch.models.diffusion import AudioDiffusion


def make_reference(unet: nn.Module, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """A frozen deep copy of `unet`, in `dtype` where given: the reference
    UNet of DPO."""
    ref = copy.deepcopy(unet).eval().requires_grad_(False)
    return ref if dtype is None else ref.to(dtype)


@dataclasses.dataclass(eq=False)
class DPOAudioDiffusion(AudioDiffusion):
    beta_dpo: float = 2000.0

    def dpo_loss(
        self,
        latents_w: torch.Tensor,
        latents_l: torch.Tensor,
        text_embeds: torch.Tensor,
        text_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        validation_mode: bool = False,
        *,
        ref_unet: nn.Module,
        timesteps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        drop: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, dict]:
        """latents_w / latents_l (B, T, F, C): the chosen and the rejected
        audio. Returns (loss, {raw_model_loss, raw_ref_loss, implicit_acc}),
        the metrics detached.

        The (B,) timesteps, the (B, T, F, C) noise and the (B,) uncondition
        drop mask of the winner half are drawn from `generator` in that order
        unless given, as JAX draws them from its key. Validation uses
        t = n - 1 (JAX's clamp of the reference's one-past-the-table t = n)."""
        sched = self.noise_scheduler
        n = sched.config.num_train_timesteps
        bsz, device = latents_w.shape[0], latents_w.device
        latents = torch.cat([latents_w, latents_l]).float()
        if validation_mode:
            t_half = torch.full((bsz,), n - 1, dtype=torch.long, device=device)
        elif timesteps is None:
            t_half = torch.randint(0, n, (bsz,), generator=generator, device=device)
        else:
            t_half = timesteps
        t_half = torch.as_tensor(t_half, dtype=torch.long, device=device)
        t = torch.cat([t_half, t_half])
        if noise is None:
            noise = torch.randn(latents_w.shape, generator=generator, device=device,
                                dtype=torch.float32)
        noise = torch.cat([noise, noise]).to(device=device, dtype=torch.float32)

        noisy = sched.add_noise(latents, noise, t)
        p = sched.config.prediction_type
        if p == "epsilon":
            target = noise
        elif p == "v_prediction":
            target = sched.get_velocity(latents, noise, t)
        else:
            raise ValueError(f"Unknown prediction type {p}")

        embeds = torch.cat([text_embeds, text_embeds])
        mask = torch.cat([text_mask, text_mask])
        if self.uncondition and not validation_mode:
            # the reference's quirk, kept: its mask indices come from
            # range(len(prompt)) after the repeat, so the dropout zeroes the
            # text of the winner half of a dropped pair only
            # (tango2/models.py:429-432); not in validation
            if drop is None:
                drop = torch.rand((bsz,), generator=generator, device=device) < 0.1
            drop = torch.as_tensor(drop, dtype=torch.bool, device=device)
            drop = torch.cat([drop, torch.zeros_like(drop)])
            embeds = torch.where(drop[:, None, None], 0.0, embeds)

        def per_sample_mse(unet):
            pred = unet(noisy.to(unet.conv_in.weight.dtype), t, embeds, mask)
            err = (pred.float() - target) ** 2
            return err.mean(dim=tuple(range(1, err.dim())))  # (2B,)

        model_w, model_l = per_sample_mse(self.unet).chunk(2)
        with torch.no_grad():
            ref_losses = per_sample_mse(ref_unet)
        ref_w, ref_l = ref_losses.chunk(2)
        inside = -0.5 * self.beta_dpo * ((model_w - model_l) - (ref_w - ref_l))
        loss = -F.logsigmoid(inside).mean()
        metrics = {
            "raw_model_loss": (0.5 * (model_w.mean() + model_l.mean())).detach(),
            "raw_ref_loss": ref_losses.mean(),
            "implicit_acc": (inside > 0).float().mean().detach(),
        }
        return loss, metrics

    def sft_loss(self, latents, text_embeds, text_mask, generator=None, validation_mode=False):
        """The SFT-first phase's loss: the base diffusion loss
        (tango2/models.py:358-419)."""
        return self.loss(latents, text_embeds, text_mask, generator, validation_mode)
