"""DPO trainer (Tango 2), port of tango_tpu/train/dpo.py.

Preference alignment on chosen / rejected audio pairs (the reference's
tango2/tango2-train.py:291-670). Against SFT: both fbanks of a pair are
encoded by the frozen VAE every step (:551-561); the reference UNet is a
frozen copy of the starting UNet (:429-431, `models.dpo.make_reference`),
passed to the steps beside the state; the first `sft_first_epochs` epochs
train the base loss on the chosen audio only (:563-572). AdamW on
`AccumulatingAdamW`, with a linear decay to 0 over `total_steps` updates and
no warmup (:148-150, 464-468), the schedule advancing once an update. As in
`train.sft`, the steps update the UNet and the optimizer in place.

Under a mesh (`mesh=`) as `train.sft`: the trained UNet is sharded over
'model', each data rank takes its rows with the global batch's draws, the
gradients are averaged over 'data' before AdamW, the losses and metrics
are reduced over 'data', and rank 0 writes the gathered full state dict.
The reference UNet stays whole on every rank (the caller makes it before
sharding; JAX's CLI keeps it in bf16, replicated). A sequence-parallel UNet
(a latent sharder) trains as in `train.sft`: replicated, its gradients
summed over 'model'.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from tango_tpu_torch.configs import DPOConfig, TrainConfig
from tango_tpu_torch.models.dpo import DPOAudioDiffusion
from tango_tpu_torch.models.vae import AutoencoderKL
from tango_tpu_torch.parallel import mesh as pmesh
from tango_tpu_torch.train.sft import (
    TrainState,
    draw_latents,
    make_optimizer,
    place_unet,
    trainer_mesh,
)
from tango_tpu_torch.utils.checkpoint import save_native


class DPOTrainer:
    def __init__(self, diffusion: DPOAudioDiffusion, vae: AutoencoderKL, config: DPOConfig,
                 total_steps: int, mesh: Optional[pmesh.Mesh] = None):
        self.diffusion = diffusion
        self.mesh = trainer_mesh(diffusion.unet, mesh)
        self.vae = vae.requires_grad_(False)
        self.cfg = config
        self.total_steps = total_steps
        self.device = diffusion.unet.conv_in.weight.device
        # the linear decay to 0 of the reference's get_scheduler("linear",
        # num_warmup_steps=0, num_training_steps=max_train_steps)
        self.opt_cfg = TrainConfig(
            learning_rate=config.learning_rate, weight_decay=config.weight_decay,
            adam_beta1=config.adam_beta1, adam_beta2=config.adam_beta2,
            adam_epsilon=config.adam_epsilon,
            gradient_accumulation_steps=config.gradient_accumulation_steps,
            lr_scheduler_type="linear", num_warmup_steps=0)

    def init_state(self, unet_params=None) -> TrainState:
        """Fresh optimizer state over the UNet, loaded from `unet_params` (a
        state dict, the SFT'd starting point) when given, then sharded under
        a mesh. The caller takes the reference copy (`make_reference`)
        before training, and before `init_state` shards the UNet."""
        unet = self.diffusion.unet
        if unet_params is not None:
            unet.load_state_dict(unet_params)
        seq = place_unet(unet, self.mesh)
        unet.requires_grad_(True)
        return TrainState(unet, make_optimizer(self.opt_cfg, self.total_steps, unet.parameters(),
                                               self.mesh, seq))

    def _latents(self, fbanks, generator, validation_mode: bool, names):
        """`train.sft.draw_latents` on this rank's fbanks."""
        fbanks = [torch.as_tensor(f, dtype=torch.float32, device=self.device) for f in fbanks]
        return draw_latents(self.vae, self.diffusion, self.mesh, fbanks, generator,
                            validation_mode, names)

    def _text(self, batch):
        return (torch.as_tensor(batch["text_embeds"], device=self.device),
                torch.as_tensor(batch["text_mask"], device=self.device))

    def _update(self, state: TrainState, loss: torch.Tensor) -> TrainState:
        loss.backward()
        state.opt_state.step()
        state.step += 1
        return state

    def dpo_step(self, state: TrainState, ref_unet: nn.Module, batch, generator=None):
        """One micro-step on {fbank_w, fbank_l (B, T, M), text_embeds, text_mask}
        -> (state, loss, metrics), the loss and metrics 0-d tensors on the
        device, over the global batch."""
        (lat_w, lat_l), d = self._latents([batch["fbank_w"], batch["fbank_l"]], generator, False,
                                          ("posterior_w", "posterior_l"))
        embeds, mask = self._text(batch)
        loss, metrics = self.diffusion.dpo_loss(lat_w, lat_l, embeds, mask, generator,
                                                ref_unet=ref_unet, timesteps=d["timesteps"],
                                                noise=d["noise"], drop=d.get("drop"))
        metrics = {k: pmesh.mean_over_data(v, self.mesh) for k, v in metrics.items()}
        return (self._update(state, loss), pmesh.mean_over_data(loss.detach(), self.mesh),
                metrics)

    def sft_step(self, state: TrainState, batch, generator=None):
        """One SFT-first micro-step on the chosen audio only: the reference sets
        `latents = latent_w` ("Perform SFT on the prompt and preferred audio",
        tango2-train.py:563-567)."""
        (lat,), d = self._latents([batch["fbank_w"]], generator, False, ("posterior",))
        embeds, mask = self._text(batch)
        loss = self.diffusion.loss(lat, embeds, mask, generator, timesteps=d["timesteps"],
                                   noise=d["noise"], drop=d.get("drop"))
        return self._update(state, loss), pmesh.mean_over_data(loss.detach(), self.mesh)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, generator=None) -> torch.Tensor:
        """The fixed-t diffusion loss on single audio {fbank, text_embeds,
        text_mask}, as the reference validates (tango2-train.py:600-618)."""
        (lat,), d = self._latents([batch["fbank"]], generator, True, ("posterior",))
        embeds, mask = self._text(batch)
        loss = self.diffusion.loss(lat, embeds, mask, generator, validation_mode=True,
                                   noise=d["noise"])
        return pmesh.mean_over_data(loss, self.mesh)

    def fit(
        self,
        state: TrainState,
        ref_unet: nn.Module,
        train_batches: Callable[[], Iterable[dict]],
        generator: Optional[torch.Generator],
        output_dir: str,
        num_epochs: Optional[int] = None,
        val_batches: Optional[Callable[[], Iterable[dict]]] = None,
        log_fn: Callable[[dict], None] = lambda d: None,
    ) -> TrainState:
        """The epoch loop (tango2-train.py:600-664): one record an epoch with
        its phase; `best` saved on a validation improvement; `epoch_N` after
        the SFT-first phase every `save_every` epochs; `last` always.
        max_train_steps caps the updates. Losses stay on the device: one
        fetch an epoch."""
        is_main = self.mesh is None or self.mesh.is_main
        if is_main:
            os.makedirs(output_dir, exist_ok=True)
        num_epochs = self.cfg.num_train_epochs if num_epochs is None else num_epochs
        best_val = float("inf")
        max_updates = self.cfg.max_train_steps
        ga = max(self.cfg.gradient_accumulation_steps, 1)
        global_step = 0
        done = False

        def save(name, manifest=None):
            sd = (state.params.state_dict() if self.mesh is None
                  else pmesh.full_state_dict(state.params, self.mesh))  # every rank
            if is_main:
                save_native(os.path.join(output_dir, name), sd, manifest)

        for epoch in range(num_epochs):
            t0 = time.time()
            losses, accs = [], []
            sft_phase = epoch < self.cfg.sft_first_epochs
            for batch in train_batches():
                if sft_phase:
                    state, loss = self.sft_step(state, batch, generator)
                else:
                    state, loss, metrics = self.dpo_step(state, ref_unet, batch, generator)
                    accs.append(metrics["implicit_acc"])
                losses.append(loss)
                global_step += 1
                if max_updates is not None and global_step // ga >= max_updates:
                    done = True
                    break

            val_loss = None
            if val_batches is not None:
                vlosses = [self.eval_step(state, batch, generator) for batch in val_batches()]
                if vlosses:
                    val_loss = float(torch.stack(vlosses).mean())
            rec = {
                "epoch": epoch,
                "phase": "sft" if sft_phase else "dpo",
                "loss": float(torch.stack(losses).mean()) if losses else 0.0,
                "val_loss": val_loss,
                "implicit_acc": float(torch.stack(accs).mean()) if accs else None,
                "time_s": round(time.time() - t0, 2),
            }
            log_fn(rec)
            if is_main:
                with open(os.path.join(output_dir, "summary.jsonl"), "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if val_loss is not None and val_loss < best_val:
                best_val = val_loss
                save("best", rec)
            if not sft_phase and self.cfg.save_every and (epoch + 1) % self.cfg.save_every == 0:
                save(f"epoch_{epoch}", rec)
            if done:
                break
        # a final checkpoint always: with sft_first_epochs >= num_epochs and no
        # validation, neither save above fires
        save("last")
        return state
