"""SFT trainer, port of tango_tpu/train/sft.py for one card.

The step: the frozen VAE encoder turns fbanks into latents drawn from the
posterior (no gradient), `AudioDiffusion.loss` gives the min-SNR-weighted
diffusion loss, autograd runs back through the UNet (remat'd when the
diffusion was built with `remat=True`; the GroupNorm and attention kernels
carry their own backward kernels), and AdamW steps with a linear (or cosine,
or constant) schedule and gradient accumulation. Text is encoded by the
frozen T5 outside the step (`encode_batches`), as in JAX. Validation runs
the loss at t = N/2; `fit` keeps the best checkpoint.

Where JAX is pure, the port updates in place: `train_step` changes the
UNet's parameters and the optimizer's moments and returns the same state.
The device mesh and multi-process training are not ported yet (ROADMAP
queue A #10).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from tango_tpu_torch.configs import TrainConfig
from tango_tpu_torch.models.diffusion import AudioDiffusion
from tango_tpu_torch.models.vae import AutoencoderKL
from tango_tpu_torch.utils.checkpoint import save_native


def make_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """Learning rate as a function of the update count (from 0), the
    reference's transformers.get_scheduler kinds in optax's form: linear
    (default), cosine, constant, constant_with_warmup. A warmup of
    num_warmup_steps ramps from 0 first, except for "constant", which
    ignores it as HF's get_constant_schedule does."""
    kind, lr, warm = cfg.lr_scheduler_type, cfg.learning_rate, cfg.num_warmup_steps
    decay = max(total_steps - warm, 1)
    if kind == "linear":
        def main(n):
            return lr * (1.0 - min(n, decay) / decay)
    elif kind == "cosine":
        def main(n):
            return lr * 0.5 * (1.0 + math.cos(math.pi * min(n, decay) / decay))
    elif kind in ("constant", "constant_with_warmup"):
        def main(n):
            return lr
    else:
        raise ValueError(f"lr_scheduler_type {kind!r} not supported "
                         "(linear/cosine/constant/constant_with_warmup)")
    if warm <= 0 or kind == "constant":
        return main
    return lambda n: lr * min(n, warm) / warm if n < warm else main(n - warm)


class AccumulatingAdamW:
    """torch.optim.AdamW with optax.MultiSteps' gradient accumulation.

    Call `step()` after each micro-step's backward. Autograd sums the k
    micro-gradients in `.grad`; on the k-th call they are divided by k (the
    mean, as MultiSteps takes), the learning rate is set from the schedule at
    the update count, AdamW steps, and the gradients are cleared. Micro-steps
    do not advance the schedule. Returns whether it updated."""

    def __init__(self, params: Iterable[nn.Parameter], cfg: TrainConfig, total_steps: int):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_schedule(cfg, total_steps)
        self.k = max(cfg.gradient_accumulation_steps, 1)
        self.opt = torch.optim.AdamW(self.params, lr=self.schedule(0),
                                     betas=(cfg.adam_beta1, cfg.adam_beta2),
                                     eps=cfg.adam_epsilon, weight_decay=cfg.weight_decay)
        self.mini_step = 0
        self.updates = 0

    def step(self) -> bool:
        self.mini_step += 1
        if self.mini_step < self.k:
            return False
        if self.k > 1:
            for p in self.params:
                if p.grad is not None:
                    p.grad.div_(self.k)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.mini_step = 0
        self.updates += 1
        return True


def make_optimizer(cfg: TrainConfig, total_steps: int, params) -> AccumulatingAdamW:
    return AccumulatingAdamW(params, cfg, total_steps)


@dataclasses.dataclass
class TrainState:
    params: nn.Module               # the UNet, updated in place
    opt_state: AccumulatingAdamW
    step: int = 0                   # micro-steps taken, as JAX's state.step


def encode_batches(loader, tokenizer, t5: nn.Module, max_text_length: int = 128):
    """A callable giving the loader's batches as {fbank, text_embeds,
    text_mask} on the T5's device, the captions encoded by the frozen T5."""
    device = next(t5.parameters()).device

    def batches():
        for raw in loader:
            tok = tokenizer(raw["captions"], max_length=max_text_length, padding="max_length",
                            truncation=True, return_tensors="np")
            ids = torch.as_tensor(tok["input_ids"], dtype=torch.long, device=device)
            mask = torch.as_tensor(tok["attention_mask"], dtype=torch.long, device=device)
            with torch.no_grad():
                embeds = t5(ids, mask)
            yield {"fbank": torch.as_tensor(raw["fbank"], device=device),
                   "text_embeds": embeds, "text_mask": mask}

    return batches


class SFTTrainer:
    """The train and eval steps and the epoch loop on the UNet's device."""

    def __init__(self, diffusion: AudioDiffusion, vae: AutoencoderKL, train_config: TrainConfig,
                 total_steps: int):
        self.diffusion = diffusion
        self.vae = vae.requires_grad_(False)
        self.cfg = train_config
        self.total_steps = total_steps
        self.device = diffusion.unet.conv_in.weight.device

    def init_state(self, generator: Optional[torch.Generator] = None, params=None) -> TrainState:
        """Fresh optimizer state over the UNet's weights: seeded random ones
        from `generator`, or `params` (a state dict) to train on from given
        weights."""
        unet = self.diffusion.unet
        if params is None:
            self.diffusion.init_params(generator)
        else:
            unet.load_state_dict(params)
        unet.requires_grad_(True)
        return TrainState(unet, make_optimizer(self.cfg, self.total_steps, unet.parameters()))

    @torch.no_grad()
    def encode_latents(self, fbank: torch.Tensor, generator=None) -> torch.Tensor:
        """fbank (B, T, n_mels) -> scaled latents (B, T/4, n_mels/4, C)."""
        return self.vae.encode_first_stage(fbank[..., None], generator)

    def _inputs(self, batch: Dict[str, torch.Tensor]):
        return (torch.as_tensor(batch["fbank"], dtype=torch.float32, device=self.device),
                torch.as_tensor(batch["text_embeds"], device=self.device),
                torch.as_tensor(batch["text_mask"], device=self.device))

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor], generator=None):
        """One micro-step on {fbank (B,T,M), text_embeds (B,S,D), text_mask (B,S)}
        -> (state, loss as a 0-d tensor on the device)."""
        fbank, embeds, mask = self._inputs(batch)
        latents = self.encode_latents(fbank, generator)
        loss = self.diffusion.loss(latents, embeds, mask, generator)
        loss.backward()
        state.opt_state.step()
        state.step += 1
        return state, loss.detach()

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, generator=None) -> torch.Tensor:
        fbank, embeds, mask = self._inputs(batch)
        latents = self.encode_latents(fbank, generator)
        return self.diffusion.loss(latents, embeds, mask, generator, validation_mode=True)

    def fit(
        self,
        state: TrainState,
        train_batches: Callable[[], Iterable[dict]],
        val_batches: Callable[[], Iterable[dict]],
        generator: Optional[torch.Generator],
        output_dir: str,
        num_epochs: Optional[int] = None,
        log_fn: Callable[[dict], None] = lambda d: None,
    ) -> TrainState:
        """Epoch loop with validation and checkpoints.

        checkpointing_steps: "best" saves `best` on every validation
        improvement (and `epoch_N` every save_every epochs), "epoch" saves
        `epoch_N` every epoch as well, an integer N saves `step_K` every N
        micro-batches. max_train_steps caps the optimizer updates."""
        cs = str(self.cfg.checkpointing_steps)
        if cs not in ("best", "epoch") and not (cs.isdigit() and int(cs) > 0):
            raise ValueError("checkpointing_steps must be 'best', 'epoch' or a positive "
                             f"integer, got {cs!r}")
        os.makedirs(output_dir, exist_ok=True)
        save_every = int(cs) if cs.isdigit() else None
        num_epochs = self.cfg.num_train_epochs if num_epochs is None else num_epochs
        summary_path = os.path.join(output_dir, "summary.jsonl")
        best_val = float("inf")
        global_step = 0
        ga = max(self.cfg.gradient_accumulation_steps, 1)
        done = False

        def save(name, manifest):
            save_native(os.path.join(output_dir, name), state.params.state_dict(), manifest)

        for epoch in range(num_epochs):
            t0 = time.time()
            # losses stay on the device: one fetch per epoch, not a sync per step
            losses = []
            for batch in train_batches():
                state, loss = self.train_step(state, batch, generator)
                losses.append(loss)
                global_step += 1
                if save_every and global_step % save_every == 0:
                    save(f"step_{global_step}", {"epoch": epoch, "step": global_step})
                if (self.cfg.max_train_steps is not None
                        and global_step // ga >= self.cfg.max_train_steps):
                    done = True
                    break
            train_loss = float(torch.stack(losses).mean()) if losses else 0.0
            vlosses = [self.eval_step(state, batch, generator) for batch in val_batches()]
            val_loss = float(torch.stack(vlosses).mean()) if vlosses else 0.0

            record = {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
                      "time_s": round(time.time() - t0, 2), "step": state.step}
            log_fn(record)
            with open(summary_path, "a") as f:
                f.write(json.dumps(record) + "\n")
            if val_loss < best_val:
                best_val = val_loss
                save("best", {"epoch": epoch, "val_loss": val_loss})
            periodic = cs == "best" and self.cfg.save_every and (epoch + 1) % self.cfg.save_every == 0
            if cs == "epoch" or periodic:
                save(f"epoch_{epoch}", {"epoch": epoch, "val_loss": val_loss})
            if done:
                break
        return state
