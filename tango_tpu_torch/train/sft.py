"""SFT trainer, port of tango_tpu/train/sft.py.

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

Under a mesh (`mesh=`, parallel.mesh) the UNet is sharded over 'model' by
the TP rules and each data rank trains on its rows of the global batch. The
random draws (the posterior noise, the timesteps, the noise, the drop mask)
are made for the whole global batch from the generator, which every rank
seeds alike, and each rank takes its rows: the step is the single-process
step at the global batch. The gradients are all-reduced as a mean over
'data' before AdamW steps (elementwise, no global-norm clipping, so it
works on shards); every reported loss is the mean over 'data', so every
rank takes the same branches; only rank 0 writes, and a checkpoint gathers
the TP shards into the full state dict first.

Where the diffusion's UNet has a latent sharder (sequence parallelism,
`parallel.mesh.shard_latents_seq`), its mesh is the trainer's (`mesh=` may
be left out, as JAX's dry run leaves it out), the UNet stays whole on every
model rank (`shard_params(tp=False)`), and the gradients, partial on each
model rank, are summed over 'model' as they are averaged over 'data'. Every
model rank of a data rank draws and takes the same rows, so each computes
the same loss.
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
from tango_tpu_torch.models.vae import AutoencoderKL, sample_diagonal_gaussian
from tango_tpu_torch.parallel import mesh as pmesh
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
    do not advance the schedule. Returns whether it updated. `before_update`,
    where given, runs on the parameters just before an update, their
    gradients still summed (the data-parallel all-reduce)."""

    def __init__(self, params: Iterable[nn.Parameter], cfg: TrainConfig, total_steps: int,
                 before_update: Optional[Callable[[list], None]] = None):
        self.params = [p for p in params if p.requires_grad]
        self.before_update = before_update
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
        if self.before_update is not None:
            self.before_update(self.params)
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


def make_optimizer(cfg: TrainConfig, total_steps: int, params, mesh=None,
                   seq: bool = False) -> AccumulatingAdamW:
    """AdamW with accumulation; under a mesh the gradients are averaged over
    'data' once an update, before it, and with `seq` (a sequence-parallel
    UNet) also summed over 'model'."""
    hook = None
    if mesh is not None and (mesh.data_group is not None or seq and mesh.model_group is not None):
        def hook(ps):
            pmesh.all_reduce_grads(ps, mesh, seq=seq)
    return AccumulatingAdamW(params, cfg, total_steps, before_update=hook)


def trainer_mesh(unet: nn.Module, mesh: Optional[pmesh.Mesh]) -> Optional[pmesh.Mesh]:
    """The mesh a trainer of `unet` runs on: `mesh`, or the latent sharder's
    where it is left out; a sharder over another mesh raises."""
    seq = pmesh.seq_mesh(unet.latent_sharder)
    if seq is not None and mesh is not None and seq is not mesh:
        raise ValueError("the UNet's latent sharder splits T over another mesh than the "
                         "trainer's")
    return mesh if mesh is not None else seq


def place_unet(unet: nn.Module, mesh: Optional[pmesh.Mesh]) -> bool:
    """Put the trained UNet on the mesh: replicated over 'model' where it
    runs sequence-parallel, else sharded by the TP rules. Returns whether it
    runs sequence-parallel."""
    seq = pmesh.seq_mesh(unet.latent_sharder) is not None
    if mesh is not None:
        pmesh.shard_params(unet, mesh, tp=not seq)
    return seq


def _draw(generator, kind, shape, device) -> torch.Tensor:
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=device)
    if kind == "drop":  # the 10% uncondition mask
        return torch.rand(shape, generator=generator, device=device) < 0.1
    return torch.randint(0, kind, shape, generator=generator, device=device)


def draw_latents(vae: AutoencoderKL, diffusion: AudioDiffusion, mesh, fbanks, generator,
                 validation_mode: bool, names=("posterior",), draws: Optional[dict] = None):
    """The frozen VAE's posterior draws of this rank's fbanks, one a name in
    `names`, and the loss's draws (timesteps unless validating, noise, and
    the drop mask where `diffusion.uncondition` and not validating), all made
    for the global batch in the single-process step's order and cut to this
    rank's rows: a step under a mesh draws the numbers one process draws at
    the global batch. `draws` replaces any by given global arrays (the tests
    feed JAX's). Returns (latents, {name: this rank's rows})."""
    with torch.no_grad():
        moments = [vae.encode_moments(f[..., None]) for f in fbanks]
    shape = moments[0][0].shape
    n = shape[0] * (1 if mesh is None else mesh.shape["data"])
    rows = slice(0, n) if mesh is None else pmesh.process_local_batch_slice(mesh, n)
    full = (n, *shape[1:])
    specs = [(p, "normal", full) for p in names]
    if not validation_mode:
        specs.append(("timesteps", diffusion.noise_scheduler.config.num_train_timesteps, (n,)))
    specs.append(("noise", "normal", full))
    if diffusion.uncondition and not validation_mode:
        specs.append(("drop", "drop", (n,)))
    device = moments[0][0].device
    d = {name: (torch.as_tensor(draws[name], device=device) if draws and name in draws
                else _draw(generator, kind, shp, device))[rows]
         for name, kind, shp in specs}
    latents = [vae.cfg.scale_factor * sample_diagonal_gaussian(m, lv, noise=d[p].to(m.dtype))
               for (m, lv), p in zip(moments, names)]
    return latents, d


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
                 total_steps: int, mesh: Optional[pmesh.Mesh] = None):
        self.diffusion = diffusion
        self.vae = vae.requires_grad_(False)
        self.cfg = train_config
        self.total_steps = total_steps
        self.mesh = trainer_mesh(diffusion.unet, mesh)
        self.device = diffusion.unet.conv_in.weight.device

    def init_state(self, generator: Optional[torch.Generator] = None, params=None) -> TrainState:
        """Fresh optimizer state over the UNet's weights: seeded random ones
        from `generator`, or `params` (a full state dict) to train on from
        given weights; then, under a mesh, sharded over 'model' (replicated
        where the UNet runs sequence-parallel)."""
        unet = self.diffusion.unet
        if params is None:
            self.diffusion.init_params(generator)
        else:
            unet.load_state_dict(params)
        seq = place_unet(unet, self.mesh)
        unet.requires_grad_(True)
        return TrainState(unet, make_optimizer(self.cfg, self.total_steps, unet.parameters(),
                                               self.mesh, seq))

    def state_dict(self, state: TrainState) -> dict:
        """The UNet's full state dict (the TP shards gathered under a mesh):
        what a checkpoint holds. Every rank must call it."""
        if self.mesh is None:
            return state.params.state_dict()
        return pmesh.full_state_dict(state.params, self.mesh)

    @torch.no_grad()
    def encode_latents(self, fbank: torch.Tensor, generator=None) -> torch.Tensor:
        """fbank (B, T, n_mels) -> scaled latents (B, T/4, n_mels/4, C)."""
        return self.vae.encode_first_stage(fbank[..., None], generator)

    def _loss(self, batch, generator, validation_mode: bool, draws: Optional[dict] = None):
        """The loss on this rank's rows, with the global batch's draws."""
        fbank, embeds, mask = self._inputs(batch)
        (latents,), d = draw_latents(self.vae, self.diffusion, self.mesh, [fbank], generator,
                                     validation_mode, draws=draws)
        return self.diffusion.loss(latents, embeds, mask, generator,
                                   validation_mode=validation_mode, timesteps=d.get("timesteps"),
                                   noise=d["noise"], drop=d.get("drop"))

    def _inputs(self, batch: Dict[str, torch.Tensor]):
        return (torch.as_tensor(batch["fbank"], dtype=torch.float32, device=self.device),
                torch.as_tensor(batch["text_embeds"], device=self.device),
                torch.as_tensor(batch["text_mask"], device=self.device))

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor], generator=None, *,
                   draws: Optional[dict] = None):
        """One micro-step on {fbank (B,T,M), text_embeds (B,S,D), text_mask (B,S)},
        this rank's rows under a mesh -> (state, the global batch's loss as a
        0-d tensor on the device). `draws` ({posterior, timesteps, noise,
        drop}, global arrays) replaces the generator's."""
        loss = self._loss(batch, generator, False, draws)
        loss.backward()
        state.opt_state.step()
        state.step += 1
        return state, pmesh.mean_over_data(loss.detach(), self.mesh)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, generator=None) -> torch.Tensor:
        return pmesh.mean_over_data(self._loss(batch, generator, True), self.mesh)

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
        is_main = self.mesh is None or self.mesh.is_main
        if is_main:
            os.makedirs(output_dir, exist_ok=True)
        save_every = int(cs) if cs.isdigit() else None
        num_epochs = self.cfg.num_train_epochs if num_epochs is None else num_epochs
        summary_path = os.path.join(output_dir, "summary.jsonl")
        best_val = float("inf")
        global_step = 0
        ga = max(self.cfg.gradient_accumulation_steps, 1)
        done = False

        def save(name, manifest):
            sd = self.state_dict(state)  # a collective under a mesh: every rank
            if is_main:
                save_native(os.path.join(output_dir, name), sd, manifest)

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
            if is_main:
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
