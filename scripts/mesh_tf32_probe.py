#!/usr/bin/env python3
"""Where a DP = 2 SFT step's parameters part from one process's, with TF32
convolutions on and off, on one CUDA card.

    python3 scripts/mesh_tf32_probe.py

The setup of chip_smoke.py's phase mesh (b): the full-width f32 UNet (remat,
min-SNR 5, uncondition), the seeded VAE with its encoder, 2 updates at
accumulation 1 on 2 global batches of 2 seeded synthetic 10.24 s WAVs whose
captions go through the full-width pipeline's T5. For each setting of
`torch.backends.cudnn.allow_tf32` (on, the port's default, then off;
matmuls without TF32 in both), one process trains at batch 2, then two
ranks sharing the card over gloo (parallel.launch) train at batch 1 each
with `SFTTrainer(mesh=)`; rank 0 prints one JSON line: both runs' losses,
the parameter tensors whose largest difference passes 1.5 lr (that
difference in lr, the reference value there, and how many elements pass
1.5, 2 and 2.5 lr), and the totals past 2 and 2.5 lr.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

WORK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                    "mesh_tf32_probe")


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = on


def rank(tf32: str) -> int:
    """One rank of the DP = 2 run; rank 0 compares with the saved reference."""
    from tango_tpu_torch.parallel import mesh as pmesh
    from tango_tpu_torch.train.sft import SFTTrainer

    set_tf32(tf32 == "1")
    job = torch.load(os.path.join(WORK, "job.pt"), weights_only=False)
    r, _, dev = pmesh.init_distributed()
    mesh = pmesh.make_mesh(data=2, model=1)
    diffusion, vae, cfg = cs.mesh_sft_setup(job, dev)
    trainer = SFTTrainer(diffusion, vae, cfg, total_steps=cs.MESH_DP_UPDATES, mesh=mesh)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    losses = []
    for b in torch.load(os.path.join(WORK, "dp_batches.pt")):
        state, loss = trainer.train_step(
            state, pmesh.shard_batch({k: v.to(dev) for k, v in b.items()}, mesh), gen)
        losses.append(float(loss))
    if r:
        return 0
    ref = torch.load(os.path.join(WORK, f"ref{tf32}.pt"), map_location="cpu")
    lr, rows = cfg.learning_rate, []
    for k, v in trainer.state_dict(state).items():
        want = ref[k].to(dev).float()
        d = (v.float() - want).abs()
        if float(d.max()) > 1.5 * lr:
            rows.append((float(d.max()) / lr, k, float(want.flatten()[int(d.argmax())]),
                         *(int((d > f * lr).sum()) for f in (1.5, 2.0, 2.5))))
    rows.sort(reverse=True)
    print(json.dumps({"tf32": tf32 == "1", "losses": losses, "one_process_losses": ref["losses"],
                      "worst": rows[:15], "past_2lr": sum(x[4] for x in rows),
                      "past_2_5lr": sum(x[5] for x in rows)}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        return rank(sys.argv[2])
    from tango_tpu_torch import configs as C
    from tango_tpu_torch.ops import _build
    from tango_tpu_torch.parallel.launch import check, launch
    from tango_tpu_torch.pipeline import Tango
    from tango_tpu_torch.train.sft import SFTTrainer

    print(cs.nvidia_smi(), flush=True)
    _build.load()
    os.makedirs(WORK, exist_ok=True)
    job = {"target_length": cs.MESH_TARGET_LENGTH, "unet_config": C.TANGO_UNET,
           "vae_config": C.TANGO_VAE, "scheduler_config": C.SD21_SCHEDULER,
           "train_config": C.TrainConfig(gradient_accumulation_steps=1,
                                         max_train_steps=cs.MESH_DP_UPDATES)}
    torch.save(job, os.path.join(WORK, "job.pt"))
    tango = Tango.from_components(unet_config=C.TANGO_UNET, vae_config=C.TANGO_VAE,
                                  t5_config=C.FLAN_T5_LARGE, hifigan_config=C.TANGO_HIFIGAN,
                                  scheduler_config=C.SD21_SCHEDULER, device="cuda", init_seed=0)
    batches = cs.mesh_batches(job, tango, WORK)
    torch.save(batches, os.path.join(WORK, "dp_batches.pt"))
    del tango
    torch.cuda.empty_cache()
    for tf32 in ("1", "0"):
        set_tf32(tf32 == "1")
        diffusion, vae, cfg = cs.mesh_sft_setup(job, "cuda")
        trainer = SFTTrainer(diffusion, vae, cfg, total_steps=cs.MESH_DP_UPDATES)
        state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(1)
        losses = []
        for b in batches:
            state, loss = trainer.train_step(state, {k: v.to("cuda") for k, v in b.items()}, gen)
            losses.append(float(loss))
        ref = {k: v.cpu() for k, v in trainer.state_dict(state).items()}
        torch.save({**ref, "losses": losses}, os.path.join(WORK, f"ref{tf32}.pt"))
        del trainer, state, diffusion, vae, ref
        torch.cuda.empty_cache()
        results = launch([sys.executable, os.path.abspath(__file__), "--rank", tf32], 2, 400)
        check(results, "mesh_tf32_probe")
        print(results[0].stdout, end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
