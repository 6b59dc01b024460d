"""A DP x TP and a DP x SP SFT step on n ranks against the meshless step:
the port's counterpart of JAX's `__graft_entry__.dryrun_multichip`.

    python -m tango_tpu_torch.parallel.dryrun --n 4 [--device cpu]

starts n ranks (parallel.launch) on a ('data', 'model') mesh, model 2 where
n is an even 4 or more (2 x 2 at n = 4), else 1. Each rank builds the same
seeded tiny UNet (JAX's dryrun config: three levels, heads 2, 4, 4) and VAE,
takes its rows of a constant batch of one row a data rank, and takes one
SFTTrainer step with the UNet sharded by the TP rules; where model > 1, a
second trainer takes the same step sequence-parallel (the latent time axis,
16 frames, split over 'model' by `latent_sharder=partial(shard_latents_seq,
mesh=mesh)`, the parameters replicated). Rank 0 also takes the meshless
step at the global batch and holds both mesh steps to it at JAX's bounds:
the loss within 2e-5 of it (relative), every updated parameter within 1e-4;
on the card TF32 is off, as JAX's f32 bounds assume.
Every rank prints its kernel launches ({"dryrun_rank": ...}) and rank 0 the
record ({"dryrun": {...}}: `loss`, `param_max_drift` and, for the SP step,
`sp_loss`, `sp_loss_rel_err`, `sp_param_max_drift`, `sp_collectives`);
`dryrun_multichip(n)` launches the ranks and returns that record with every
rank's launches.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

LOSS_RTOL = 2e-5
PARAM_ATOL = 1e-4


def _config():
    from tango_tpu_torch import configs as C

    unet = C.UNetConfig(
        in_channels=8, out_channels=8,
        down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
        block_out_channels=(32, 64, 64), layers_per_block=2, cross_attention_dim=32,
        attention_head_dim=(2, 4, 4), norm_num_groups=8)
    vae = C.VAEConfig(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2), num_res_blocks=1)
    return unet, vae


def model_axis(n: int) -> int:
    return 2 if n >= 4 and n % 2 == 0 else 1


def _trainer(device, mesh, seq: bool = False):
    """The step's trainer; `seq`: its UNet sequence-parallel over the mesh."""
    import functools

    from tango_tpu_torch.configs import TrainConfig
    from tango_tpu_torch.models.diffusion import AudioDiffusion
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.parallel.mesh import shard_latents_seq
    from tango_tpu_torch.train.sft import SFTTrainer
    from tango_tpu_torch.utils.init import init_random_

    unet_cfg, vae_cfg = _config()
    sharder = functools.partial(shard_latents_seq, mesh=mesh) if seq else None
    diffusion = AudioDiffusion(unet_cfg, latent_t_size=16, latent_f_size=4, snr_gamma=5.0,
                               latent_sharder=sharder, device=device)
    vae = init_random_(AutoencoderKL(vae_cfg, with_encoder=True),
                       torch.Generator().manual_seed(0)).to(device).eval()
    return SFTTrainer(diffusion, vae, TrainConfig(gradient_accumulation_steps=1),
                      total_steps=10, mesh=mesh)


def rank_main(device=None) -> tuple:
    """One rank's step -> (its kernel launches, rank 0's record or {})."""
    from tango_tpu_torch import ops
    from tango_tpu_torch.parallel import mesh as pmesh

    _, world, dev = pmesh.init_distributed(device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ops.reset_counters()
    mesh = pmesh.make_mesh(data=-1, model=model_axis(world), device=dev)
    b = mesh.shape["data"]
    batch = {"fbank": torch.ones((b, 32, 8), device=dev) * 0.1,
             "text_embeds": torch.ones((b, 6, 32), device=dev) * 0.02,
             "text_mask": torch.ones((b, 6), dtype=torch.long, device=dev)}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def step(seq):
        trainer = _trainer(dev, mesh, seq)
        state = trainer.init_state(gen(0))
        state, loss = trainer.train_step(state, pmesh.shard_batch(batch, mesh), gen(1))
        return float(loss), trainer.state_dict(state)

    steps = {"": step(False)}
    if mesh.shape["model"] > 1:
        steps["sp_"] = step(True)
    launches = {n: fn.launches for n, fn in ops.all_kernels().items()}
    if not mesh.is_main:
        return launches, {}
    ref = _trainer(dev, None)
    ref_state = ref.init_state(gen(0))
    ref_state, ref_loss = ref.train_step(ref_state, batch, gen(1))
    ref_loss = float(ref_loss)
    rec = {"mesh": mesh.shape, "backend": mesh.backend, "meshless_loss": ref_loss,
           "loss_rtol": LOSS_RTOL, "param_atol": PARAM_ATOL, "ok": True}
    for tag, (loss, params) in steps.items():
        drift = max(float((params[k].float() - v.float()).abs().max())
                    for k, v in ref_state.params.state_dict().items())
        rec.update({f"{tag}loss": loss,
                    f"{tag}loss_rel_err": abs(loss - ref_loss) / max(abs(ref_loss), 1e-3),
                    f"{tag}param_max_drift": drift})
        rec["ok"] &= rec[f"{tag}loss_rel_err"] <= LOSS_RTOL and drift <= PARAM_ATOL
    if "sp_" in steps:  # one SP training step's exchanges by kind, this rank's
        rec["sp_collectives"] = {k: v for k, v in mesh.seq_stats.items() if "_bytes" not in k}
    return launches, rec


def dryrun_multichip(n: int, device=None, timeout: float = 600.0) -> dict:
    """Launch the n-rank dry run (each rank on `device`, the card by
    default); returns rank 0's record and raises unless it is within bounds."""
    from tango_tpu_torch.parallel.launch import check, launch

    cmd = [sys.executable, "-m", "tango_tpu_torch.parallel.dryrun"]
    if device is not None:
        cmd += ["--device", str(device)]
    results = launch(cmd, n, timeout)
    check(results, "dryrun_multichip")
    lines = [json.loads(line) for r in results for line in r.stdout.splitlines()
             if line.startswith('{"dryrun')]
    rec = next(line["dryrun"] for line in lines if "dryrun" in line)
    rec["launches_per_rank"] = [{n: c for n, c in line["dryrun_rank"].items() if c}
                                for line in lines if "dryrun_rank" in line]
    if not rec["ok"]:
        raise AssertionError(f"dryrun_multichip({n}) out of bounds: {rec}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None,
                    help="launch this many ranks (without it: run as one rank of a launch)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.n is not None:
        print(json.dumps({"dryrun": dryrun_multichip(args.n, args.device)}), flush=True)
        return 0
    launches, rec = rank_main(args.device)
    print(json.dumps({"dryrun_rank": launches}), flush=True)
    if rec:
        print(json.dumps({"dryrun": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
