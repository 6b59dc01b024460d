"""Batch generation from a manifest, port of tango_tpu/inference.py.

    python -m tango_tpu_torch.inference --model <snapshot_dir> \
        --test_file data/test_audiocaps_subset.json \
        --num_steps 200 --guidance 3 --batch_size 8 [--num_samples 1] [--device cpu]

Writes `output_{i}.wav` for manifest line i (the first sample of each prompt
with --num_samples > 1) under --output_dir, and appends one record (prompts,
steps, generation seconds, `x_realtime`: seconds of audio a wall second) to
`summary.jsonl` in the working directory. Runs on the card unless --device
names another. The objective evaluation (--reference_dir, --cnn14_ckpt,
--vggish_ckpt) and the CLAP re-ranking (--clap_ckpt) are not ported yet
and raise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# flag -> the ROADMAP queue A item that ports what it needs
NOT_PORTED = {
    "reference_dir": "the objective evaluation, ROADMAP queue A #9",
    "cnn14_ckpt": "the objective evaluation, ROADMAP queue A #9",
    "vggish_ckpt": "the objective evaluation, ROADMAP queue A #9",
    "clap_ckpt": "CLAP re-ranking, ROADMAP queue A #6",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tango_tpu_torch batch generation")
    p.add_argument("--model", type=str, required=True, help="snapshot directory")
    p.add_argument("--test_file", type=str, required=True)
    p.add_argument("--text_key", type=str, default="captions")
    p.add_argument("--reference_dir", "--test_references", dest="reference_dir",
                   type=str, default=None,
                   help="ground-truth wav dir for the evaluation (not ported yet)")
    p.add_argument("--unet_ckpt", type=str, default=None,
                   help="natively trained UNet checkpoint directory (SFTTrainer.fit's "
                        "best / epoch_N) run over --model's VAE, T5 and vocoder")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--num_steps", type=int, default=200)
    p.add_argument("--guidance", type=float, default=3.0)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_test_instances", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cnn14_ckpt", type=str, default=None, help="(not ported yet)")
    p.add_argument("--vggish_ckpt", type=str, default=None, help="(not ported yet)")
    p.add_argument("--clap_ckpt", type=str, default=None, help="(not ported yet)")
    p.add_argument("--with_tracking", action="store_true",
                   help="log the record to wandb if it is importable, else to stdout")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card unless given (e.g. cpu)")
    return p.parse_args(argv)


def init_tracker(enabled: bool):
    """wandb.init with the reference's project name, or None when disabled
    or unavailable; summary.jsonl is written either way."""
    if not enabled:
        return None
    try:
        import wandb

        return wandb.init(project="Text to Audio Diffusion Evaluation")
    except Exception as e:  # wandb absent or its offline init failed
        print(f"# wandb unavailable ({e}); falling back to stdout", flush=True)
        return None


def load_prompts(args) -> list:
    """The manifest's captions under --text_key, the first
    --num_test_instances of them when that is positive."""
    from tango_tpu_torch.train.data import load_manifest

    prompts = [e.caption for e in load_manifest(args.test_file, text_column=args.text_key)]
    if args.num_test_instances > 0:
        prompts = prompts[: args.num_test_instances]
    return prompts


def main(argv=None):
    args = parse_args(argv)
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag} needs {what}, which the port does not have yet")

    from tango_tpu_torch.audio.wav import write_wav
    from tango_tpu_torch.pipeline import Tango

    exp_id = str(int(time.time()))
    out_dir = args.output_dir or os.path.join(
        "outputs", f"{exp_id}_steps_{args.num_steps}_guidance_{args.guidance}")
    os.makedirs(out_dir, exist_ok=True)
    prompts = load_prompts(args)

    tango = Tango(args.model, unet_ckpt=args.unet_ckpt, device=args.device)
    t0 = time.time()
    waves = tango.generate_for_batch(prompts, steps=args.num_steps, guidance=args.guidance,
                                     samples=args.num_samples, batch_size=args.batch_size,
                                     seed=args.seed)
    gen_time = time.time() - t0
    for i, w in enumerate(waves):
        write_wav(os.path.join(out_dir, f"output_{i}.wav"), w[0] if args.num_samples > 1 else w,
                  16000)

    # gen_time covers num_samples generations a prompt: count them all
    audio_sec = len(prompts) * max(args.num_samples, 1) * 10.24
    record = {
        "exp_id": exp_id,
        "model": args.model,
        "num_prompts": len(prompts),
        "num_steps": args.num_steps,
        "guidance": args.guidance,
        "gen_time_s": round(gen_time, 2),
        "x_realtime": round(audio_sec / gen_time, 3),
        "output_dir": out_dir,
    }
    tracker = init_tracker(args.with_tracking)
    if tracker is not None:
        tracker.log({"Steps": args.num_steps, "Guidance Scale": args.guidance,
                     "Test Instances": len(prompts), "x_realtime": record["x_realtime"]})
        tracker.finish()
    with open("summary.jsonl", "a") as f:
        f.write(json.dumps(record) + "\n")
    print(json.dumps(record, indent=2))
    return record


if __name__ == "__main__":
    main()
