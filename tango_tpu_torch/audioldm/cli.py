"""AudioLDM's CLI, port of tango_tpu/audioldm/cli.py (the reference's
audioldm/__main__.py): the same flags, choices, defaults and file names.

    python -m tango_tpu_torch.audioldm -t "a dog barks" --ckpt_path audioldm-s-full.ckpt
    python -m tango_tpu_torch.audioldm --mode transfer -f src.wav -t "..." --ckpt_path X.ckpt
    python -m tango_tpu_torch.audioldm --mode inpainting -f src.wav -t "..." --ckpt_path X.ckpt
    python -m tango_tpu_torch.audioldm -tl prompts.txt --ckpt_path X.ckpt --device cpu

Without --ckpt_path, --model_name resolves through `registry.resolve`. Each
prompt i writes `{i}_{prompt[:60]}_{j}.wav` (16 kHz int16) under
--save_path. Runs on CUDA unless --device names another; `main(argv,
tokenizer=None)` takes the RoBERTa tokenizer for the checkpoint's CLAP
(without one the hash-embedding stub conditions, with a warning).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tango_tpu_torch AudioLDM CLI")
    p.add_argument("--mode", type=str, default="generation",
                   choices=["generation", "transfer", "inpainting"])
    p.add_argument("-t", "--text", type=str, default="")
    p.add_argument("-tl", "--text_list", type=str, default="")
    p.add_argument("-f", "--file_path", type=str, default=None)
    p.add_argument("--transfer_strength", type=float, default=0.5)
    p.add_argument("-ckpt", "--ckpt_path", type=str, default=None,
                   help="monolithic audioldm ckpt; when absent --model_name resolves "
                        "through the registry (download + cache)")
    p.add_argument("--model_name", type=str, default="audioldm-s-full",
                   choices=["audioldm-s-full", "audioldm-l-full", "audioldm-s-full-v2",
                            "audioldm-m-full"],
                   help="registry model used when no --ckpt_path is given")
    p.add_argument("-s", "--save_path", type=str, default="./output")
    p.add_argument("-dur", "--duration", type=float, default=10.0)
    p.add_argument("-gs", "--guidance_scale", type=float, default=2.5)
    p.add_argument("-n", "--n_candidate_gen_per_text", type=int, default=3)
    p.add_argument("--ddim_steps", type=int, default=200)
    p.add_argument("-b", "--batchsize", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default=None,
                   help="the port's own: cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None, tokenizer=None):
    args = parse_args(argv)
    from tango_tpu_torch.audio.wav import write_wav
    from tango_tpu_torch.audioldm.pipeline import (
        build_model,
        style_transfer,
        super_resolution_and_inpainting,
        text_to_audio,
    )

    if args.mode in ("transfer", "inpainting") and not args.file_path:
        raise SystemExit(f"--mode {args.mode} requires a source audio file (-f/--file_path)")
    os.makedirs(args.save_path, exist_ok=True)
    ckpt_path = args.ckpt_path
    if ckpt_path is None:
        from tango_tpu_torch import registry

        ckpt_path = registry.resolve(args.model_name)
    pipeline = build_model(ckpt_path, tokenizer=tokenizer, device=args.device)

    if args.text_list:
        with open(args.text_list) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    elif args.text:
        prompts = [args.text]
    else:
        raise SystemExit("provide -t or -tl")

    for i, text in enumerate(prompts):
        if args.mode == "inpainting":
            wavs = super_resolution_and_inpainting(
                pipeline, text, args.file_path, seed=args.seed, ddim_steps=args.ddim_steps,
                duration=args.duration, batchsize=args.batchsize,
                guidance_scale=args.guidance_scale)
        elif args.mode == "generation":
            wavs = text_to_audio(
                pipeline, text, original_audio_file_path=args.file_path, seed=args.seed,
                ddim_steps=args.ddim_steps, duration=args.duration, batchsize=args.batchsize,
                guidance_scale=args.guidance_scale,
                n_candidate_gen_per_text=args.n_candidate_gen_per_text)
        else:
            wavs = style_transfer(
                pipeline, text, args.file_path, args.transfer_strength, seed=args.seed,
                duration=args.duration, batchsize=args.batchsize,
                guidance_scale=args.guidance_scale, ddim_steps=args.ddim_steps)
        # the prompt's index keeps names unique; path separators and other
        # characters no file name should hold become "_"
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in text.replace(" ", "_"))
        name = f"{i}_" + (safe[:60] or "sample")
        for j, w in enumerate(wavs):
            write_wav(os.path.join(args.save_path, f"{name}_{j}.wav"), w, 16000)
        print(f"[{i}] wrote {len(wavs)} wav(s) for: {text}")


if __name__ == "__main__":
    main()
