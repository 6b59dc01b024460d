"""DPO training CLI (Tango 2), port of tango_tpu/train/dpo_cli.py:

    python -m tango_tpu_torch.train.dpo_cli --train_file prefs.json \
        --tango_snapshot <snapshot_dir> [--validation_file val.json] [--device cpu]

The preference manifest is JSON lines of {"captions", "chosen", "rejected"}
(WAV paths; the reference writes audio-alpaca's rows to files first,
tango2-train.py:344-349). The flags are JAX's, with the recipe's defaults
(README.md:155-166: lr 9.6e-7, beta 2000, 5 epochs, 1 SFT-first epoch, batch
4 x accumulation 4), plus `--device`. The trained UNet and the frozen
reference UNet both start from the snapshot's UNet; the VAE comes with its
encoder. f32 with remat on the card unless `--device` names another;
checkpoints (`best` with a validation file, `epoch_N`, `last`) and
`summary.jsonl` go to `--output_dir`. The tokenizer is the caller's
(`main(argv, tokenizer=)`) or `WordHashTokenizer`, with a warning; nothing
is downloaded.

Several processes (torchrun, or JAX's JAX_COORDINATOR variables, as
`train.cli`): the ranks form a ('data', 'model') mesh with
`--model_parallel` ranks a model group; every rank iterates the same seeded
batch order of `--per_device_train_batch_size` times the data ranks rows
and featurizes only its rows (JAX's dpo_cli.py:118-125); the trained UNet
is sharded over 'model', the reference UNet kept whole on every rank in
bf16, as JAX's CLI keeps it; only rank 0 writes.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tango_tpu_torch DPO training")
    p.add_argument("--train_file", type=str, required=True,
                   help="JSON lines: {captions, chosen, rejected}")
    p.add_argument("--validation_file", type=str, default=None,
                   help="JSON lines (captions and chosen audio): the fixed-t validation loss "
                        "and the best checkpoint")
    p.add_argument("--tango_snapshot", type=str, required=True,
                   help="the starting SFT checkpoint, a reference-format snapshot directory")
    p.add_argument("--learning_rate", type=float, default=9.6e-7)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2,
                   help="the AdamW decay applied (the reference's --weight_decay is unused)")
    p.add_argument("--beta_dpo", type=float, default=2000.0)
    p.add_argument("--num_train_epochs", type=int, default=5)
    p.add_argument("--max_train_steps", type=int, default=None,
                   help="cap on optimizer updates")
    p.add_argument("--save_every", type=int, default=5,
                   help="post-SFT epoch states saved every N epochs")
    p.add_argument("--prefix", type=str, default=None, help="text prefixed to every caption")
    p.add_argument("--num_examples", type=int, default=-1,
                   help="keep the first N rows of the preference manifest")
    p.add_argument("--sft_first_epochs", type=int, default=1)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--target_length", type=int, default=1024)
    p.add_argument("--max_text_length", type=int, default=128)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks a model group: the UNet's tensor-parallel width")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with_tracking", action="store_true",
                   help="log to wandb if it is importable, else to stdout")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card unless given (e.g. cpu)")
    return p.parse_args(argv)


def load_preference_manifest(path: str):
    """JSON lines of {captions, chosen, rejected} -> a list of dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None, tokenizer=None):
    args = parse_args(argv)
    from tango_tpu_torch.train.cli import default_tokenizer, local_dir, make_log_fn

    import numpy as np
    import torch

    from tango_tpu_torch import configs as C
    from tango_tpu_torch.audio.stft import MelSpectrogram, wav_batch_to_fbank
    from tango_tpu_torch.audio.wav import read_wav_file
    from tango_tpu_torch.models.dpo import DPOAudioDiffusion, make_reference
    from tango_tpu_torch.models.layers import frozen
    from tango_tpu_torch.models.t5 import T5Encoder
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.parallel import mesh as pmesh
    from tango_tpu_torch.train.data import Example, validate_manifest
    from tango_tpu_torch.train.dpo import DPOTrainer
    from tango_tpu_torch.utils.checkpoint import load_tango_snapshot

    _, _, device = pmesh.init_distributed(args.device)
    mesh = pmesh.make_mesh(data=-1, model=args.model_parallel, device=device)
    out_dir = args.output_dir or os.path.join("saved", f"dpo_{int(time.time())}")
    if mesh.is_main:
        os.makedirs(out_dir, exist_ok=True)

    loaded = load_tango_snapshot(local_dir(args.tango_snapshot, "--tango_snapshot"),
                                 with_encoder=True)
    if loaded["t5_params"] is None:
        raise SystemExit("no text-encoder weights in --tango_snapshot's main bin, and the port "
                         "downloads nothing")
    vae = frozen(lambda: AutoencoderKL(loaded["vae_config"], with_encoder=True),
                 loaded["vae_params"], device)
    t5_config = loaded["t5_config"] or C.FLAN_T5_LARGE
    t5 = frozen(lambda: T5Encoder(t5_config), loaded["t5_params"], device)
    tokenizer = default_tokenizer(tokenizer, t5_config.vocab_size)
    stft = MelSpectrogram(loaded["stft_config"])

    cfg = C.DPOConfig(
        learning_rate=args.learning_rate, weight_decay=args.adam_weight_decay,
        beta_dpo=args.beta_dpo, num_train_epochs=args.num_train_epochs,
        sft_first_epochs=args.sft_first_epochs,
        per_device_train_batch_size=args.per_device_train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        max_train_steps=args.max_train_steps, save_every=args.save_every)
    # the global batch, of which each data rank featurizes its rows
    bs = args.per_device_train_batch_size * mesh.shape["data"]
    rows_of = (pmesh.process_local_batch_slice(mesh, bs) if mesh.size > 1 else slice(None))

    rows = load_preference_manifest(args.train_file)
    if args.num_examples != -1:
        rows = rows[: args.num_examples]
    if args.prefix:
        rows = [{**r, "captions": args.prefix + r["captions"]} for r in rows]
    # both preference branches: a manifest of undecodable audio must fail
    # here, not train on the loader's constant stand-in
    validate_manifest([Example(r[k], "") for r in rows for k in ("chosen", "rejected")])
    steps_per_epoch = max(len(rows) // bs // args.gradient_accumulation_steps, 1)

    # f32 with remat; the reference UNet is a frozen copy of the starting UNet
    diffusion = DPOAudioDiffusion(loaded["unet_config"], beta_dpo=args.beta_dpo, remat=True,
                                  device=device)
    trainer = DPOTrainer(diffusion, vae, cfg, total_steps=steps_per_epoch * args.num_train_epochs,
                         mesh=mesh)
    # the reference is taken whole, before init_state shards the UNet; under a
    # mesh it is kept in bf16, as JAX's CLI keeps it (dpo_cli.py:152-159)
    diffusion.unet.load_state_dict(loaded["unet_params"])
    ref_unet = make_reference(diffusion.unet, torch.bfloat16 if mesh.size > 1 else None)
    state = trainer.init_state()
    del loaded

    def fbanks(chunk, key):
        wavs = np.concatenate([read_wav_file(r[key], args.target_length * 160) for r in chunk])
        return wav_batch_to_fbank(stft, wavs, args.target_length)[0].to(device)

    def text(chunk):
        tok = tokenizer([r["captions"] for r in chunk], max_length=args.max_text_length,
                        padding="max_length", truncation=True, return_tensors="np")
        ids = torch.as_tensor(tok["input_ids"], dtype=torch.long, device=device)
        mask = torch.as_tensor(tok["attention_mask"], dtype=torch.long, device=device)
        with torch.no_grad():
            return {"text_embeds": t5(ids, mask), "text_mask": mask}

    epochs_seen = [0]

    def batches():
        # a fresh shuffle each epoch (fit calls this once an epoch): seed + epoch
        order = list(range(len(rows)))
        random.Random(args.seed + epochs_seen[0]).shuffle(order)
        epochs_seen[0] += 1
        for k in range(0, len(order) - bs + 1, bs):
            chunk = [rows[i] for i in order[k: k + bs]][rows_of]
            yield {"fbank_w": fbanks(chunk, "chosen"), "fbank_l": fbanks(chunk, "rejected"),
                   **text(chunk)}

    val_batches = None
    if args.validation_file:
        vrows = load_preference_manifest(args.validation_file)
        if args.prefix:
            vrows = [{**r, "captions": args.prefix + r["captions"]} for r in vrows]

        def val_batches():
            # the tail too, padded by repeating rows: a validation set smaller
            # than a batch still gives a loss
            for k in range(0, len(vrows), bs):
                chunk = vrows[k: k + bs]
                if len(chunk) < bs:
                    chunk = (chunk * bs)[:bs]
                chunk = chunk[rows_of]
                yield {"fbank": fbanks(chunk, "chosen"), **text(chunk)}

    log_fn = make_log_fn(args.with_tracking, "tango_tpu_dpo", vars(args), mesh.is_main)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    return trainer.fit(state, ref_unet, batches, generator, out_dir, val_batches=val_batches,
                       log_fn=log_fn), ref_unet


if __name__ == "__main__":
    main()
