"""SFT training CLI, port of tango_tpu/train/cli.py:

    python -m tango_tpu_torch.train.cli --train_file train.json \
        --validation_file val.json --tango_snapshot <snapshot_dir> [--device cpu]

The flags are JAX's, with its defaults (the reference's train.py:33-198,
train.sh's recipe), plus `--device`. The VAE (with its encoder), the T5
encoder and the STFT come from `--tango_snapshot`; without it, from
`--audioldm_ckpt`, a monolithic audioldm-*-full `.ckpt`, the VAE (TANGO_VAE
with the checkpoint's scale_factor, as JAX builds it) alone, with the
default STFT: that file carries no text encoder, so the T5 encoder must then
come from `--hf_model`'s main bin, and without one the CLI exits, as it does
for a snapshot without an encoder. `--hf_model`, a snapshot
directory, starts the UNet (and the T5, and the UNet config where it ships
one) from its main bin, as the tango-full-ft recipe does; otherwise the UNet
starts from seeded random weights. `--resume_from_checkpoint` restores the
UNet from a native checkpoint, and the optimizer's moments and schedule
restart. Training is f32 with remat on the card unless `--device` names
another. Checkpoints and `summary.jsonl` (the args record first, then one
record an epoch) go to `--output_dir`.

Nothing is downloaded: a name that is not a local directory raises. The
tokenizer is the caller's (`main(argv, tokenizer=)`) or `WordHashTokenizer`,
with a warning.

Several processes: launch one per device with torchrun (`torchrun
--nproc_per_node N -m tango_tpu_torch.train.cli ...`) or with JAX's
variables (JAX_COORDINATOR=host:port, JAX_NUM_PROCESSES, JAX_PROCESS_ID on
each), as JAX's CLI is launched. The ranks form a ('data', 'model') mesh
with `--model_parallel` ranks a model group (parallel.mesh): the global
batch is `--per_device_train_batch_size` times the data ranks, each data
rank decodes only its rows of it (`FeaturizedLoader(local_rows=)`), mixup
adds half a rank's rows to that rank, and only rank 0 writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import warnings

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tango_tpu_torch SFT training")
    p.add_argument("--train_file", type=str, required=True)
    p.add_argument("--validation_file", type=str, required=True)
    p.add_argument("--data_prefix", type=str, default="")
    p.add_argument("--test_file", type=str, default=None,
                   help="held-out manifest, recorded in summary.jsonl")
    p.add_argument("--freeze_text_encoder", action="store_true",
                   help="accepted for the reference's scripts; the T5 encoder is always frozen")
    p.add_argument("--text_column", type=str, default="captions")
    p.add_argument("--audio_column", type=str, default="location")
    p.add_argument("--tango_snapshot", type=str, default=None,
                   help="reference-format snapshot directory for the VAE and T5 weights")
    p.add_argument("--hf_model", type=str, default=None,
                   help="snapshot directory whose pytorch_model_main.bin starts the UNet "
                        "(and T5) to continue training (reference train.py:68,311-314)")
    p.add_argument("--prefix", type=str, default=None,
                   help="text prefixed to every caption (reference train.py:97-98)")
    p.add_argument("--num_examples", type=int, default=-1,
                   help="keep the first N rows of the train and validation manifests")
    p.add_argument("--save_every", type=int, default=5,
                   help="with --checkpointing_steps best, also save epoch_N every N epochs")
    p.add_argument("--audioldm_ckpt", type=str, default=None,
                   help="monolithic AudioLDM checkpoint for the VAE, without --tango_snapshot")
    p.add_argument("--text_encoder_name", type=str, default="google/flan-t5-large")
    p.add_argument("--scheduler_name", type=str, default="stabilityai/stable-diffusion-2-1")
    p.add_argument("--unet_model_config", type=str, default=None)
    p.add_argument("--snr_gamma", type=float, default=5.0)
    p.add_argument("--uncondition", action="store_true")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--decode_workers", type=int, default=0,
                   help="decode the manifest's audio in N spawned processes (0: in the "
                        "loader's thread)")
    p.add_argument("--per_device_train_batch_size", type=int, default=2)
    p.add_argument("--per_device_eval_batch_size", type=int, default=2)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--weight_decay", type=float, default=1e-8,
                   help="accepted and unused, as in the reference (train.py:113); "
                        "--adam_weight_decay is the decay applied")
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--num_train_epochs", type=int, default=40)
    p.add_argument("--max_train_steps", type=int, default=None,
                   help="cap on optimizer updates; also the schedule's length")
    p.add_argument("--num_warmup_steps", type=int, default=0)
    p.add_argument("--lr_scheduler_type", type=str, default="linear",
                   help="linear | cosine | constant | constant_with_warmup")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--checkpointing_steps", type=str, default="best",
                   help='"best" (validation-gated), "epoch", or an integer N (every N batches)')
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--target_length", type=int, default=1024)
    p.add_argument("--max_text_length", type=int, default=128)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks a model group: the UNet's tensor-parallel width")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with_tracking", action="store_true",
                   help="log to wandb if it is importable, else to stdout")
    p.add_argument("--skip_preflight", action="store_true",
                   help="skip the manifest's audio-format preflight")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card unless given (e.g. cpu)")
    return p.parse_args(argv)


def local_dir(path: str, flag: str) -> str:
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{flag} {path!r} is not a directory. The port downloads nothing: pass a local "
            "reference-format snapshot directory")
    return path


def default_tokenizer(tokenizer, vocab_size: int):
    """The caller's tokenizer, or WordHashTokenizer with a warning."""
    if tokenizer is not None:
        return tokenizer
    from tango_tpu_torch.tokenizer import WordHashTokenizer

    warnings.warn(
        "no tokenizer given: captions go through WordHashTokenizer, not FLAN-T5's "
        "SentencePiece tokenizer (the port does not use transformers); pass tokenizer= to "
        "main() to use the real one", UserWarning, stacklevel=3)
    return WordHashTokenizer(vocab_size)


def make_log_fn(enabled: bool, project: str, config: dict, is_main: bool = True):
    """A log function printing each record as a JSON line, and logging it to
    wandb too when `enabled` and wandb is importable; silent off rank 0."""
    tracker = None
    if not is_main:
        return lambda rec: None
    if enabled:
        try:
            import wandb

            tracker = wandb.init(project=project, config=config)
        except Exception as e:  # wandb absent or its offline init failed
            print(f"# wandb unavailable ({e}); falling back to stdout", flush=True)

    def log_fn(rec):
        print(json.dumps(rec), flush=True)
        if tracker is not None:
            tracker.log(rec)

    return log_fn


def main(argv=None, tokenizer=None):
    args = parse_args(argv)
    import torch

    from tango_tpu_torch import configs as C
    from tango_tpu_torch.audio.stft import MelSpectrogram
    from tango_tpu_torch.models.diffusion import AudioDiffusion
    from tango_tpu_torch.models.layers import frozen
    from tango_tpu_torch.models.t5 import T5Encoder
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.parallel import mesh as pmesh
    from tango_tpu_torch.train.data import FeaturizedLoader, load_manifest, validate_manifest
    from tango_tpu_torch.train.sft import SFTTrainer, encode_batches
    from tango_tpu_torch.utils import checkpoint as ckpt_io

    _, _, device = pmesh.init_distributed(args.device)
    mesh = pmesh.make_mesh(data=-1, model=args.model_parallel, device=device)
    out_dir = args.output_dir or os.path.join("saved", str(int(time.time())))
    if mesh.is_main:
        os.makedirs(out_dir, exist_ok=True)

    # --- components
    unet_config = C.TANGO_UNET
    if args.unet_model_config:
        with open(args.unet_model_config) as f:
            unet_config = C.UNetConfig.from_dict(json.load(f))
    if args.tango_snapshot:
        loaded = ckpt_io.load_tango_snapshot(local_dir(args.tango_snapshot, "--tango_snapshot"),
                                             with_encoder=True)
        vae_config, stft_config = loaded["vae_config"], loaded["stft_config"]
        t5_params, t5_config = loaded["t5_params"], loaded["t5_config"]
        vae_params = loaded["vae_params"]
        del loaded  # the snapshot's UNet is not trained on: --hf_model's is
    elif args.audioldm_ckpt:
        vae_params, _, scale = ckpt_io.load_audioldm_ckpt(args.audioldm_ckpt)
        vae_config = dataclasses.replace(C.TANGO_VAE, scale_factor=scale)
        stft_config, t5_params, t5_config = C.TANGO_STFT, None, None
    else:
        raise SystemExit("need --tango_snapshot (or --audioldm_ckpt) for the VAE weights")

    init_unet_params = None
    if args.hf_model:
        hf_path = local_dir(args.hf_model, "--hf_model")
        main_loaded = ckpt_io.load_main_weights(hf_path)
        init_unet_params = main_loaded["unet_params"]
        if main_loaded["t5_params"] is not None:
            t5_params, t5_config = main_loaded["t5_params"], main_loaded["t5_config"]
        if main_loaded["unet_config"] is not None and not args.unet_model_config:
            unet_config = main_loaded["unet_config"]
            print(f"# unet_config from {hf_path}/unet_config.json", flush=True)
        del main_loaded
        print(f"# continuing training from {hf_path} (main bin)", flush=True)
    if t5_params is None:
        raise SystemExit(
            f"no text-encoder weights in the given checkpoints, and the port downloads "
            f"nothing (the reference loads {args.text_encoder_name} from the hub): use a "
            "--tango_snapshot or --hf_model whose main bin holds the encoder")
    vae = frozen(lambda: AutoencoderKL(vae_config, with_encoder=True), vae_params, device)
    t5_config = t5_config or C.FLAN_T5_LARGE
    t5 = frozen(lambda: T5Encoder(t5_config), t5_params, device)
    del t5_params, vae_params
    tokenizer = default_tokenizer(tokenizer, t5_config.vocab_size)

    train_cfg = C.TrainConfig(
        learning_rate=args.learning_rate,
        # --weight_decay is accepted and unused, as in the reference
        weight_decay=args.adam_weight_decay,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2, adam_epsilon=args.adam_epsilon,
        num_train_epochs=args.num_train_epochs,
        per_device_train_batch_size=args.per_device_train_batch_size,
        per_device_eval_batch_size=args.per_device_eval_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        num_warmup_steps=args.num_warmup_steps, lr_scheduler_type=args.lr_scheduler_type,
        snr_gamma=args.snr_gamma, uncondition=args.uncondition, augment=args.augment,
        target_length=args.target_length, checkpointing_steps=args.checkpointing_steps,
        max_train_steps=args.max_train_steps, save_every=args.save_every)

    # --- data
    text_prefix = args.prefix or ""
    train_ex = load_manifest(args.train_file, args.data_prefix, args.text_column,
                             args.audio_column, text_prefix=text_prefix)
    val_ex = load_manifest(args.validation_file, args.data_prefix, args.text_column,
                           args.audio_column, text_prefix=text_prefix)
    if args.num_examples != -1:
        train_ex, val_ex = train_ex[: args.num_examples], val_ex[: args.num_examples]
    if not args.skip_preflight:
        validate_manifest(train_ex)
        validate_manifest(val_ex)
    # the global batches; each data rank decodes its rows of them (JAX's
    # cli.py:234-262), and mixup adds half its rows to each rank's share
    data_size = mesh.shape["data"]
    bs = args.per_device_train_batch_size * data_size
    eval_bs = args.per_device_eval_batch_size * data_size
    train_rows = eval_rows = None
    if mesh.size > 1:
        train_rows = pmesh.process_local_batch_slice(mesh, bs)
        eval_rows = pmesh.process_local_batch_slice(mesh, eval_bs)
    local_bs = bs if train_rows is None else train_rows.stop - train_rows.start
    stft = MelSpectrogram(stft_config)
    train_loader = FeaturizedLoader(train_ex, bs, args.target_length, stft=stft,
                                    augment_num=local_bs // 2 if args.augment else 0,
                                    seed=args.seed, local_rows=train_rows,
                                    decode_workers=args.decode_workers)
    val_loader = FeaturizedLoader(val_ex, eval_bs, args.target_length, stft=stft, shuffle=False,
                                  local_rows=eval_rows, decode_workers=args.decode_workers)
    steps_per_epoch = max(len(train_loader) // args.gradient_accumulation_steps, 1)
    total_steps = steps_per_epoch * args.num_train_epochs
    if args.max_train_steps is not None:
        total_steps = min(total_steps, args.max_train_steps)

    # f32 with remat: full-size training does not fit otherwise
    diffusion = AudioDiffusion(unet_config, snr_gamma=args.snr_gamma,
                               uncondition=args.uncondition, remat=True, device=device)
    trainer = SFTTrainer(diffusion, vae, train_cfg, total_steps, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.resume_from_checkpoint:
        params, manifest = ckpt_io.load_native(args.resume_from_checkpoint)
        state = trainer.init_state(params=params)
        del params
        print(f"# resume: params restored from {args.resume_from_checkpoint} (epoch "
              f"{(manifest or {}).get('epoch')}); the optimizer's moments and the schedule "
              "restart: native checkpoints hold params only", flush=True)
    else:
        state = trainer.init_state(generator, params=init_unet_params)
    del init_unet_params

    if mesh.is_main:
        with open(os.path.join(out_dir, "summary.jsonl"), "a") as f:
            f.write(json.dumps({"args": vars(args)}) + "\n")
    log_fn = make_log_fn(args.with_tracking, "tango_tpu", vars(args), mesh.is_main)
    try:
        return trainer.fit(
            state, encode_batches(train_loader, tokenizer, t5, args.max_text_length),
            encode_batches(val_loader, tokenizer, t5, args.max_text_length), generator,
            out_dir, log_fn=log_fn)
    finally:
        train_loader.close()
        val_loader.close()


if __name__ == "__main__":
    main()
