#!/usr/bin/env bash
# SFT training on the PyTorch port (train.sh's counterpart — the same flags,
# which tango_tpu_torch/train/cli.py takes as the reference's argparse
# surface). Add --tango_snapshot <snapshot dir> for the VAE and T5 weights.
# Runs on the CUDA card; append --device cpu to run on the CPU.
# Several cards: the trainer builds its mesh from the launcher's variables
# (tango_tpu_torch/parallel/mesh.py `init_distributed`: torchrun's RANK /
# WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT, or JAX's
# JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID), NCCL where every
# rank has a card of its own. Start one process a card yourself, e.g.
# `torchrun --standalone --nproc_per_node 4 -m tango_tpu_torch.train.cli
# <these flags> --model_parallel 2` (a 2 x 2 data x model mesh); from Python,
# tango_tpu_torch/parallel/launch.py `launch(cmd, world, timeout)` starts the
# ranks with a free port.
python -m tango_tpu_torch.train.cli \
  --train_file="data/train_audiocaps.json" \
  --validation_file="data/valid_audiocaps.json" \
  --test_file="data/test_audiocaps_subset.json" \
  --unet_model_config="configs/diffusion_model_config.json" \
  --freeze_text_encoder \
  --gradient_accumulation_steps 4 \
  --per_device_train_batch_size=2 --per_device_eval_batch_size=2 \
  --augment --learning_rate=3e-5 --num_train_epochs 40 --snr_gamma 5 \
  --text_column captions --audio_column location \
  --checkpointing_steps="best" "$@"
