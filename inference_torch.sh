#!/usr/bin/env bash
# Batch generation + objective eval on the PyTorch port (inference.sh's
# counterpart, the same flags; tango_tpu_torch/inference.py). MODEL is a
# reference-format snapshot directory: the port downloads nothing. Runs on
# the CUDA card; append --device cpu to run on the CPU.
python -m tango_tpu_torch.inference \
  --model "${MODEL:-declare-lab/tango}" \
  --test_file "data/test_audiocaps_subset.json" \
  --num_steps 200 --guidance 3 --num_samples 1 "$@"
