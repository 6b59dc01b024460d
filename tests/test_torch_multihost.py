"""The port's SFT training CLI on two processes, as a user launches it, against
the same CLI in one process (JAX's tests/test_multihost.py for the port).

`python -m tango_tpu_torch.train.cli` on the reference-format tiny snapshot
and 8 synthetic WAVs, 2 epochs of 2 global batches of 4 rows, on the CPU:

  * once in one process (`--per_device_train_batch_size 4`);
  * once with torchrun's variables on two ranks, data parallel (batch 2 a
    rank): each rank decodes only its half of every global batch;
  * once with JAX's variables (JAX_COORDINATOR, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID) on two ranks with `--model_parallel 2`: the UNet's
    heads split over the two, every rank on the whole batch.

Each multi-process run's epoch losses match the single process's at
tests/test_multihost.py:93-98's bounds (rtol 2e-5, atol 2e-6: global means,
equal up to summation order), and the sum of |first parameter| of its last
checkpoint at rtol 2e-3 (Adam's first steps amplify reduction-order noise
on near-zero gradients to about 2 lr). The checkpoint, written by rank 0
after gathering the TP shards, loads into a meshless UNet with the strict
key and shape check, every tensor bit-equal to the file's, and only rank 0
wrote the summary.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tango_tpu_torch import configs as TC
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.parallel.launch import check, launch
from tango_tpu_torch.utils.checkpoint import load_native

from tests.conftest import REPO
from tests.test_torch_train_cli import SNAP, TARGET_LENGTH, UNET_CONFIG, write_manifest

torch.set_num_threads(1)

TIMEOUT_S = 240
ARGS = ["--unet_model_config", UNET_CONFIG, "--target_length", str(TARGET_LENGTH),
        "--device", "cpu", "--gradient_accumulation_steps", "1", "--num_train_epochs", "2",
        "--learning_rate", "1e-3", "--checkpointing_steps", "epoch", "--seed", "3"]


def _argv(root, name, per_device):
    return [sys.executable, "-m", "tango_tpu_torch.train.cli", "--train_file",
            os.path.join(root, "train.json"), "--validation_file", os.path.join(root, "val.json"),
            "--tango_snapshot", SNAP, "--output_dir", os.path.join(root, name),
            "--per_device_train_batch_size", str(per_device), "--per_device_eval_batch_size",
            str(per_device), *ARGS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multihost"))
    write_manifest(root, 8)
    write_manifest(root, 4, seed=1, name="val.json")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    out = {}

    def single():
        out["single"] = subprocess.run(_argv(root, "single", 4), env=env, cwd=str(REPO),
                                       capture_output=True, text=True, timeout=TIMEOUT_S)

    def torchrun():
        out["torchrun"] = launch(_argv(root, "torchrun", 2), 2, TIMEOUT_S, env=env,
                                 cwd=str(REPO))

    def jax_vars():
        out["jax_vars"] = launch(_argv(root, "jax_vars", 4) + ["--model_parallel", "2"], 2,
                                 TIMEOUT_S, env=env, cwd=str(REPO), jax_vars=True)

    threads = [threading.Thread(target=f) for f in (single, torchrun, jax_vars)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out["single"].returncode == 0, out["single"].stderr[-3000:]
    check(out["torchrun"], "torchrun launch")
    check(out["jax_vars"], "JAX_COORDINATOR launch")
    return root, out


def _epochs(path):
    recs = [json.loads(line) for line in open(os.path.join(path, "summary.jsonl"))]
    assert "args" in recs[0]
    return recs[1:]


def _checksum(sd):
    return float(next(iter(sd.values())).abs().sum())


@pytest.mark.parametrize("launcher", ["torchrun", "jax_vars"])
def test_two_process_cli_matches_one_process(runs, launcher):
    root, out = runs
    want = _epochs(os.path.join(root, "single"))
    got = _epochs(os.path.join(root, launcher))
    assert len(got) == len(want) == 2
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want], rtol=2e-5,
                                   atol=2e-6, err_msg=key)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    ckpt, _ = load_native(os.path.join(root, launcher, "epoch_1"))
    ref, _ = load_native(os.path.join(root, "single", "epoch_1"))
    np.testing.assert_allclose(_checksum(ckpt), _checksum(ref), rtol=2e-3)
    # the gathered checkpoint loads meshless, whole and unchanged
    unet = UNet2DConditionModel(TC.UNetConfig.from_dict(json.load(open(UNET_CONFIG))))
    unet.load_state_dict(ckpt)
    assert all(torch.equal(v, ckpt[k]) for k, v in unet.state_dict().items())
    # rank 0 alone logs and writes; the other rank's stdout has no record
    assert '"epoch": 1' in out[launcher][0].stdout
    assert '"epoch"' not in out[launcher][1].stdout
    assert "backend gloo" in out[launcher][0].stderr

