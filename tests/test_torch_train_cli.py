"""The port's SFT training CLI (tango_tpu_torch/train/cli.py) on the CPU:
`parse_args` against JAX's on the same argv; a 2-update run on the
reference-format tiny snapshot and synthetic WAVs (16 fbank frames, so 8
latent frames); `--hf_model`'s UNet against `load_main_weights`;
`--resume_from_checkpoint`; `--audioldm_ckpt`'s VAE against JAX's
`load_audioldm_ckpt` on a full-width checkpoint; each flag that raises; and
`load_tango_snapshot(with_encoder=True)`'s VAE bit-equal to JAX's
`load_tango_snapshot` (which keeps the encoder) through `from_jax_params`."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from tango_tpu.train import cli as jcli
from tango_tpu.utils import checkpoint as jckpt
from tango_tpu_torch.audio.wav import write_wav
from tango_tpu_torch.models.vae import AutoencoderKL
from tango_tpu_torch.tokenizer import WordHashTokenizer
from tango_tpu_torch.train import cli
from tango_tpu_torch.train import sft as tsft
from tango_tpu_torch.utils.checkpoint import (
    load_main_weights,
    load_native,
    load_tango_snapshot,
    save_native,
)
from tango_tpu_torch.utils.convert import from_jax_params

from tests.conftest import GOLDEN

torch.set_num_threads(1)

SNAP = str(GOLDEN / "snapshot_tiny")
TARGET_LENGTH = 16  # fbank frames: the tiny VAE halves them to 8 latent frames
# the tiny UNet's config: without --hf_model the CLI builds TANGO_UNET otherwise
UNET_CONFIG = str(GOLDEN / "snapshot_tiny" / "unet_config.json")


def write_manifest(root, n, seed=0, name="train.json"):
    """`n` seeded synthetic 16 kHz WAVs of TARGET_LENGTH frames and their manifest."""
    rng = np.random.default_rng(seed)
    t = np.arange(TARGET_LENGTH * 160) / 16000.0
    rows = []
    for i in range(n):
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t) + 0.02 * rng.standard_normal(
            t.shape)
        path = os.path.join(root, f"{name}_{i}.wav")
        write_wav(path, wav.astype(np.float32))
        rows.append({"dataset": "t", "location": path, "captions": f"caption {i % 3}"})
    manifest = os.path.join(root, name)
    with open(manifest, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


def base_argv(tmp_path, *extra):
    root = str(tmp_path)
    return ["--train_file", write_manifest(root, 8), "--validation_file",
            write_manifest(root, 2, seed=1, name="val.json"), "--tango_snapshot", SNAP,
            "--output_dir", os.path.join(root, "out"), "--target_length", str(TARGET_LENGTH),
            "--device", "cpu", *extra]


ARGV = ["--train_file", "t.json", "--validation_file", "v.json", "--tango_snapshot", "s",
        "--hf_model", "h", "--prefix", "p: ", "--num_examples", "5", "--uncondition",
        "--augment", "--per_device_train_batch_size", "3", "--gradient_accumulation_steps",
        "1", "--learning_rate", "1e-4", "--max_train_steps", "9", "--checkpointing_steps",
        "epoch", "--lr_scheduler_type", "cosine", "--num_warmup_steps", "2", "--seed", "7",
        "--with_tracking", "--skip_preflight", "--decode_workers", "2", "--save_every", "3"]


@pytest.mark.parametrize("argv", [ARGV[:4], ARGV], ids=["defaults", "set"])
def test_parse_args_matches_jax(argv):
    want = vars(jcli.parse_args(argv))
    got = vars(cli.parse_args(argv))
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert got["device"] is None


def test_two_updates_on_snapshot_tiny(tmp_path):
    argv = base_argv(tmp_path, "--hf_model", SNAP, "--per_device_train_batch_size", "2",
                     "--gradient_accumulation_steps", "2", "--max_train_steps", "2",
                     "--num_train_epochs", "1", "--checkpointing_steps", "best")
    state = cli.main(argv, tokenizer=WordHashTokenizer(128))
    assert state.step == 4 and state.opt_state.updates == 2
    out = tmp_path / "out"
    lines = [json.loads(x) for x in (out / "summary.jsonl").read_text().splitlines()]
    assert set(lines[0]) == {"args"} and lines[0]["args"]["hf_model"] == SNAP
    assert len(lines) == 2 and lines[1]["epoch"] == 0
    assert np.isfinite(lines[1]["train_loss"]) and np.isfinite(lines[1]["val_loss"])
    best, manifest = load_native(str(out / "best"))
    start = load_main_weights(SNAP)["unet_params"]
    assert set(best) == set(start) and manifest["epoch"] == 0
    assert any(not torch.equal(best[k], start[k]) for k in start)
    assert all(torch.isfinite(v).all() for v in best.values())


def _capture_fit(monkeypatch):
    seen = {}

    def fit(self, state, train_batches, val_batches, generator, output_dir, **kw):
        seen["params"] = {k: v.clone() for k, v in state.params.state_dict().items()}
        seen["trainer"], seen["batch"] = self, next(iter(train_batches()))
        return state

    monkeypatch.setattr(tsft.SFTTrainer, "fit", fit)
    return seen


def test_hf_model_weights_equal_load_main_weights(tmp_path, monkeypatch):
    seen = _capture_fit(monkeypatch)
    texts = []

    class Recording(WordHashTokenizer):
        def __call__(self, t, **kw):
            texts.extend(t)
            return super().__call__(t, **kw)

    cli.main(base_argv(tmp_path, "--hf_model", SNAP, "--prefix", "sfx: ", "--num_examples",
                       "4", "--per_device_train_batch_size", "2"), tokenizer=Recording(128))
    want = load_main_weights(SNAP)["unet_params"]
    assert set(seen["params"]) == set(want)
    for k in want:
        assert torch.equal(seen["params"][k], want[k]), k
    # f32 with remat, the VAE with its encoder; the prefix reached the captions
    trainer = seen["trainer"]
    unet = trainer.diffusion.unet
    assert unet.conv_in.weight.dtype == torch.float32 and unet.remat
    # 4 examples at batch 2 and accumulation 4: one update an epoch, 40 epochs
    assert trainer.vae.encoder is not None and trainer.total_steps == 40
    assert seen["batch"]["fbank"].shape == (2, TARGET_LENGTH, 64)
    assert len(texts) == 2 and all(t.startswith("sfx: caption ") for t in texts)


def test_random_unet_without_hf_model(tmp_path, monkeypatch):
    seen = _capture_fit(monkeypatch)
    cli.main(base_argv(tmp_path, "--unet_model_config", UNET_CONFIG),
             tokenizer=WordHashTokenizer(128))
    want = load_main_weights(SNAP)["unet_params"]
    assert set(seen["params"]) == set(want)
    assert any(not torch.equal(seen["params"][k], want[k]) for k in want)


def test_resume_from_checkpoint(tmp_path, monkeypatch):
    start = load_main_weights(SNAP)["unet_params"]
    saved = {k: v + 0.5 for k, v in start.items()}
    save_native(str(tmp_path / "ckpt"), saved, {"epoch": 3})
    seen = _capture_fit(monkeypatch)
    cli.main(base_argv(tmp_path, "--hf_model", SNAP, "--resume_from_checkpoint",
                       str(tmp_path / "ckpt")), tokenizer=WordHashTokenizer(128))
    for k in saved:
        assert torch.equal(seen["params"][k], saved[k]), k
    # the optimizer restarts: no moments yet
    assert seen["trainer"].diffusion.unet.conv_in.weight.grad is None


def test_default_tokenizer_warns(tmp_path, monkeypatch):
    _capture_fit(monkeypatch)
    with pytest.warns(UserWarning, match="WordHashTokenizer"):
        cli.main(base_argv(tmp_path, "--unet_model_config", UNET_CONFIG))


def _snapshot_without_t5(tmp_path):
    snap = tmp_path / "snap"
    shutil.copytree(SNAP, snap)
    sd = torch.load(snap / "pytorch_model_main.bin", map_location="cpu", weights_only=True)
    torch.save({k: v for k, v in sd.items() if not k.startswith("text_encoder.")},
               snap / "pytorch_model_main.bin")
    return str(snap)


@pytest.mark.parametrize("case", ["audioldm", "model_parallel", "coordinator", "world_size",
                                  "no_t5", "hub_name", "no_snapshot"])
def test_raising_flags(case, tmp_path, monkeypatch):
    """The flags and launches that cannot run. The mesh is ported (the two
    -process launches run in tests/test_torch_multihost.py); in one process
    `--model_parallel 2` has no second rank, JAX_COORDINATOR needs its
    process count and id, and torchrun's WORLD_SIZE its MASTER_ADDR."""
    for var in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "WORLD_SIZE", "RANK",
                "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    extra, err, match = [], SystemExit, None
    if case == "audioldm":
        # ported (queue A #8): the checkpoint carries no text encoder, so
        # without --hf_model there is none, and nothing is downloaded
        extra, match = ["--audioldm_ckpt", _tiny_audioldm_ckpt(tmp_path)], "downloads nothing"
    elif case == "model_parallel":
        extra, err, match = ["--model_parallel", "2"], ValueError, "does not divide the world of 1"
    elif case == "coordinator":
        monkeypatch.setenv("JAX_COORDINATOR", "localhost:1234")
        err, match = RuntimeError, "JAX_NUM_PROCESSES"
    elif case == "world_size":
        monkeypatch.setenv("WORLD_SIZE", "2")
        err, match = ValueError, "MASTER_ADDR"
    argv = base_argv(tmp_path, *extra)
    if case == "audioldm":
        i = argv.index("--tango_snapshot")
        del argv[i:i + 2]
    if case == "no_t5":
        argv[argv.index("--tango_snapshot") + 1] = _snapshot_without_t5(tmp_path)
        match = "downloads nothing"
    elif case == "hub_name":
        argv += ["--hf_model", "declare-lab/tango-full-ft-audiocaps"]
        err, match = FileNotFoundError, "downloads nothing"
    elif case == "no_snapshot":
        i = argv.index("--tango_snapshot")
        del argv[i:i + 2]
        match = "--tango_snapshot"
    with pytest.raises(err, match=match):
        cli.main(argv, tokenizer=WordHashTokenizer(128))


def _tiny_audioldm_ckpt(tmp_path):
    from tests.test_torch_audioldm import _tiny_monolithic_ckpt

    return _tiny_monolithic_ckpt(str(tmp_path / "tiny-audioldm.ckpt"))


# the port's VAE names -> the reference's (utils/convert.py's rules backwards)
VAE_NAMES = ((r"\b(down|up)_(\d+)_(block|attn)_(\d+)\.", r"\1.\2.\3.\4."),
             (r"\b(down|up)_(\d+)_(downsample|upsample)\.", r"\1.\2.\3."),
             (r"\bmid_(block_1|block_2|attn_1)\.", r"mid.\1."))


def test_audioldm_ckpt_vae_matches_jax(tmp_path, monkeypatch):
    """--audioldm_ckpt (no --tango_snapshot): the VAE is TANGO_VAE with the
    checkpoint's scale_factor, its weights, encoder included, JAX's
    `load_audioldm_ckpt`'s through from_jax_params; the T5 encoder comes
    from --hf_model. The checkpoint holds a seeded full-width VAE (the
    geometry JAX builds) under `first_stage_model.`."""
    import re

    from tango_tpu_torch import configs as TC

    g = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        shapes = AutoencoderKL(TC.TANGO_VAE, with_encoder=True).state_dict()
    sd = {}
    for k, v in shapes.items():
        for rx, rep in VAE_NAMES:
            k = re.sub(rx, rep, k)
        sd["first_stage_model." + k] = torch.randn(v.shape, generator=g)
    sd["scale_factor"] = torch.tensor(0.5)
    path = str(tmp_path / "audioldm.ckpt")
    torch.save({"state_dict": sd}, path)
    del sd
    seen = _capture_fit(monkeypatch)
    argv = base_argv(tmp_path, "--audioldm_ckpt", path, "--hf_model", SNAP)
    i = argv.index("--tango_snapshot")
    del argv[i:i + 2]
    cli.main(argv, tokenizer=WordHashTokenizer(128))
    vae = seen["trainer"].vae
    assert vae.cfg.scale_factor == 0.5 and vae.cfg.ch == TC.TANGO_VAE.ch
    want = from_jax_params(jckpt.load_audioldm_ckpt(path)[0])
    got = vae.state_dict()
    assert set(got) == set(want) and "encoder.conv_in.weight" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_snapshot_with_encoder_matches_jax():
    """load_tango_snapshot(with_encoder=True)'s VAE state dict is JAX's
    loader's tree, encoder and quant_conv included, bit for bit; without it
    the encoder is left out."""
    want = from_jax_params(jckpt.load_tango_snapshot(SNAP)["vae_params"])
    loaded = load_tango_snapshot(SNAP, with_encoder=True)
    got = loaded["vae_params"]
    assert set(got) == set(want)
    assert any(k.startswith("encoder.") for k in got) and "quant_conv.weight" in got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    vae = AutoencoderKL(loaded["vae_config"], with_encoder=True)
    vae.load_state_dict(got)  # strict
    plain = load_tango_snapshot(SNAP)["vae_params"]
    assert set(plain) == {k for k in got if not k.startswith(("encoder.", "quant_conv."))}
