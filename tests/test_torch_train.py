"""The port's SFT training slice vs the JAX package on the CPU, tiny configs.

  * the diffusion loss and the UNet's parameter gradients against
    `jax.value_and_grad` of the JAX loss, on the same converted parameters and
    the same timesteps, noise and drop mask (drawn with `jax.random` here, as
    the JAX loss draws them): loss atol 1e-5 / rtol 1e-4; gradients atol 1e-6 /
    rtol 1e-3, where the gradients reach 0.1 and differ by 6e-8 in f32
    (summation order only), so a wrong backward cannot hide;
  * the VAE encoder (`encode_moments`, the posterior draw and its KL) at the
    VAE's 1e-4 / 1e-3;
  * the mel frontend and mixup against the reference goldens at the JAX
    tests' tolerances (tests/test_audio.py), and the loader's fbanks against
    the JAX loader's;
  * the schedule, AdamW and gradient accumulation against optax fed the same
    gradients (f32 rounding only: 1e-6);
  * the trainer's behaviour, ported from tests/test_train.py;
  * native checkpoints, and the loader's spawned decode pool on a FLAC clip.
"""

import json
import os
import pathlib
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tango_tpu import configs as JC
from tango_tpu.audio.mix import mix_pairs as j_mix_pairs
from tango_tpu.models.diffusion import AudioDiffusion as JAudioDiffusion
from tango_tpu.models.unet import UNet2DConditionModel as JUNet
from tango_tpu.models.vae import AutoencoderKL as JVAE
from tango_tpu.models.vae import kl_diagonal_gaussian as j_kl
from tango_tpu.train import data as jdata
from tango_tpu.train import sft as jsft
from tango_tpu_torch import configs as TC
from tango_tpu_torch.audio.mix import compute_gain, mix, mix_pairs
from tango_tpu_torch.audio.stft import MelSpectrogram, mel_filter_bank, wav_batch_to_fbank
from tango_tpu_torch.audio.wav import write_wav
from tango_tpu_torch.models.diffusion import AudioDiffusion
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.models.vae import AutoencoderKL, kl_diagonal_gaussian, sample_diagonal_gaussian
from tango_tpu_torch.ops import attention as tattn
from tango_tpu_torch.ops import basic as tbasic
from tango_tpu_torch.train import sft as tsft
from tango_tpu_torch.train.data import (
    Example,
    FeaturizedLoader,
    load_manifest,
    validate_manifest,
)
from tango_tpu_torch.utils.checkpoint import load_native, save_native
from tango_tpu_torch.utils.convert import from_jax_params
from tango_tpu_torch.utils.init import init_random_

from tests._torch_helpers import random_jax_params
from tests.conftest import load_golden

REPO = pathlib.Path(__file__).resolve().parents[1]

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)

# a tiny UNet whose first level has 256 latent tokens (32 x 8) and head width
# 8, so that its self-attention takes the kernel route and the attention
# backward kernels' plain versions, as the full model's does
LOSS_UNET = dict(
    in_channels=8, out_channels=8,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(16, 32), layers_per_block=1,
    cross_attention_dim=16, attention_head_dim=(2, 4), norm_num_groups=8,
)
VAE_KW = dict(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2), num_res_blocks=1,
              scale_factor=0.9, attn_resolutions=(128,))


# ----------------------------------------------------------- loss and grads

def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    lat = rng.randn(2, 32, 8, 8).astype(np.float32)
    emb = (rng.randn(2, 7, 16) * 0.5).astype(np.float32)
    mask = np.ones((2, 7), np.int64)
    mask[1, 4:] = 0
    return lat, emb, mask


def _draws(key, shape, n):
    """The timesteps, noise and drop mask JAX's loss draws from `key`
    (tango_tpu/models/diffusion.py:88-104)."""
    k_t, k_noise, k_uncond = jax.random.split(key, 3)
    t = np.array(jax.random.randint(k_t, (shape[0],), 0, n))
    noise = np.array(jax.random.normal(k_noise, shape, jnp.float32))
    drop = np.array(jax.random.uniform(k_uncond, (shape[0], 1, 1)) < 0.1).reshape(-1)
    return t, noise, drop


def _key_with_one_drop(shape):
    """The first key whose uncondition draw drops exactly one of the two
    rows, so that both branches of the dropout are on the compared path."""
    for seed in range(1000):
        key = jax.random.PRNGKey(seed)
        if _draws(key, shape, 1000)[2].sum() == 1:
            return key
    raise AssertionError("no such key")


@pytest.mark.parametrize("prediction,snr_gamma,grads", [("v_prediction", 5.0, True),
                                                        ("epsilon", None, False)])
def test_loss_and_unet_grads_match_jax(prediction, snr_gamma, grads, monkeypatch):
    lat, emb, mask = _loss_inputs(0)
    jsched = JC.SchedulerConfig(prediction_type=prediction)
    jdiff = JAudioDiffusion(JC.UNetConfig(**LOSS_UNET), jsched, snr_gamma=snr_gamma,
                            uncondition=True, latent_t_size=32, latent_f_size=8)
    params = random_jax_params(lambda k: jdiff.unet.init(
        k, jnp.asarray(lat), jnp.zeros((2,), jnp.int32), jnp.asarray(emb))["params"], 3)
    key = _key_with_one_drop(lat.shape)

    def jloss(p):
        return jdiff.loss(p, jnp.asarray(lat), jnp.asarray(emb), jnp.asarray(mask), key)

    if grads:
        jval, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    else:
        jval = jax.jit(jloss)(params)

    calls = {"attn": 0, "gn": 0}
    orig_attn, orig_gn = tattn.flash_attention_bwd, tbasic.gn_silu_bwd

    def spy(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tattn, "flash_attention_bwd", spy("attn", orig_attn))
    monkeypatch.setattr(tbasic, "gn_silu_bwd", spy("gn", orig_gn))
    diff = AudioDiffusion(TC.UNetConfig(**LOSS_UNET), TC.SchedulerConfig(prediction_type=prediction),
                          snr_gamma=snr_gamma, uncondition=True, latent_t_size=32,
                          latent_f_size=8, remat=True, device="cpu")
    diff.unet.load_state_dict(from_jax_params(params))
    t, noise, drop = _draws(key, lat.shape, 1000)
    loss = diff.loss(torch.from_numpy(lat), torch.from_numpy(emb), torch.from_numpy(mask),
                     timesteps=torch.from_numpy(t), noise=torch.from_numpy(noise),
                     drop=torch.from_numpy(drop))
    np.testing.assert_allclose(loss.item(), float(jval), atol=1e-5, rtol=1e-4)
    if not grads:
        return
    loss.backward()
    # the kernel routes' backward (plain versions on the CPU) was on the path
    assert calls["attn"] > 0 and calls["gn"] > 0
    want = from_jax_params(jax.device_get(jgrads))
    got = {n: p.grad for n, p in diff.unet.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-6, rtol=1e-3,
                                   err_msg=name)


def test_unet_remat_keeps_gradients():
    """Recomputing the blocks in the backward pass changes no gradient."""
    lat, emb, mask = _loss_inputs(1)
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        unet = init_random_(UNet2DConditionModel(TC.UNetConfig(**LOSS_UNET), remat=remat),
                            torch.Generator().manual_seed(5))
        out = unet(torch.from_numpy(lat), torch.tensor([10, 900]), torch.from_numpy(emb),
                   torch.from_numpy(mask))
        (out**2).mean().backward()
        grads.append({n: p.grad for n, p in unet.named_parameters()})
    for name, g in grads[0].items():
        np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(), atol=1e-7, rtol=1e-5,
                                   err_msg=name)


# ----------------------------------------------------------------- VAE encoder

def test_vae_encoder_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 32, 16, 1).astype(np.float32)
    jmodel = JVAE(JC.VAEConfig(**VAE_KW))
    params = random_jax_params(lambda k: jmodel.init(k, jnp.zeros((1, 32, 16, 1)), k)["params"], 4)
    jmean, jlogvar = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                                       method=jmodel.encode_moments))(
        params, jnp.asarray(x))
    model = AutoencoderKL(TC.VAEConfig(**VAE_KW), with_encoder=True)
    model.load_state_dict(from_jax_params(params))  # strict: encoder and quant_conv map too
    with torch.no_grad():
        mean, logvar = model.encode_moments(torch.from_numpy(x))
    assert mean.shape == (2, 16, 8, 8)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), atol=1e-4, rtol=1e-3)

    key = jax.random.PRNGKey(9)
    jz = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, key,
                                           method=jmodel.encode_first_stage))(params, jnp.asarray(x))
    noise = torch.from_numpy(np.array(jax.random.normal(key, jmean.shape, jnp.float32)))
    z = 0.9 * sample_diagonal_gaussian(mean, logvar, noise=noise)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(kl_diagonal_gaussian(mean, logvar).numpy(),
                               np.asarray(j_kl(jmean, jlogvar)), rtol=1e-4)
    with torch.no_grad():
        mode = model.encode_first_stage_mode(torch.from_numpy(x))
        drawn = model.encode_first_stage(torch.from_numpy(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(mode.numpy(), 0.9 * mean.numpy(), rtol=1e-6)
    assert drawn.shape == mode.shape and not torch.equal(drawn, mode)


# -------------------------------------------------------------------- frontend

def test_mel_frontend_matches_golden():
    g = load_golden("stft")
    np.testing.assert_allclose(mel_filter_bank(16000, 1024, 64, 0, 8000), g["mel_basis"],
                               atol=1e-6)
    mel, log_mag = MelSpectrogram().mel_spectrogram(g["y"])
    # the reference is channel-major (B, C, T), the port time-major
    np.testing.assert_allclose(mel.numpy().transpose(0, 2, 1), g["mel"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(log_mag.numpy().transpose(0, 2, 1), g["log_mag"],
                               atol=2e-4, rtol=1e-3)
    fbank, _ = wav_batch_to_fbank(MelSpectrogram(), g["y"], target_length=64)
    assert fbank.shape == (2, 64, 64)
    np.testing.assert_allclose(fbank[:, :51].numpy().transpose(0, 2, 1), g["mel"],
                               atol=2e-4, rtol=1e-3)
    assert float(fbank[:, 51:].abs().sum()) == 0.0


def test_mix_matches_golden_and_jax():
    g = load_golden("mix")
    np.testing.assert_allclose(compute_gain(g["s1"], 16000), g["gain1"], atol=1e-4)
    np.testing.assert_allclose(compute_gain(g["s2"], 16000), g["gain2"], atol=1e-4)
    np.testing.assert_allclose(mix(g["s1"], g["s2"], 0.5, 16000), g["mixed"], atol=1e-5)
    waves = np.stack([g["s1"], g["s2"], 0.5 * g["s1"][::-1].copy()])
    caps = ["A dog", "Rain", "Wind"]
    out, texts = mix_pairs(waves, caps, 2, rng=random.Random(3))
    jout, jtexts = j_mix_pairs(waves, caps, 2, rng=random.Random(3))
    assert texts == jtexts
    np.testing.assert_array_equal(out, jout)


def _write_manifest(tmp_path, n=4, sr=16000, seconds=1.0):
    rows = []
    for i in range(n):
        p = str(tmp_path / f"w{i}.wav")
        t = np.arange(int(sr * seconds)) / sr
        write_wav(p, (0.5 * np.sin(2 * np.pi * (200 + 100 * i) * t)).astype(np.float32), sr)
        rows.append({"dataset": "t", "location": p, "captions": f"tone {i}"})
    manifest = tmp_path / "train.json"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(manifest)


def test_loader_fbanks_match_jax_loader(tmp_path):
    """Read (at 22.05 kHz, so the resampler runs), normalise, pad and
    featurize: the port's loader gives the JAX loader's fbanks."""
    manifest = _write_manifest(tmp_path, n=4, sr=22050)
    mine = list(FeaturizedLoader(load_manifest(manifest), 2, target_length=64, shuffle=False))
    ref = list(jdata.FeaturizedLoader(jdata.load_manifest(manifest), 2, target_length=64,
                                      shuffle=False))
    assert len(mine) == len(ref) == 2
    for a, b in zip(mine, ref):
        assert a["captions"] == b["captions"]
        np.testing.assert_allclose(a["waveforms"], b["waveforms"], atol=1e-6)
        np.testing.assert_allclose(a["fbank"], np.asarray(b["fbank"]), atol=2e-4, rtol=1e-3)


def test_decode_pool_matches_serial(tmp_path):
    """decode_workers > 0 (a spawned process pool) gives the serial batches,
    on a WAV and a FLAC clip (the FLAC decoder runs in the spawned worker)."""
    from tests._flac_encoder import encode_flac

    t = np.arange(22050) / 22050
    flac = tmp_path / "a.flac"
    flac.write_bytes(encode_flac(np.round(8000 * np.sin(2 * np.pi * 330 * t)).astype(np.int64),
                                 sample_rate=22050, kind="fixed", order=2, rice_param=8))
    examples = load_manifest(_write_manifest(tmp_path, n=1)) + [Example(str(flac), "flac")]
    serial = next(iter(FeaturizedLoader(examples, 2, target_length=32, shuffle=False)))
    assert np.std(serial["waveforms"][1]) > 0.1  # decoded, not the constant stand-in
    loader = FeaturizedLoader(examples, 2, target_length=32, shuffle=False, decode_workers=1)
    try:
        pooled = next(iter(loader))
        np.testing.assert_array_equal(pooled["waveforms"], serial["waveforms"])
        np.testing.assert_array_equal(pooled["fbank"], serial["fbank"])
    finally:
        loader.close()


def test_manifest_loader_with_mixup(tmp_path):
    manifest = _write_manifest(tmp_path, n=5)
    examples = load_manifest(manifest)
    assert len(examples) == 5
    validate_manifest(examples)
    batches = list(FeaturizedLoader(examples, batch_size=2, target_length=64, augment_num=1))
    assert len(batches) == 2  # drop_last
    assert batches[0]["fbank"].shape == (3, 64, 64)  # 2 + 1 mixed
    assert " and " in batches[0]["captions"][2]


# ------------------------------------------------------------------ optimizer

@pytest.mark.parametrize("kind,warmup", [("linear", 0), ("linear", 3), ("cosine", 2),
                                         ("constant", 3), ("constant_with_warmup", 3)])
def test_schedule_matches_optax(kind, warmup):
    kw = dict(learning_rate=1e-3, lr_scheduler_type=kind, num_warmup_steps=warmup)
    want = jsft.make_schedule(JC.TrainConfig(**kw), 10)
    got = tsft.make_schedule(TC.TrainConfig(**kw), 10)
    for n in range(14):
        np.testing.assert_allclose(got(n), float(want(n)), atol=1e-10, rtol=1e-6)


@pytest.mark.parametrize("accum,warmup", [(1, 0), (3, 2)])
def test_optimizer_and_accumulation_match_optax(accum, warmup):
    """AdamW (decoupled decay on the pre-update parameter, eps added to
    sqrt(v-hat)), the schedule at the update count, and the mean of the
    micro-gradients applied on every accum-th step, as optax.MultiSteps."""
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (5,)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(3 * accum)]
    kw = dict(learning_rate=1e-2, num_warmup_steps=warmup, gradient_accumulation_steps=accum,
              weight_decay=1e-2)
    tx = jsft.make_optimizer(JC.TrainConfig(**kw), 4)
    jp = [jnp.asarray(p) for p in init]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = tsft.make_optimizer(TC.TrainConfig(**kw), 4, tp)
    for i, g in enumerate(grads):
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):  # backward sums into .grad
            p.grad = torch.from_numpy(x.copy()) if p.grad is None else p.grad + torch.from_numpy(x)
        assert opt.step() == ((i + 1) % accum == 0)
        for p, q in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), atol=1e-6, rtol=1e-6)
    assert opt.updates == 3


# -------------------------------------------------------------------- trainer

TINY_UNET = dict(LOSS_UNET, block_out_channels=(16, 32))
TINY_VAE = dict(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2), num_res_blocks=1)


def make_trainer(**cfg_kw):
    diffusion = AudioDiffusion(TC.UNetConfig(**TINY_UNET), latent_t_size=8, latent_f_size=4,
                               snr_gamma=5.0, device="cpu")
    vae = init_random_(AutoencoderKL(TC.VAEConfig(**TINY_VAE), with_encoder=True),
                       torch.Generator().manual_seed(0)).eval()
    cfg = TC.TrainConfig(**{"gradient_accumulation_steps": 1, "learning_rate": 1e-3, **cfg_kw})
    return tsft.SFTTrainer(diffusion, vae, cfg, total_steps=50)


def _batch(bs=4):
    g = torch.Generator().manual_seed(7)
    return {"fbank": torch.randn(bs, 16, 8, generator=g) * 0.5,
            "text_embeds": torch.randn(bs, 4, 16, generator=g) * 0.1,
            "text_mask": torch.ones(bs, 4, dtype=torch.long)}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_train_loss_decreases():
    trainer = make_trainer()
    state = trainer.init_state(_gen(1))
    batch = _batch()
    losses = []
    for i in range(30):
        # the same draws every third step, so that the objective is learnable
        state, loss = trainer.train_step(state, batch, _gen(i % 3))
        losses.append(float(loss))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert state.step == 30 and state.opt_state.updates == 30


def test_grad_accumulation_steps_update_cadence():
    trainer = make_trainer(gradient_accumulation_steps=2)
    state = trainer.init_state(_gen(1))
    p = next(state.params.parameters())
    p0 = p.detach().clone()
    state, _ = trainer.train_step(state, _batch(), _gen(0))
    assert torch.equal(p, p0)  # a micro-step: no update
    state, _ = trainer.train_step(state, _batch(), _gen(1))
    assert (p - p0).abs().max() > 0  # the second applies


def test_fit_writes_best_checkpoint(tmp_path):
    trainer = make_trainer()
    state = trainer.init_state(_gen(1))
    batch = _batch()
    out = str(tmp_path / "run")
    state = trainer.fit(state, lambda: iter([batch, batch]), lambda: iter([batch]), _gen(3), out,
                        num_epochs=2)
    assert os.path.exists(os.path.join(out, "summary.jsonl"))
    params, manifest = load_native(os.path.join(out, "best"))
    assert "val_loss" in manifest
    assert set(params) == set(state.params.state_dict())


def test_fit_numeric_checkpointing_steps(tmp_path):
    trainer = make_trainer(checkpointing_steps="2")
    state = trainer.init_state(_gen(1))
    batch = _batch()
    out = str(tmp_path / "run")
    trainer.fit(state, lambda: iter([batch] * 3), lambda: iter([batch]), _gen(3), out,
                num_epochs=2)
    for k in (2, 4, 6):  # 6 batches at N=2
        assert os.path.exists(os.path.join(out, f"step_{k}", "manifest.json")), k
    for bad_value in ("every_so_often", "0"):
        bad = make_trainer(checkpointing_steps=bad_value)
        with pytest.raises(ValueError, match="checkpointing_steps"):
            bad.fit(bad.init_state(_gen(1)), lambda: iter([]), lambda: iter([]), _gen(3),
                    str(tmp_path / "bad"), num_epochs=1)


def test_fit_max_train_steps_stops_early(tmp_path):
    trainer = make_trainer(max_train_steps=2)
    state = trainer.init_state(_gen(1))
    batch = _batch()
    served = [0]

    def batches():
        for _ in range(3):
            served[0] += 1
            yield batch

    out = trainer.fit(state, batches, lambda: iter([batch]), _gen(3), str(tmp_path / "capped"),
                      num_epochs=4)
    assert out.step == 2 and served[0] == 2  # stopped inside the first epoch


def test_fit_best_mode_saves_epoch_every_save_every(tmp_path):
    trainer = make_trainer(save_every=2)
    state = trainer.init_state(_gen(1))
    batch = _batch()
    out = str(tmp_path / "periodic")
    trainer.fit(state, lambda: iter([batch]), lambda: iter([batch]), _gen(3), out, num_epochs=3)
    assert [os.path.exists(os.path.join(out, f"epoch_{e}")) for e in range(3)] == [False, True,
                                                                                  False]


def test_init_state_from_given_params():
    trainer = make_trainer()
    given = {k: torch.full_like(v, 0.5) for k, v in trainer.diffusion.unet.state_dict().items()}
    state = trainer.init_state(params=given)
    for k, v in state.params.state_dict().items():
        assert torch.equal(v, given[k]), k


def test_native_checkpoint_and_converted_params_load_into_one_module(tmp_path):
    """A JAX UNet tree converted by from_jax_params and a port state dict saved
    by save_native load into the same module, and the round trip is exact."""
    jmodel = JUNet(JC.UNetConfig(**TINY_UNET))
    params = random_jax_params(lambda k: jmodel.init(
        k, jnp.zeros((1, 8, 4, 8)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 4, 16)))["params"], 6)
    unet = UNet2DConditionModel(TC.UNetConfig(**TINY_UNET))
    unet.load_state_dict(from_jax_params(params))
    save_native(str(tmp_path / "ck"), unet.state_dict(), manifest={"epoch": 0})
    sd, manifest = load_native(str(tmp_path / "ck"))
    assert manifest == {"epoch": 0} and os.path.isfile(tmp_path / "ck" / "params")
    fresh = UNet2DConditionModel(TC.UNetConfig(**TINY_UNET))
    fresh.load_state_dict(sd)
    for k, v in unet.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_encode_batches_runs_the_frozen_t5():
    from tango_tpu_torch.models.t5 import T5Encoder
    from tango_tpu_torch.tokenizer import WordHashTokenizer

    t5 = init_random_(T5Encoder(TC.T5Config(vocab_size=64, d_model=16, d_kv=4, d_ff=32,
                                            num_layers=1, num_heads=4)), _gen(2)).eval()
    loader = [{"fbank": np.zeros((2, 16, 8), np.float32), "captions": ["a dog", "rain"]}]
    batches = list(tsft.encode_batches(loader, WordHashTokenizer(64), t5, max_text_length=6)())
    b = batches[0]
    assert b["text_embeds"].shape == (2, 6, 16) and not b["text_embeds"].requires_grad
    assert b["text_mask"].tolist() == [[1, 1, 1, 0, 0, 0], [1, 1, 0, 0, 0, 0]]


def test_training_modules_import_no_jax():
    """The training slice (audio/, train/, utils/checkpoint) and chip_smoke
    load no JAX, flax, optax, transformers or JAX package module."""
    code = (
        "import sys\n"
        "import chip_smoke, tango_tpu_torch.train.sft, tango_tpu_torch.train.data\n"
        "import tango_tpu_torch.audio.wav, tango_tpu_torch.utils.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "             'optax', 'orbax', 'tango_tpu', 'transformers', 'huggingface_hub'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
