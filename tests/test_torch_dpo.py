"""Tango 2's DPO trainer in the port (models/dpo.py, train/dpo.py,
train/dpo_cli.py) against the JAX package on the CPU, at the SFT test's tiny
LOSS_UNET (tests/test_torch_train.py: 256 latent tokens at head width 8, so
the attention and GroupNorm kernel routes and their backward run).

Tolerances. JAX's draws (t, noise, drop from its key) go to the port through
the overrides. The per-sample MSEs of the trained and the reference UNet are
held at the SFT loss test's atol 1e-5 / rtol 1e-4. The loss amplifies them:
inside = -0.5 beta (model_w - model_l - ref_w + ref_l), so each pair's inside
may differ by 0.5 beta times the sum of its four MSE tolerances (`_inside_tol`),
and the loss, a mean of 1-Lipschitz -logsigmoid terms, by the mean of those.
The inputs are chosen so that every |inside| exceeds its bound (asserted), so
implicit_acc must be equal. The gradients: each is a sum over the pairs of
the weight 0.5 beta sigmoid(-inside) / B times per-sample MSE gradients; a
weight's relative change is at most (1 - sigmoid(-inside)) |d inside|, with
d inside taken from the port's per-sample MSEs against JAX's, so they are
held at rtol 1e-3 (the SFT test's) plus that, and atol 1e-6 times the
largest weight."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu import configs as JC
from tango_tpu.models.dpo import DPOAudioDiffusion as JDPO
from tango_tpu.train import dpo_cli as jdpo_cli
from tango_tpu_torch import configs as TC
from tango_tpu_torch.audio.wav import write_wav
from tango_tpu_torch.models.dpo import DPOAudioDiffusion, make_reference
from tango_tpu_torch.models.vae import AutoencoderKL
from tango_tpu_torch.tokenizer import WordHashTokenizer
from tango_tpu_torch.train import dpo_cli
from tango_tpu_torch.train.dpo import DPOTrainer
from tango_tpu_torch.utils.checkpoint import load_native, load_tango_snapshot
from tango_tpu_torch.utils.convert import from_jax_params
from tango_tpu_torch.utils.init import init_random_

from tests._torch_helpers import random_jax_params
from tests.conftest import GOLDEN
from tests.test_torch_train import LOSS_UNET, VAE_KW

torch.set_num_threads(1)

BETA = 2000.0
N_T = 1000


def _inputs(seed):
    rng = np.random.RandomState(seed)
    lat_w = rng.randn(2, 32, 8, 8).astype(np.float32)
    lat_l = rng.randn(2, 32, 8, 8).astype(np.float32)
    emb = (rng.randn(2, 7, 16) * 0.5).astype(np.float32)
    mask = np.ones((2, 7), np.int64)
    mask[1, 4:] = 0
    return lat_w, lat_l, emb, mask


def _draws(key, shape):
    """The half-batch timesteps, noise and drop mask JAX's dpo_loss draws
    from `key` (tango_tpu/models/dpo.py:44-82)."""
    k_t, k_noise, k_uncond = jax.random.split(key, 3)
    t = np.array(jax.random.randint(k_t, (shape[0],), 0, N_T))
    noise = np.array(jax.random.normal(k_noise, shape, jnp.float32))
    drop = np.array(jax.random.uniform(k_uncond, (shape[0], 1, 1)) < 0.1).reshape(-1)
    return t, noise, drop


def _key_with_one_drop(shape):
    for seed in range(1000):
        key = jax.random.PRNGKey(seed)
        if _draws(key, shape)[2].tolist() == [True, False]:
            return key
    raise AssertionError("no such key")


def _jax_side(prediction):
    jdiff = JDPO(JC.UNetConfig(**LOSS_UNET), JC.SchedulerConfig(prediction_type=prediction),
                 uncondition=True, latent_t_size=32, latent_f_size=8, beta_dpo=BETA)
    lat = jnp.zeros((2, 32, 8, 8))

    def init(k):
        return jdiff.unet.init(k, lat, jnp.zeros((2,), jnp.int32), jnp.zeros((2, 7, 16)))["params"]

    params = random_jax_params(init, 3)
    # the reference: the same UNet moved by 3% of each tensor's mean magnitude,
    # so that every pair's |inside| lands between 2 and 8, past its bound and
    # short of saturating the sigmoid
    rng = np.random.RandomState(11)
    ref = jax.tree_util.tree_map(
        lambda x: (x + 0.03 * np.abs(x).mean() * rng.randn(*x.shape)).astype(np.float32), params)
    return jdiff, params, ref


def _port_side(prediction, params, ref_params):
    diff = DPOAudioDiffusion(TC.UNetConfig(**LOSS_UNET),
                             TC.SchedulerConfig(prediction_type=prediction), uncondition=True,
                             latent_t_size=32, latent_f_size=8, remat=True, beta_dpo=BETA,
                             device="cpu")
    diff.unet.load_state_dict(from_jax_params(params))
    ref = make_reference(diff.unet)
    ref.load_state_dict(from_jax_params(ref_params))
    return diff, ref


def _jax_per_sample(jdiff, params, lat_w, lat_l, emb, mask, key, validation=False):
    """JAX's per-sample MSEs (2B,), the dpo_loss body's `per_sample_mse`."""
    sched = jdiff.noise_scheduler
    t, noise, drop = _draws(key, lat_w.shape)
    if validation:
        t = np.full_like(t, N_T - 1)
    t2 = jnp.asarray(np.concatenate([t, t]))
    lat = jnp.concatenate([lat_w, lat_l])
    nz = jnp.asarray(np.concatenate([noise, noise]))
    noisy = sched.add_noise(lat, nz, t2)
    target = nz if sched.config.prediction_type == "epsilon" else sched.get_velocity(lat, nz, t2)
    e = np.concatenate([emb, emb])
    if not validation:
        e[:2][drop] = 0.0
    apply = jax.jit(lambda p, x, t, c, m: jdiff.unet.apply({"params": p}, x, t, c,
                                                           encoder_attention_mask=m))
    pred = apply(params, noisy, t2, jnp.asarray(e), jnp.asarray(np.concatenate([mask, mask])))
    return np.asarray(((pred - target) ** 2).mean(axis=(1, 2, 3)))


def _port_per_sample(diff, unet, lat_w, lat_l, emb, mask, key):
    """The port's per-sample MSEs (2B,) on JAX's draws, as dpo_loss computes them."""
    sched = diff.noise_scheduler
    t, noise, drop = _draws(key, lat_w.shape)
    lat = torch.from_numpy(np.concatenate([lat_w, lat_l]))
    nz = torch.from_numpy(np.concatenate([noise, noise]))
    t2 = torch.from_numpy(np.concatenate([t, t]))
    e = torch.from_numpy(np.concatenate([emb, emb]))
    e[:2][torch.from_numpy(drop)] = 0.0
    target = nz if sched.config.prediction_type == "epsilon" else sched.get_velocity(lat, nz, t2)
    with torch.no_grad():
        pred = unet(sched.add_noise(lat, nz, t2), t2, e,
                    torch.from_numpy(np.concatenate([mask, mask])))
    return ((pred - target) ** 2).mean(dim=(1, 2, 3)).numpy()


def _inside(model, ref):
    return -0.5 * BETA * ((model[:2] - model[2:]) - (ref[:2] - ref[2:]))


def _inside_tol(model, ref):
    tol = lambda v: 1e-5 + 1e-4 * np.abs(v)  # noqa: E731
    t_m, t_r = tol(model), tol(ref)
    return 0.5 * BETA * (t_m[:2] + t_m[2:] + t_r[:2] + t_r[2:])


@pytest.mark.parametrize("prediction", ["v_prediction", "epsilon"])
def test_dpo_loss_and_grads_match_jax(prediction):
    lat_w, lat_l, emb, mask = _inputs(0)
    jdiff, params, ref_params = _jax_side(prediction)
    key = _key_with_one_drop(lat_w.shape)
    args = (jnp.asarray(lat_w), jnp.asarray(lat_l), jnp.asarray(emb), jnp.asarray(mask), key)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jdiff.dpo_loss(p, ref_params, *args), has_aux=True))(params)
    j_model = _jax_per_sample(jdiff, params, lat_w, lat_l, emb, mask, key)
    j_ref = _jax_per_sample(jdiff, ref_params, lat_w, lat_l, emb, mask, key)
    j_inside = _inside(j_model, j_ref)
    # the replica of JAX's body gives JAX's loss
    inside_tol = _inside_tol(j_model, j_ref)
    np.testing.assert_allclose(np.logaddexp(0.0, -j_inside).mean(), float(jloss),
                               atol=inside_tol.mean())

    diff, ref = _port_side(prediction, params, ref_params)
    t, noise, drop = _draws(key, lat_w.shape)
    seen = []
    unet_forward = diff.unet.forward

    def spy(x, ts, ctx, m):
        seen.append(ctx.detach().clone())
        return unet_forward(x, ts, ctx, m)

    diff.unet.forward = spy
    loss, met = diff.dpo_loss(torch.from_numpy(lat_w), torch.from_numpy(lat_l),
                              torch.from_numpy(emb), torch.from_numpy(mask), ref_unet=ref,
                              timesteps=torch.from_numpy(t), noise=torch.from_numpy(noise),
                              drop=torch.from_numpy(drop))
    assert (np.abs(j_inside) > inside_tol).all(), (j_inside, inside_tol)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=inside_tol.mean())
    np.testing.assert_allclose(2 * met["raw_model_loss"].item(), j_model.mean() * 2,
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(met["raw_model_loss"].item(), float(jmet["raw_model_loss"]),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(met["raw_ref_loss"].item(), float(jmet["raw_ref_loss"]),
                               atol=1e-5, rtol=1e-4)
    assert met["implicit_acc"].item() == float(jmet["implicit_acc"])
    # the winner-only dropout: pair 0's winner row zeroed, its loser row not
    ctx = seen[0]
    assert ctx.shape[0] == 4 and (ctx[0] == 0).all()
    for row in (1, 2, 3):
        assert torch.equal(ctx[row], torch.from_numpy(emb[row % 2]))

    loss.backward()
    assert all(p.grad is None for p in ref.parameters())
    want = from_jax_params(jax.device_get(jgrads))
    # each pair's weight sigmoid(-inside) moves by a relative (1 - sigmoid) |d inside|,
    # d inside measured from the port's per-sample MSEs (held to JAX's above)
    sig = 1 / (1 + np.exp(j_inside))
    p_model = _port_per_sample(diff, diff.unet, lat_w, lat_l, emb, mask, key)
    p_ref = _port_per_sample(diff, ref, lat_w, lat_l, emb, mask, key)
    # the per-sample MSEs at the SFT loss test's tolerance: the bound above
    np.testing.assert_allclose(p_model, j_model, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(p_ref, j_ref, atol=1e-5, rtol=1e-4)
    rtol = 1e-3 + float(((1 - sig) * np.abs(_inside(p_model, p_ref) - j_inside)).max())
    atol = 1e-6 * float((0.5 * BETA * sig / 2).max())
    for name, p in diff.unet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=atol, rtol=rtol,
                                   err_msg=name)


def test_identical_pair_is_log2_and_reference_frozen():
    """w == l and ref == model: inside is 0 and the loss is log 2; the
    reference UNet gets no gradient and stays bit-equal through an update."""
    gen = torch.Generator().manual_seed(0)
    diff = DPOAudioDiffusion(TC.UNetConfig(**LOSS_UNET), remat=True, beta_dpo=BETA, device="cpu")
    init_random_(diff.unet, gen)
    ref = make_reference(diff.unet)
    before = {k: v.clone() for k, v in ref.state_dict().items()}
    lat_w, _, emb, mask = _inputs(2)
    lat = torch.from_numpy(lat_w)
    loss, met = diff.dpo_loss(lat, lat, torch.from_numpy(emb), torch.from_numpy(mask),
                              torch.Generator().manual_seed(1), ref_unet=ref)
    assert loss.item() == pytest.approx(float(np.log(2.0)), rel=1e-6)
    assert met["implicit_acc"].item() == 0.0
    opt = torch.optim.SGD(diff.unet.parameters(), lr=1.0)
    (loss + met["raw_model_loss"] * 0 + sum(p.sum() * 0 for p in diff.unet.parameters())
     ).backward()
    diff.unet.conv_in.weight.grad.add_(1.0)
    opt.step()
    assert all(p.grad is None and not p.requires_grad for p in ref.parameters())
    assert all(torch.equal(before[k], v) for k, v in ref.state_dict().items())
    assert not torch.equal(diff.unet.conv_in.weight, ref.conv_in.weight)


def test_validation_uses_last_timestep_and_no_dropout():
    gen = torch.Generator().manual_seed(0)
    diff = DPOAudioDiffusion(TC.UNetConfig(**LOSS_UNET), uncondition=True, beta_dpo=BETA,
                             device="cpu")
    init_random_(diff.unet, gen)
    ref = make_reference(diff.unet)
    seen = []
    fwd = diff.unet.forward

    def spy(x, ts, ctx, m):
        seen.append((ts.clone(), ctx.clone()))
        return fwd(x, ts, ctx, m)

    diff.unet.forward = spy
    lat_w, lat_l, emb, mask = _inputs(3)
    with torch.no_grad():
        diff.dpo_loss(torch.from_numpy(lat_w), torch.from_numpy(lat_l), torch.from_numpy(emb),
                      torch.from_numpy(mask), gen, validation_mode=True, ref_unet=ref,
                      drop=torch.tensor([True, True]))
    ts, ctx = seen[0]
    assert ts.tolist() == [N_T - 1] * 4
    assert torch.equal(ctx, torch.from_numpy(np.concatenate([emb, emb])))


def test_draw_order_is_t_noise_drop():
    """Without overrides the draws come from the generator in JAX's order."""
    diff = DPOAudioDiffusion(TC.UNetConfig(**LOSS_UNET), uncondition=True, beta_dpo=BETA,
                             device="cpu")
    init_random_(diff.unet, torch.Generator().manual_seed(0))
    ref = make_reference(diff.unet)
    lat_w, lat_l, emb, mask = (torch.from_numpy(a) for a in _inputs(4))
    g = torch.Generator().manual_seed(9)
    t = torch.randint(0, N_T, (2,), generator=g)
    noise = torch.randn(lat_w.shape, generator=g)
    drop = torch.rand((2,), generator=g) < 0.1
    with torch.no_grad():
        a, _ = diff.dpo_loss(lat_w, lat_l, emb, mask, torch.Generator().manual_seed(9),
                             ref_unet=ref)
        b, _ = diff.dpo_loss(lat_w, lat_l, emb, mask, ref_unet=ref, timesteps=t, noise=noise,
                             drop=drop)
    assert torch.equal(a, b)


# ------------------------------------------------------------------ trainer

def _trainer(**cfg):
    diff = DPOAudioDiffusion(TC.UNetConfig(**LOSS_UNET), remat=True, beta_dpo=BETA, device="cpu")
    init_random_(diff.unet, torch.Generator().manual_seed(1))
    vae = AutoencoderKL(TC.VAEConfig(**VAE_KW), with_encoder=True)
    init_random_(vae, torch.Generator().manual_seed(2))
    trainer = DPOTrainer(diff, vae, TC.DPOConfig(gradient_accumulation_steps=1,
                                                 learning_rate=1e-4, **cfg), total_steps=4)
    return trainer, trainer.init_state(), make_reference(diff.unet)


def _batch(seed, winner=True):
    g = torch.Generator().manual_seed(seed)
    fb = lambda: torch.randn(2, 64, 16, generator=g) * 0.5  # noqa: E731
    b = {"fbank_w": fb(), "fbank_l": fb(), "text_embeds": torch.randn(2, 7, 16, generator=g) * 0.1,
         "text_mask": torch.ones(2, 7, dtype=torch.long)}
    return b


def test_fit_records_and_checkpoints(tmp_path):
    """After tests/test_dpo.py: an SFT-first epoch then a DPO epoch, both
    validated; best on improvement, no epoch checkpoint during SFT, epoch_1
    after it, last always; the reference UNet unchanged."""
    trainer, state, ref = _trainer(sft_first_epochs=1, num_train_epochs=2, save_every=1)
    ref_before = {k: v.clone() for k, v in ref.state_dict().items()}
    val = {"fbank": torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(7)) * 0.5,
           "text_embeds": _batch(0)["text_embeds"], "text_mask": _batch(0)["text_mask"]}
    recs = []
    trainer.fit(state, ref, lambda: iter([_batch(0)]), torch.Generator().manual_seed(2),
                str(tmp_path), val_batches=lambda: iter([val]), log_fn=recs.append)
    assert [r["phase"] for r in recs] == ["sft", "dpo"]
    assert all(np.isfinite(r["val_loss"]) and np.isfinite(r["loss"]) for r in recs)
    assert recs[0]["implicit_acc"] is None and 0.0 <= recs[1]["implicit_acc"] <= 1.0
    assert (tmp_path / "best").exists() and (tmp_path / "last").exists()
    assert not (tmp_path / "epoch_0").exists() and (tmp_path / "epoch_1").exists()
    assert len((tmp_path / "summary.jsonl").read_text().splitlines()) == 2
    assert state.opt_state.updates == 2
    last, _ = load_native(str(tmp_path / "last"))
    assert all(torch.equal(last[k], v) for k, v in state.params.state_dict().items())
    assert all(torch.equal(ref_before[k], v) for k, v in ref.state_dict().items())


def test_fit_max_train_steps_counts_updates(tmp_path):
    trainer, state, ref = _trainer(sft_first_epochs=0, num_train_epochs=3, max_train_steps=2)
    trainer.cfg = TC.DPOConfig(gradient_accumulation_steps=2, sft_first_epochs=0,
                               num_train_epochs=3, max_train_steps=1)
    recs = []
    trainer.fit(state, ref, lambda: iter([_batch(0), _batch(1), _batch(2)]),
                torch.Generator().manual_seed(2), str(tmp_path), log_fn=recs.append)
    assert len(recs) == 1 and state.step == 2 and recs[0]["val_loss"] is None
    assert (tmp_path / "last").exists() and not (tmp_path / "best").exists()


def test_sft_step_uses_the_winner_only():
    """Swapping the rejected audio changes nothing in the SFT-first step."""
    outs = []
    for seed in (5, 6):
        trainer, state, _ = _trainer()
        batch = _batch(0)
        batch["fbank_l"] = _batch(seed)["fbank_l"]
        state, loss = trainer.sft_step(state, batch, torch.Generator().manual_seed(3))
        outs.append((loss, {k: v.clone() for k, v in state.params.state_dict().items()}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(outs[0][1][k], outs[1][1][k]) for k in outs[0][1])


def test_schedule_is_linear_decay_without_warmup():
    import optax

    trainer, state, _ = _trainer()
    want = optax.linear_schedule(1e-4, 0.0, 4)
    for n in range(6):
        assert state.opt_state.schedule(n) == pytest.approx(float(want(n)), rel=1e-6, abs=1e-12)


# --------------------------------------------------------------------- CLI

JARGV = ["--train_file", "p.json", "--tango_snapshot", "s"]


@pytest.mark.parametrize("argv", [JARGV, JARGV + [
    "--validation_file", "v.json", "--learning_rate", "1e-5", "--beta_dpo", "500",
    "--num_train_epochs", "2", "--max_train_steps", "3", "--save_every", "1", "--prefix", "x ",
    "--num_examples", "4", "--sft_first_epochs", "0", "--per_device_train_batch_size", "2",
    "--gradient_accumulation_steps", "1", "--target_length", "64", "--seed", "3",
    "--with_tracking"]], ids=["defaults", "set"])
def test_parse_args_matches_jax(argv):
    want = vars(jdpo_cli.parse_args(argv))
    got = vars(dpo_cli.parse_args(argv))
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want


def _pref_manifest(root, n, name):
    import json

    rng = np.random.default_rng(len(name) + n)
    t = np.arange(16 * 160) / 16000.0
    rows = []
    for i in range(n):
        row = {"captions": f"caption {i}"}
        for side in ("chosen", "rejected"):
            path = f"{root}/{name}_{side}_{i}.wav"
            write_wav(path, (0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t)).astype(
                np.float32))
            row[side] = path
        rows.append(row)
    path = f"{root}/{name}.json"
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return path


def test_cli_on_snapshot_tiny(tmp_path):
    snap = str(GOLDEN / "snapshot_tiny")
    out = tmp_path / "out"
    state, ref = dpo_cli.main(
        ["--train_file", _pref_manifest(str(tmp_path), 4, "train"), "--validation_file",
         _pref_manifest(str(tmp_path), 1, "val"), "--tango_snapshot", snap, "--output_dir",
         str(out), "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "1",
         "--num_train_epochs", "2", "--sft_first_epochs", "1", "--target_length", "16",
         "--learning_rate", "1e-4", "--device", "cpu"], tokenizer=WordHashTokenizer(128))
    import json

    recs = [json.loads(x) for x in (out / "summary.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in recs] == ["sft", "dpo"]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["val_loss"]) for r in recs)
    assert 0.0 <= recs[1]["implicit_acc"] <= 1.0
    assert (out / "last").exists() and (out / "best").exists()
    start = load_tango_snapshot(snap)["unet_params"]
    assert all(torch.equal(v, start[k]) for k, v in ref.state_dict().items())
    assert any(not torch.equal(v, start[k]) for k, v in state.params.state_dict().items())
    assert state.opt_state.updates == 4


def test_cli_raises(tmp_path, monkeypatch):
    """What cannot run: in one process `--model_parallel 2` has no second
    rank, and torchrun's WORLD_SIZE needs its MASTER_ADDR (the mesh itself
    runs in tests/test_torch_parallel.py), and a hub name is no directory."""
    for var in ("JAX_COORDINATOR", "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--train_file", "p.json", "--tango_snapshot", str(GOLDEN / "snapshot_tiny"),
            "--device", "cpu"]
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        dpo_cli.main(argv + ["--model_parallel", "2"])
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        dpo_cli.main(argv)
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        dpo_cli.main(["--train_file", "p.json", "--tango_snapshot", "declare-lab/tango2",
                      "--device", "cpu"])
