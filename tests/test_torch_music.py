"""Mustango's music conditioning and triple-stream UNet in the port
(tango_tpu_torch/models/music.py, models/unet.py with extra streams,
models/diffusion.py) against the JAX package and the music_tiny golden, on
the CPU in f32. Tolerances are tests/test_music.py's: the conditioner 1e-5 /
1e-4, the UNet 3e-4 / 1e-3; the UNet against JAX on the same weights the
UNet parity tests' 2e-4 / 1e-3; the sampler 1e-4 / 1e-3 (tests/test_torch_pipeline.py's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu import configs as JC
from tango_tpu.models import music as jmusic
from tango_tpu.models.diffusion import AudioDiffusion as JAudioDiffusion
from tango_tpu.models.unet import UNet2DConditionModel as JUNet
from tango_tpu.utils import convert as jconv
from tango_tpu_torch import configs as TC
from tango_tpu_torch.models import music
from tango_tpu_torch.models.diffusion import AudioDiffusion
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.ops.quant import quantize_unet_
from tango_tpu_torch.utils import convert as conv

from tests._torch_helpers import random_jax_params
from tests.conftest import load_golden

torch.set_num_threads(1)

# tests/test_music.py's TINY_MUSIC_UNET
MUSIC_KW = dict(
    in_channels=8, out_channels=8,
    down_block_types=("CrossAttnDownBlock2DMusic", "DownBlock2D"),
    mid_block_type="UNetMidBlock2DCrossAttnMusic",
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2DMusic"),
    block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32,
    attention_head_dim=(2, 4), norm_num_groups=8,
)
PORT_CFG = TC.UNetConfig(**MUSIC_KW)
JAX_CFG = JC.UNetConfig(**MUSIC_KW)
# tests/test_music.py's small sampler geometry
LT, LF, BEAT_LEN, CHORD_LEN = 8, 4, 6, 4
BEATS = [[[0.5, 1.0, 1.5], [1.0, 2.0, 3.0]], [[], []]]
CHORDS, CHORD_TIMES = [["Gm", "Eb"], []], [[0.4, 1.2], []]


def t(a):
    return torch.from_numpy(np.asarray(a))


def golden_conditioner_sd(g):
    return {k[len("music::"):]: g[k] for k in g.files if k.startswith("music::")}


# ------------------------------------------------------------- tokenizers

CHORD_CASES = [
    (["Gm", "Eb"], [0.4, 1.2], 4),
    ([], [], 5),  # empty: one "N" chord at 0 s
    (["N"], [0.0], 3),
    (["Gm7/Bb", "F#dim", "Ebmaj7", "C#m7b5", "Abaug", "Db6", "B7", "E/G#"],
     [0.1, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 20),
    (["A", "Bbm6", "Cm", "Dbm"], [0.0, 1.0, 2.0, 3.0], 3),  # truncated
]
BEAT_CASES = [
    ([[0.5, 1.0, 1.5], [1.0, 2.0, 3.0]], 6),
    ([[], []], 5),
    ([[0.5, 1.0], [1.0, 5.0]], 4),
    ([[0.1 * i for i in range(1, 9)], [1.0, 2.0, 3.0, 4.0] * 2], 5),  # truncated
]


@pytest.mark.parametrize("chords,times,n", CHORD_CASES)
def test_tokenize_chords_matches_jax(chords, times, n):
    assert music.tokenize_chords(chords, times, n) == jmusic.tokenize_chords(chords, times, n)
    for c in chords:
        assert music.parse_chord(c) == jmusic.parse_chord(c)


@pytest.mark.parametrize("beats,n", BEAT_CASES)
def test_tokenize_beats_matches_jax(beats, n):
    assert music.tokenize_beats(beats, n) == jmusic.tokenize_beats(beats, n)


def test_batch_tokenizers_match_jax_and_beat_overflow_raises():
    for got, want in zip(music.batch_tokenize_beats(BEATS, BEAT_LEN),
                         jmusic.batch_tokenize_beats(BEATS, BEAT_LEN)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(music.batch_tokenize_chords(CHORDS, CHORD_TIMES, CHORD_LEN),
                         jmusic.batch_tokenize_chords(CHORDS, CHORD_TIMES, CHORD_LEN)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for bad in ([[0.5, 1.0], [1.0, 6.0]], [[0.5], [7.0]]):
        with pytest.raises(ValueError, match="one-hot"):
            music.tokenize_beats(bad, 4)
        with pytest.raises(ValueError, match="one-hot"):
            jmusic.tokenize_beats(bad, 4)


# ----------------------------------------------------------- conditioner

def test_fme_encode_matches_jax():
    vals = np.array([[0.0, 0.4, 1.2, 7.5, 13.0], [3.0, 9.99, 0.01, 2.5, 12.0]], np.float32)
    for d, base in ((32, 1.0), (32, 10001.0), (1024, 10001.0)):
        np.testing.assert_allclose(music.fme_encode(t(vals), d, base).numpy(),
                                   np.asarray(jmusic.fme_encode(jnp.asarray(vals), d, base)),
                                   atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def golden():
    return load_golden("music_tiny")


@pytest.fixture(scope="module")
def conditioner(golden):
    m = music.MusicConditioner(d_model=32)
    m.load_state_dict(music.convert_music_conditioner(
        {k: t(v) for k, v in golden_conditioner_sd(golden).items()}))
    return m.eval()


def test_conditioner_matches_golden(golden, conditioner):
    g = golden
    with torch.no_grad():
        beat_emb, chord_emb = conditioner(t(g["beats"]), t(g["beat_times"]), t(g["roots"]),
                                          t(g["ctypes"]), t(g["cinvs"]), t(g["ctimes"]))
    np.testing.assert_allclose(beat_emb.numpy(), g["beat_emb"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(chord_emb.numpy(), g["chord_emb"], atol=1e-5, rtol=1e-4)


def test_empty_sequence_embeddings_match_golden(golden, conditioner):
    """The CFG unconditional half: tokenized-empty beats and chords, embedded."""
    g = golden
    b_ids, b_times, b_mask = music.batch_tokenize_beats([[[], []]], seq_len=5)
    c_roots, c_types, c_invs, c_times, c_mask = music.batch_tokenize_chords([[]], [[]], seq_len=5)
    with torch.no_grad():
        beat_emb, chord_emb = conditioner(t(b_ids), t(b_times), t(c_roots), t(c_types),
                                          t(c_invs), t(c_times))
    np.testing.assert_array_equal(b_mask, g["unc_beat_mask"].astype(b_mask.dtype))
    np.testing.assert_array_equal(c_mask, g["unc_chord_mask"].astype(c_mask.dtype))
    np.testing.assert_allclose(beat_emb.numpy(), g["unc_beat_emb"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(chord_emb.numpy(), g["unc_chord_emb"], atol=1e-5, rtol=1e-5)


def test_conditioner_from_jax_params_matches_jax(golden):
    """The same weights through JAX's converter and from_jax_params."""
    jparams = jmusic.convert_music_conditioner(golden_conditioner_sd(golden))
    port = music.MusicConditioner(d_model=32)
    port.load_state_dict(conv.from_jax_params(jparams))
    got = music.convert_music_conditioner(
        {k: t(v) for k, v in golden_conditioner_sd(golden).items()})
    assert all(torch.equal(port.state_dict()[k], v) for k, v in got.items())


# ------------------------------------------------------------------ UNet

def test_music_config_normalization_matches_jax():
    assert PORT_CFG.extra_cond_streams == 2 and PORT_CFG.extra_cond_dims == (32, 32)
    assert PORT_CFG.down_block_types == ("CrossAttnDownBlock2D", "DownBlock2D")
    assert PORT_CFG.mid_block_type == "UNetMidBlock2DCrossAttn"
    assert PORT_CFG == TC.UNetConfig.from_dict(JAX_CFG.to_dict())
    with pytest.raises(ValueError, match="extra streams"):
        TC.UNetConfig(extra_cond_streams=2)


def _port_unet(sd):
    unet = UNet2DConditionModel(PORT_CFG)
    unet.load_state_dict(sd)
    return unet.eval()


def test_music_unet_matches_golden(golden):
    g = golden
    sd = {k[4:]: t(g[k]) for k in g.files if k.startswith("sd::")}
    unet = _port_unet(conv.convert_unet(sd))
    x = t(g["x"]).permute(0, 2, 3, 1)
    with torch.no_grad():
        out = unet(x, t(g["t"]), [t(g["text"]), t(g["beat_emb"]).repeat(2, 1, 1),
                                  t(g["chord_emb"]).repeat(2, 1, 1)],
                   [t(g["tmask"]), t(g["bmask"]), t(g["cmask"])])
    np.testing.assert_allclose(out.permute(0, 3, 1, 2).numpy(), g["out"], atol=3e-4, rtol=1e-3)


def test_convert_unet_streams_match_jax(golden):
    """attentions2 / attentions3 keys -> the _extra1 / _extra2 streams, equal
    to JAX's converter through from_jax_params, and exported back bit-equal."""
    from tango_tpu_torch.utils.export import export_unet

    g = golden
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    assert any(".attentions2." in k for k in sd) and any(".attentions3." in k for k in sd)
    got = conv.convert_unet({k: t(v) for k, v in sd.items()})
    want = conv.from_jax_params(jconv.convert_unet(sd))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert any("attentions_0_extra2." in k for k in got)
    back = export_unet(got)
    assert set(back) == set(sd) and all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)


@pytest.fixture(scope="module")
def jax_unet_params():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, 32, 8, 8).astype(np.float32))
    ctxs = [jnp.zeros((2, n, 32)) for n in (7, BEAT_LEN, CHORD_LEN)]
    model = JUNet(JAX_CFG)
    return random_jax_params(
        lambda k: model.init(k, x, jnp.zeros((2,), jnp.int32), ctxs)["params"], 0)


def test_music_unet_matches_jax(jax_unet_params):
    """Random weights, a padded mask in every stream, a 32 x 8 latent (256
    tokens at level 0, the kernel's path for self-attention)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 8, 8).astype(np.float32)
    steps = np.array([10, 700], np.int64)
    ctxs = [rng.randn(2, n, 32).astype(np.float32) for n in (7, BEAT_LEN, CHORD_LEN)]
    masks = [np.ones((2, n), np.int64) for n in (7, BEAT_LEN, CHORD_LEN)]
    masks[0][1, 4:] = masks[1][0, 3:] = masks[2][1, 1:] = 0
    masks[1][1] = 0  # an all-padding beat row: uniform attention, no NaN
    ref = jax.jit(JUNet(JAX_CFG).apply)(
        {"params": jax_unet_params}, jnp.asarray(x), jnp.asarray(steps),
        [jnp.asarray(c) for c in ctxs], encoder_attention_mask=[jnp.asarray(m) for m in masks])
    unet = _port_unet(conv.from_jax_params(jax_unet_params))
    assert isinstance(unet.mid_block.attentions_0_extra2.transformer_blocks_0.attn2.to_kv,
                      torch.nn.Linear)
    with torch.no_grad():
        out = unet(t(x), t(steps), [t(c) for c in ctxs], [t(m) for m in masks])
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)
    # one mask (here None) goes to every stream, as in JAX (unmasked, the
    # level-0 cross-attention may take the kernel's route: f32 rounding)
    with torch.no_grad():
        out1 = unet(t(x), t(steps), [t(c) for c in ctxs], None)
        ones = unet(t(x), t(steps), [t(c) for c in ctxs], [torch.ones_like(t(m)) for m in masks])
    torch.testing.assert_close(out1, ones, atol=1e-5, rtol=1e-5)
    # the stream count is asserted, as in JAX
    with pytest.raises(AssertionError):
        unet(t(x), t(steps), t(ctxs[0]), t(masks[0]))


# --------------------------------------------------------------- diffusion

def _diffusions(jax_unet_params, **kw):
    jd = jmusic.MusicAudioDiffusion(unet_config=JAX_CFG, latent_t_size=LT, latent_f_size=LF,
                                    d_music=32, beat_len=BEAT_LEN, chord_len=CHORD_LEN, **kw)
    unet = _port_unet(conv.from_jax_params(jax_unet_params))
    pd = music.MusicAudioDiffusion(unet, latent_t_size=LT, latent_f_size=LF, d_music=32,
                                   beat_len=BEAT_LEN, chord_len=CHORD_LEN, **kw)
    cparams = random_jax_params(jd.init_conditioner_params, 5)
    pd.conditioner.load_state_dict(conv.from_jax_params(cparams))
    pd.conditioner.eval()
    return jd, pd, cparams


def test_encode_music_matches_jax(jax_unet_params):
    jd, pd, cparams = _diffusions(jax_unet_params)
    want = jd.encode_music(cparams, BEATS, CHORDS, CHORD_TIMES)
    with torch.no_grad():
        got = pd.encode_music(BEATS, CHORDS, CHORD_TIMES)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-5, rtol=1e-4)


def test_music_loss_matches_jax(jax_unet_params):
    """The same timesteps, noise and drop (drawn as JAX's loss draws them
    from its key), uncondition on, validation mode off."""
    jd, pd, cparams = _diffusions(jax_unet_params, uncondition=True)
    b = 4
    rng = np.random.RandomState(2)
    lat = rng.randn(b, LT, LF, 8).astype(np.float32)
    text = rng.randn(b, 5, 32).astype(np.float32)
    tmask = np.ones((b, 5), np.int64)
    beats, chords, times = BEATS * 2, CHORDS * 2, CHORD_TIMES * 2
    key = next(jax.random.PRNGKey(s) for s in range(100)
               if 0 < int((jax.random.uniform(jax.random.split(jax.random.PRNGKey(s), 3)[2],
                                              (b, 1, 1)) < 0.1).sum()) < b)
    k_t, k_noise, k_unc = jax.random.split(key, 3)
    steps = np.asarray(jax.random.randint(k_t, (b,), 0, 1000))
    noise = np.asarray(jax.random.normal(k_noise, lat.shape, jnp.float32))
    drop = np.asarray(jax.random.uniform(k_unc, (b, 1, 1)) < 0.1)[:, 0, 0]
    jb, jbm, jc, jcm = jd.encode_music(cparams, beats, chords, times)
    want = jax.jit(jd.music_loss)(jax_unet_params, cparams, jnp.asarray(lat), jnp.asarray(text),
                                  jnp.asarray(tmask), key, jb, jbm, jc, jcm)
    with torch.no_grad():
        pb, pbm, pc, pcm = pd.encode_music(beats, chords, times)
        got = pd.music_loss(t(lat), t(text), t(tmask), None, pb, pbm, pc, pcm,
                            timesteps=t(steps), noise=t(noise), drop=t(drop))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_loss_drop_zeroes_every_stream_of_the_same_samples():
    """Mustango's dropout zeroes text, beats and chords of the same samples."""
    captured = {}

    class Stub(torch.nn.Module):
        cfg = PORT_CFG

        def __init__(self):
            super().__init__()
            self.conv_in = torch.nn.Conv2d(8, 8, 1)

        def forward(self, noisy, steps, contexts, masks):
            captured["contexts"], captured["masks"] = contexts, masks
            return torch.zeros_like(noisy)

    diff = AudioDiffusion(Stub(), uncondition=True, latent_t_size=LT, latent_f_size=LF)
    b = 256
    ctxs = [torch.ones(b, n, 16) for n in (4, 5, 3)]
    masks = [torch.ones(b, n, dtype=torch.long) for n in (4, 5, 3)]
    diff.loss(torch.zeros(b, LT, LF, 8), ctxs[0], masks[0], torch.Generator().manual_seed(0),
              extra_contexts=ctxs[1:], extra_masks=masks[1:])
    dropped = [~c.any(dim=(1, 2)) for c in captured["contexts"]]
    assert 0.02 < dropped[0].float().mean() < 0.25
    assert torch.equal(dropped[0], dropped[1]) and torch.equal(dropped[0], dropped[2])
    assert all(torch.equal(m, w) for m, w in zip(captured["masks"], masks))
    with pytest.raises(AssertionError, match="extra_masks"):
        diff.loss(torch.zeros(2, LT, LF, 8), ctxs[0][:2], masks[0][:2], None,
                  extra_contexts=ctxs[1:])


@pytest.mark.parametrize("with_conditioner", [True, False])
def test_music_sample_matches_jax(jax_unet_params, with_conditioner):
    """music_sample in both packages under one noise_override: with the
    conditioner (JAX's cond_params) the unconditional half embeds empty
    beats and chords; without it, zeros under the conditional masks."""
    jd, pd, cparams = _diffusions(jax_unet_params)
    steps = 2
    rng = np.random.RandomState(3)
    init = rng.randn(2, LT, LF, 8).astype(np.float32)
    noises = rng.randn(steps, 2, LT, LF, 8).astype(np.float32)
    text = rng.randn(2, 5, 32).astype(np.float32)
    tmask = np.ones((2, 5), np.int64)
    tmask[1, 3:] = 0
    unc = np.zeros_like(text)
    jd.sample = lambda *a, **k: JAudioDiffusion.sample(jd, *a, noise_override=(init, noises), **k)
    jb, jbm, jc, jcm = jd.encode_music(cparams, BEATS, CHORDS, CHORD_TIMES)
    want = jd.music_sample(jax_unet_params, jnp.asarray(text), jnp.asarray(tmask),
                           jax.random.PRNGKey(0), jb, jbm, jc, jcm, num_steps=steps,
                           guidance_scale=3.0, uncond_embeds=jnp.asarray(unc),
                           uncond_mask=jnp.asarray(tmask),
                           cond_params=cparams if with_conditioner else None)
    pb, pbm, pc, pcm = pd.encode_music(BEATS, CHORDS, CHORD_TIMES)
    got = pd.music_sample(t(text), t(tmask), None, pb, pbm, pc, pcm, num_steps=steps,
                          guidance_scale=3.0, uncond_embeds=t(unc), uncond_mask=t(tmask),
                          conditioner=pd.conditioner if with_conditioner else None,
                          noise_override=(t(init), t(noises)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)


def test_music_sample_int8_conv_close_to_f32(jax_unet_params):
    """quant="conv" on the music UNet samples within quantization noise of
    f32: tests/test_music.py's bound, the same order as bf16's error."""
    _, pd, _ = _diffusions(jax_unet_params)
    steps = 4
    rng = np.random.RandomState(4)
    text = t(rng.randn(2, 5, 32).astype(np.float32))
    tmask = torch.ones(2, 5, dtype=torch.long)
    init = t(rng.randn(2, LT, LF, 8).astype(np.float32))
    noises = t(rng.randn(steps, 2, LT, LF, 8).astype(np.float32))
    feats = pd.encode_music(BEATS, CHORDS, CHORD_TIMES)

    def run(diff, cast=torch.float32):
        return diff.music_sample(text.to(cast), tmask, None, *(f.to(cast) if f.is_floating_point()
                                                              else f for f in feats),
                                 num_steps=steps, guidance_scale=3.0,
                                 uncond_embeds=torch.zeros_like(text).to(cast),
                                 uncond_mask=tmask, conditioner=pd.conditioner,
                                 noise_override=(init, noises)).float()

    out_f = run(pd)
    qunet = _port_unet(pd.unet.state_dict())
    quantize_unet_(qunet, "conv")
    qunet.cfg = dataclasses.replace(PORT_CFG, quant_int8=True, quant_scope="conv")
    qd = music.MusicAudioDiffusion(qunet, latent_t_size=LT, latent_f_size=LF, d_music=32,
                                   beat_len=BEAT_LEN, chord_len=CHORD_LEN,
                                   conditioner=pd.conditioner)
    out_q = run(qd)
    bunet = _port_unet(pd.unet.state_dict()).to(torch.bfloat16)
    bd = music.MusicAudioDiffusion(bunet, latent_t_size=LT, latent_f_size=LF, d_music=32,
                                   beat_len=BEAT_LEN, chord_len=CHORD_LEN,
                                   conditioner=pd.conditioner)
    out_b = run(bd, torch.bfloat16)
    err_q = float((out_q - out_f).norm() / out_f.norm())
    err_b = float((out_b - out_f).norm() / out_f.norm())
    assert torch.isfinite(out_q).all()
    assert err_q < max(8 * err_b, 0.08), (err_q, err_b)
    assert sum(p.dtype == torch.int8 for p in qunet.state_dict().values()) >= 5
