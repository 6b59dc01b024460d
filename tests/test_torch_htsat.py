"""The port's HTSAT, CLAP's audio tower (tango_tpu_torch/models/htsat.py),
against the JAX package's on the CPU and against the reference golden
`htsat_tiny` (tests/test_htsat.py's TINY_HTSAT: 64x64 image, embed 24,
depths (1, 1), window 4), stage by stage and then whole, at the JAX test's
3e-4 / 1e-3. The golden's blocks are unshifted; a shifted block (window 4,
shift 2 on 16 x 16 tokens) runs on random weights against JAX's."""

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.models import htsat as J
from tango_tpu_torch.models import htsat as P
from tango_tpu_torch.utils.convert import from_jax_params

from tests._torch_helpers import random_jax_params, tiny_clap_configs
from tests.conftest import load_golden
from tests.test_htsat import TINY_HTSAT as J_TINY

torch.set_num_threads(1)

TINY = tiny_clap_configs()[1]
TOL = dict(atol=3e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def golden():
    g = load_golden("htsat_tiny")
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    jparams = J.convert_htsat(sd, J_TINY, prefix="audio_branch.")
    model = P.HTSAT(TINY)
    model.load_state_dict(P.convert_htsat(sd, TINY, prefix="audio_branch."))
    return g, sd, jparams, model.eval()


def _assert_same_state(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k


def test_numpy_helpers_equal_jax():
    for n_in, n_out in ((12, 30), (120, 256), (16, 16), (1001, 1024)):
        np.testing.assert_array_equal(P.bicubic_matrix_align_corners(n_in, n_out),
                                      J.bicubic_matrix_align_corners(n_in, n_out))
    for w in (4, 8):
        np.testing.assert_array_equal(P.relative_position_index(w), J.relative_position_index(w))
    for args in ((16, 16, 4, 2), (64, 64, 8, 4), (8, 8, 8, 0)):
        a, b = P.shift_attn_mask(*args), J.shift_attn_mask(*args)
        assert (a is None and b is None) or np.array_equal(a, b)


def test_bicubic_matrix_matches_torch():
    x = torch.arange(12, dtype=torch.float32).reshape(1, 1, 12, 1)
    x[0, 0, 5] = -3.0
    ref = torch.nn.functional.interpolate(x, (30, 1), mode="bicubic", align_corners=True)
    out = P.bicubic_matrix_align_corners(12, 30) @ x[0, 0, :, 0].numpy()
    np.testing.assert_allclose(out, ref[0, 0, :, 0].numpy(), atol=1e-5)


def test_window_partition_roundtrip_matches_jax():
    x = np.random.RandomState(0).randn(2, 16, 16, 6).astype(np.float32)
    ours = P.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(J.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(P.window_reverse(ours, 4, 16, 16).numpy(), x)


def test_converter_bit_equal_to_from_jax_params(golden):
    _, sd, jparams, _ = golden
    _assert_same_state(P.convert_htsat(sd, TINY, prefix="audio_branch."),
                       from_jax_params(jparams))
    _assert_same_state(P.convert_clap_audio(sd, TINY), from_jax_params(
        J.convert_clap_audio(sd, J_TINY)))


def test_bn0_and_fold_match_jax_and_golden(golden):
    """bn0 over the mel bins, then the bicubic resize and the fold into the
    (stacked frequency, time) image: against the golden's `folded`."""
    g, _, jparams, model = golden
    logmel = g["logmel"][:, 0]  # (B, T, mel)
    with torch.no_grad():
        x = model.bn0(torch.from_numpy(logmel), dim=2)
        folded = model.reshape_wav2img(x)
    jx = J.BatchNormEval(TINY.mel_bins).apply({"params": jparams["bn0"]},
                                              logmel[:, :, None, :])[:, :, 0, :]
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    jfold = J.HTSAT(J_TINY).apply({"params": jparams}, jx, method=J.HTSAT.reshape_wav2img)
    np.testing.assert_allclose(folded.numpy(), np.asarray(jfold).transpose(0, 3, 1, 2), **TOL)
    np.testing.assert_allclose(folded.numpy(), g["folded"], **TOL)


def _tokens(model, logmel):
    """The patch embedding's tokens (B, gh * gw, C)."""
    with torch.no_grad():
        x = model.reshape_wav2img(model.bn0(torch.from_numpy(logmel), dim=2))
        return model.patch_norm(model.patch_proj(x).flatten(2).transpose(1, 2))


def test_stages_match_jax(golden):
    """The patch embedding, the Swin block and the patch merging, each on
    the same input in both packages."""
    g, _, jparams, model = golden
    logmel = g["logmel"][:, 0]
    tokens = _tokens(model, logmel)
    with torch.no_grad():
        img = model.reshape_wav2img(model.bn0(torch.from_numpy(logmel), dim=2))
    conv = np.asarray(nn.Conv(24, (4, 4), strides=(4, 4), padding=0).apply(
        {"params": jparams["patch_proj"]}, img.numpy().transpose(0, 2, 3, 1)))
    jtok = nn.LayerNorm(epsilon=1e-5).apply({"params": jparams["patch_norm"]},
                                            conv.reshape(2, -1, 24))
    np.testing.assert_allclose(tokens.numpy(), np.asarray(jtok), **TOL)

    x = tokens.numpy()
    blk = J.SwinBlock(24, (16, 16), 2, 4, 0)
    with torch.no_grad():
        ours = model.layer_0_block_0(tokens)
    theirs = blk.apply({"params": jparams["layer_0_block_0"]}, x)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)

    with torch.no_grad():
        merged = model.layer_0_downsample(ours)
    jmerged = J.PatchMerging((16, 16)).apply({"params": jparams["layer_0_downsample"]},
                                            np.asarray(theirs))
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged), **TOL)


def test_shifted_block_matches_jax():
    """A shifted-window block (the -100 masks and the rolls) on random weights."""
    dim, res, heads, window, shift = 24, (16, 16), 2, 4, 2
    blk = J.SwinBlock(dim, res, heads, window, shift)
    x = np.random.RandomState(0).randn(2, 256, dim).astype(np.float32)
    params = random_jax_params(lambda k: blk.init(k, x)["params"], seed=3)
    ours = P.SwinBlock(dim, res, heads, window, shift)
    ours.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(blk.apply({"params": params}, x)), **TOL)
    assert ours.shift == shift and P.shift_attn_mask(16, 16, window, shift) is not None


def test_trunk_matches_jax_and_golden(golden):
    g, _, jparams, model = golden
    logmel = g["logmel"][:, 0]
    with torch.no_grad():
        out = model(torch.from_numpy(logmel))
    jout = J.HTSAT(J_TINY).apply({"params": jparams}, logmel)
    for key, gkey in (("embedding", "embedding"), ("clipwise_output", "clipwise")):
        np.testing.assert_allclose(out[key].numpy(), g[gkey], **TOL)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), **TOL)
    np.testing.assert_allclose(out["latent_map"].numpy(), np.asarray(jout["latent_map"]), **TOL)


def test_clap_audio_encoder_matches_jax_and_golden(golden):
    g, sd, _, _ = golden
    model = P.ClapAudioEncoder(TINY)
    model.load_state_dict(P.convert_clap_audio(sd, TINY))
    logmel = g["logmel"][:, 0]
    with torch.no_grad():
        emb = model(torch.from_numpy(logmel)).numpy()
    jemb = J.ClapAudioEncoder(J_TINY).apply({"params": J.convert_clap_audio(sd, J_TINY)}, logmel)
    np.testing.assert_allclose(emb, g["proj_emb"], **TOL)
    np.testing.assert_allclose(emb, np.asarray(jemb), **TOL)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("cfg", ["tiny", "htsat_tiny"])
def test_clap_logmel_matches_jax(cfg):
    pc, jc = (TINY, J_TINY) if cfg == "tiny" else (P.HTSAT_TINY, J.HTSAT_TINY)
    wav = np.random.RandomState(2).randn(2, pc.sample_rate // 2).astype(np.float32) * 0.1
    ours = P.clap_logmel(torch.from_numpy(wav), pc).numpy()
    theirs = np.asarray(J.clap_logmel(jnp.asarray(wav), jc))
    assert ours.shape == theirs.shape == (2, 1 + wav.shape[1] // pc.hop_size, pc.mel_bins)
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_clap_logmel_full_clip_shape():
    assert P.clap_logmel(torch.zeros(1, 480000)).shape == (1, 1001, 64)


def test_fold_rejects_too_long_input():
    with pytest.raises(ValueError, match="exceeds"):
        P.HTSAT(TINY).reshape_wav2img(torch.zeros(1, 300, 16))


def test_init_random_sets_every_scorer_tensor():
    """utils.init.init_random_ (the smoke's seeded full-width scorers) sets
    every parameter and buffer of the CLAP towers, Cnn14 and VGGish: the
    BatchNorm statistics to (0, 1), the Swin bias tables to std 0.02."""
    from tango_tpu_torch.eval.panns import Cnn14
    from tango_tpu_torch.eval.vggish import VGGish
    from tango_tpu_torch.models.clap import ClapTextEncoder
    from tango_tpu_torch.utils.init import init_random_
    from tests._torch_helpers import tiny_clap_configs

    text, _ = tiny_clap_configs()
    for make in (lambda: P.ClapAudioEncoder(TINY), lambda: ClapTextEncoder(text), Cnn14, VGGish):
        with torch.device("meta"):
            m = make()
        m = m.to_empty(device="cpu")
        for t in m.state_dict().values():
            t.fill_(float("nan"))
        sd = init_random_(m, torch.Generator().manual_seed(0)).state_dict()
        assert all(bool(torch.isfinite(t).all()) for t in sd.values())
        for k, t in sd.items():
            if k.endswith(".var"):
                assert bool((t == 1).all())
            if k.endswith("relative_position_bias_table"):
                assert 0.01 < float(t.std()) < 0.03
