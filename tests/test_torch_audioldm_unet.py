"""AudioLDM's FiLM UNet in the port (tango_tpu_torch/models/audioldm_unet.py)
against JAX's FilmUNet on the same parameters, and against the film_unet_tiny
golden through convert_film_unet, on the CPU in f32. Tolerances: the UNet
parity tests' 2e-4 / 1e-3 (tests/test_music.py:158 for the golden)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.models import audioldm_unet as jfilm
from tango_tpu_torch.models import audioldm_unet as film
from tango_tpu_torch.utils import convert as conv

from tests._torch_helpers import random_jax_params
from tests.conftest import load_golden

torch.set_num_threads(1)

# tests/test_audioldm.py's TINY_FILM_UNET
TINY_KW = dict(in_channels=8, out_channels=8, model_channels=32, num_res_blocks=1,
               attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=16,
               extra_film_condition_dim=32, extra_film_use_concat=True)
# the golden's geometry (tests/test_music.py:149)
GOLDEN_KW = dict(image_size=16, in_channels=4, out_channels=4, model_channels=32,
                 num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                 num_head_channels=16, extra_film_condition_dim=16, extra_film_use_concat=True)
LT, LF = 8, 4


def jax_unet(kw):
    cfg = jfilm.FilmUNetConfig(**kw)
    model = jfilm.FilmUNet(cfg)
    fd = kw["extra_film_condition_dim"] or 1
    params = random_jax_params(lambda k: model.init(
        k, jnp.zeros((1, LT, LF, kw["in_channels"])), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, fd)))["params"], seed=3)
    return model, params


def port_unet(kw, params):
    m = film.FilmUNet(film.FilmUNetConfig(**kw))
    m.load_state_dict(conv.from_jax_params(params))
    return m.eval()


@pytest.mark.parametrize("scale_shift", [False, True])
@pytest.mark.parametrize("concat", [True, False])
def test_film_unet_matches_jax(scale_shift, concat):
    kw = {**TINY_KW, "use_scale_shift_norm": scale_shift, "extra_film_use_concat": concat}
    jm, params = jax_unet(kw)
    pm = port_unet(kw, params)
    rng = np.random.RandomState(0)
    x = rng.randn(2, LT, LF, 8).astype(np.float32)
    t = np.array([999, 17], np.int32)  # distinct timesteps a row
    f = rng.randn(2, 32).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, x, t, f))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_film_unet_scalar_timestep_and_missing_film():
    kw = dict(TINY_KW)
    jm, params = jax_unet(kw)
    pm = port_unet(kw, params)
    rng = np.random.RandomState(1)
    x = rng.randn(2, LT, LF, 8).astype(np.float32)
    f = rng.randn(2, 32).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, x, jnp.asarray(500), f))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.tensor(500), torch.from_numpy(f)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
        with pytest.raises(ValueError, match="FiLM condition"):
            pm(torch.from_numpy(x), torch.tensor(500))


def test_film_unet_golden_through_convert():
    g = load_golden("film_unet_tiny")
    cfg = film.FilmUNetConfig(**GOLDEN_KW)
    sd = {k[4:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("sd::")}
    m = film.FilmUNet(cfg)
    m.load_state_dict(film.convert_film_unet(sd, cfg))
    x = torch.from_numpy(g["x"]).permute(0, 2, 3, 1)  # the golden is NCHW
    with torch.no_grad():
        out = m.eval()(x, torch.from_numpy(g["t"]), torch.from_numpy(g["film"]))
    np.testing.assert_allclose(out.permute(0, 3, 1, 2).numpy(), g["out"], atol=2e-4, rtol=1e-3)


def test_convert_film_unet_matches_jax_converter():
    """The port's converter and JAX's give the same weights (through
    from_jax_params), key for key and bit for bit."""
    g = load_golden("film_unet_tiny")
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    ours = film.convert_film_unet({k: torch.from_numpy(v) for k, v in sd.items()},
                                  film.FilmUNetConfig(**GOLDEN_KW))
    theirs = conv.from_jax_params(jfilm.convert_film_unet(sd, jfilm.FilmUNetConfig(**GOLDEN_KW)))
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


def test_config_from_dict_matches_jax():
    d = dataclasses.asdict(jfilm.AUDIOLDM_S_UNET)
    assert film.FilmUNetConfig.from_dict({**d, "unknown": 1}) == film.AUDIOLDM_S_UNET
    assert film.AUDIOLDM_S_UNET.to_dict() == d


@pytest.mark.parametrize("dim", [7, 8, 32])
def test_openai_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 17, 999], np.int32)
    want = np.asarray(jfilm.openai_timestep_embedding(jnp.asarray(t), dim))
    got = film.openai_timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == want.shape == (4, dim)
    # sin and cos of arguments near 1000 in f32 (one ulp 6e-5): XLA's and
    # torch's implementations round differently, by a few 1e-6
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    if dim % 2:
        assert (got[:, -1] == 0).all()


def test_full_width_parameter_count():
    """AUDIOLDM_S_UNET's parameter count is JAX's (jax.eval_shape of FilmUNet)."""
    jm = jfilm.FilmUNet(jfilm.AUDIOLDM_S_UNET)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 16, 16, 8)),
                                              jnp.zeros((1,), jnp.int32),
                                              jnp.zeros((1, 512)))["params"],
                            jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        pm = film.FilmUNet(film.AUDIOLDM_S_UNET)
    assert sum(p.numel() for p in pm.parameters()) == n_jax == 185_036_552
