"""The port's Tango API against JAX's: `Tango.__init__`, `from_components`,
`generate` and `generate_for_batch` take JAX's parameters, by name, order,
kind and default, so a call written for one package means the same in the
other. Left out of the comparison: the port's own additions (`device`,
`init_seed`, and `max_text_length` where JAX's `from_components` lacks it);
`mesh` stands where JAX's does. `from_components`'
`unet_params` and `vae_params` default to None in the port, where JAX
requires them: None draws seeded random weights on the device. Also
`AudioDiffusion.sample` (JAX's `unet_params` and `rng` aside) and AudioLDM's
entry points (`AudioLDMPipeline.from_checkpoint`, with the port's `device`
last, `text_to_audio`, `style_transfer`, `super_resolution_and_inpainting`).
"""

import inspect

import pytest

from tango_tpu.pipeline import Tango as JTango
from tango_tpu_torch.pipeline import Tango

from tests.test_torch_pipeline import UNET_KW, VAE_KW

PORT_ONLY = {"device", "init_seed"}
JAX_ONLY = set()
# the port's defaults where JAX has none, and why
PORT_DEFAULTS = {("from_components", "unet_params"): None,
                 ("from_components", "vae_params"): None}


def _params(fn, method, side):
    params = list(inspect.signature(fn).parameters.values())
    if params and params[0].name in ("self", "cls"):
        params = params[1:]
    drop = PORT_ONLY if side == "port" else JAX_ONLY
    out = []
    for p in params:
        if p.name in drop:
            continue
        if side == "port" and (method, p.name) in PORT_DEFAULTS:
            p = p.replace(default=inspect.Parameter.empty)
        out.append(p)
    return out


def _methods():
    return [("__init__", JTango.__init__, Tango.__init__),
            ("from_components", JTango.from_components.__func__,
             Tango.from_components.__func__),
            ("generate", JTango.generate, Tango.generate),
            ("generate_for_batch", JTango.generate_for_batch, Tango.generate_for_batch)]


@pytest.mark.parametrize("method,jfn,pfn", _methods(), ids=[m[0] for m in _methods()])
def test_signature_matches_jax(method, jfn, pfn):
    want = _params(jfn, method, "jax")
    got = _params(pfn, method, "port")
    if method == "from_components":
        # JAX builds with the default text length; the port lets a caller set it
        got = [p for p in got if p.name != "max_text_length"]
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        assert g.kind == w.kind, g.name
        assert g.default == w.default, (g.name, g.default, w.default)
    for (m, name), default in PORT_DEFAULTS.items():
        if m == method:
            assert inspect.signature(pfn).parameters[name].default is default


@pytest.mark.parametrize("method,args", [
    ("generate", ("a dog barks", 100, 3.0, 1, True)),
    ("generate", ("a dog barks", 50, 2.0, 2, False, 7)),
    ("generate_for_batch", (["a", "b"], 100, 3.0, 1, 4, True, 5)),
])
def test_positional_calls_bind_alike(method, args):
    """A positional call binds every argument to the same parameter in both
    packages: `generate(p, 100, 3.0, 1, True)` sets disable_progress, not seed."""
    jb = inspect.signature(getattr(JTango, method)).bind(None, *args).arguments
    pb = inspect.signature(getattr(Tango, method)).bind(None, *args).arguments
    assert list(pb) == list(jb)
    assert pb == jb
    assert pb.get("seed") in (None, 5, 7) and pb.get("disable_progress") in (True, False)


def test_init_positional_dtype_and_from_components_stft():
    """`Tango(None, tok, dtype)` sets the dtype in both, and `from_components`
    keeps `stft_config`."""
    import torch

    from tango_tpu_torch import configs as TC

    t = Tango(None, None, torch.float64, device="cpu")
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    stft = TC.StftConfig(hop_length=80)
    unet, vae = TC.UNetConfig(**UNET_KW), TC.VAEConfig(**VAE_KW)
    built = Tango.from_components(unet_config=unet, vae_config=vae, stft_config=stft,
                                  device="cpu")
    assert built.stft_config == stft
    assert Tango.from_components(unet_config=unet, vae_config=vae,
                                 device="cpu").stft_config == TC.TANGO_STFT
    assert inspect.signature(Tango.generate).parameters["disable_progress"].default is True


# ------------------------------------------------ AudioDiffusion and AudioLDM

def _names_kinds_defaults(fn, drop=()):
    params = [p for p in inspect.signature(fn).parameters.values()
              if p.name not in ("self", "cls") and p.name not in drop]
    return [(p.name, p.kind, p.default) for p in params]


def test_sample_signature_matches_jax():
    """AudioDiffusion.sample takes JAX's parameters in JAX's order
    (`scheduler` and `eta` after `uncond_mask`); JAX's `unet_params` and
    `rng` are the port's module and `generator`."""
    from tango_tpu.models.diffusion import AudioDiffusion as JAudioDiffusion
    from tango_tpu_torch.models.diffusion import AudioDiffusion

    want = _names_kinds_defaults(JAudioDiffusion.sample, drop=("unet_params", "rng"))
    got = _names_kinds_defaults(AudioDiffusion.sample, drop=("generator",))
    assert got == want
    names = list(inspect.signature(AudioDiffusion.sample).parameters)
    assert names.index("generator") == 3  # where JAX takes rng


@pytest.mark.parametrize("name", ["text_to_audio", "style_transfer",
                                  "super_resolution_and_inpainting", "build_model",
                                  "stochastic_encode_timesteps", "duration_to_latent_t_size"])
def test_audioldm_functions_match_jax(name):
    from tango_tpu.audioldm import pipeline as jpl
    from tango_tpu_torch.audioldm import pipeline as pl

    assert _names_kinds_defaults(getattr(pl, name)) == _names_kinds_defaults(getattr(jpl, name))


def test_audioldm_from_checkpoint_matches_jax():
    """JAX's parameters in its order, `device` (the port's own) last; the
    dtype default is f32 in both."""
    import jax.numpy as jnp
    import torch

    from tango_tpu.audioldm.pipeline import AudioLDMPipeline as JPipe
    from tango_tpu_torch.audioldm.pipeline import AudioLDMPipeline

    want = _names_kinds_defaults(JPipe.from_checkpoint.__func__)
    got = _names_kinds_defaults(AudioLDMPipeline.from_checkpoint.__func__)
    assert got[-1][0] == "device" and got[-1][2] is None
    got = got[:-1]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for (n, _, g), (_, _, w) in zip(got, want):
        if n == "dtype":
            assert g is torch.float32 and w is jnp.float32
        elif n == "unet_config":
            assert g.to_dict() == w.to_dict()
        else:
            assert g == w, n


@pytest.mark.parametrize("which", ["UNet2DConditionModel", "AudioDiffusion"])
def test_model_constructor_fields_match_jax(which):
    """The UNet's and AudioDiffusion's constructor fields are JAX's, by name,
    order and default, `latent_sharder` (sequence parallelism) included.
    Left out: Flax's `parent` and `name`; the UNet's `dtype` (the port's
    module takes its dtype by `.to`); AudioDiffusion's `device` (the port's
    own, last). AudioDiffusion's `unet` is JAX's `unet_config` (the port
    also takes a built module there); both dtypes default to float32."""
    import jax.numpy as jnp
    import torch

    from tango_tpu.models.diffusion import AudioDiffusion as JAudioDiffusion
    from tango_tpu.models.unet import UNet2DConditionModel as JUNet
    from tango_tpu_torch.models.diffusion import AudioDiffusion
    from tango_tpu_torch.models.unet import UNet2DConditionModel

    if which == "UNet2DConditionModel":
        want = _names_kinds_defaults(JUNet, drop=("parent", "name", "dtype"))
        got = _names_kinds_defaults(UNet2DConditionModel.__init__)
    else:
        want = _names_kinds_defaults(JAudioDiffusion)
        got = _names_kinds_defaults(AudioDiffusion)
        assert got[-1][0] == "device" and got[-1][2] is None
        assert got[0][0] == "unet" and want[0][0] == "unet_config"
        got, want = got[1:-1], want[1:]
        dtypes = [(g[2], w[2]) for g, w in zip(got, want) if g[0] == "dtype"]
        assert dtypes == [(torch.float32, jnp.float32)]
        got = [g for g in got if g[0] != "dtype"]
        want = [w for w in want if w[0] != "dtype"]
    assert got == want
    assert got[-1][0] == "latent_sharder" and got[-1][2] is None
