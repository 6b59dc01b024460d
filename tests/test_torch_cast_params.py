"""`cast_params` of `Tango.from_components`: the int8 quantize order.

JAX's `from_components` defaults to `cast_params=False` and quantizes the
f32 tree (tango_tpu/pipeline.py:132, 170-203); `Tango(path)` casts to the
compute dtype first. The port follows both orders: on a tiny UNet's f32
weights, with dtype bf16 and quant="all", its int8 weights and f32 scales
are bit-equal to JAX's pipeline's in each order, and the two orders differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu import configs as JC
from tango_tpu.models.unet import UNet2DConditionModel as JUNet
from tango_tpu.models.vae import AutoencoderKL as JVAE
from tango_tpu.pipeline import Tango as JTango
from tango_tpu_torch import configs as TC
from tango_tpu_torch.ops import quant as tq
from tango_tpu_torch.pipeline import Tango
from tango_tpu_torch.utils.convert import from_jax_params
from tests._torch_helpers import random_jax_params
from tests.test_torch_quant import LF, LT, UNET_KW, VAE_KW

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    unet = random_jax_params(lambda k: JUNet(JC.UNetConfig(**UNET_KW)).init(
        k, jnp.zeros((1, LT, LF, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 3, 16)))["params"], 5)
    vae = random_jax_params(lambda k: JVAE(JC.VAEConfig(**VAE_KW)).init(
        k, jnp.zeros((1, 32, 16, 1)), k)["params"], 6)
    return unet, vae


def _int8_state(sd):
    """The int8 weights and their scales of a quantized UNet's state dict."""
    keys = [k for k, v in sd.items() if v.dtype == torch.int8]
    assert keys
    return {k: sd[k] for k in keys} | {k + "_scale": sd[k + "_scale"] for k in keys}


def _jax_int8_state(tree):
    """The same entries of JAX's quantized parameter tree, as a state dict."""
    as_np = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if np.asarray(x).dtype == np.int8 else np.asarray(x, np.float32),
        tree)
    return _int8_state(from_jax_params(as_np))


@pytest.mark.parametrize("cast", [False, True])
def test_int8_weights_follow_the_quantize_order(params, cast):
    """from_components(dtype=bf16, quant="all", cast_params=cast) on f32
    weights: the int8 weights and the f32 scales are bit-equal to JAX's
    pipeline's with the same flag (cast False: quantized from the f32
    weights; True: from the bf16-cast ones); the float remainder is bf16."""
    unet, vae = params
    jt = JTango.from_components(
        unet_config=JC.UNetConfig(**UNET_KW), vae_config=JC.VAEConfig(**VAE_KW),
        unet_params=unet, vae_params=vae, dtype=jnp.bfloat16, quant="all", cast_params=cast)
    port = Tango.from_components(
        unet_config=TC.UNetConfig(**UNET_KW), vae_config=TC.VAEConfig(**VAE_KW),
        unet_params=from_jax_params(unet), device="cpu", dtype=torch.bfloat16,
        latent_t_size=LT, latent_f_size=LF, quant="all", cast_params=cast)
    got = _int8_state(port.model.unet.state_dict())
    ref = _jax_int8_state(jt.unet_params)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        torch.testing.assert_close(got[key], ref[key], rtol=0, atol=0, msg=key)
    floats = [p for p in port.model.unet.parameters()]
    assert floats and all(p.dtype == torch.bfloat16 for p in floats)
    assert all(m.weight_scale.dtype == torch.float32 for m in port.model.unet.modules()
               if isinstance(m, (tq.QLinear, tq.QConv2d)))


def test_the_two_quantize_orders_differ(params):
    """The fault the flag repairs: quantizing the bf16-cast weights flips
    int8 values against quantizing the f32 ones (and moves the scales)."""
    unet, _ = params
    sd = from_jax_params(unet)
    states = [_int8_state(Tango.from_components(
        unet_config=TC.UNetConfig(**UNET_KW), vae_config=TC.VAEConfig(**VAE_KW),
        unet_params=sd, device="cpu", dtype=torch.bfloat16, latent_t_size=LT,
        latent_f_size=LF, quant="all", cast_params=cast).model.unet.state_dict())
        for cast in (False, True)]
    weights = [k for k in states[0] if not k.endswith("_scale")]
    flips = sum(int((states[0][k] != states[1][k]).sum()) for k in weights)
    assert flips > 0
    assert any(not torch.equal(states[0][k + "_scale"], states[1][k + "_scale"])
               for k in weights)


def test_cast_params_leaves_float_pipelines_alone(params):
    """Without quant the flag changes nothing: the UNet's modules store the
    compute dtype, with the same values, in either setting."""
    unet, _ = params
    sd = from_jax_params(unet)
    built = [Tango.from_components(
        unet_config=TC.UNetConfig(**UNET_KW), vae_config=TC.VAEConfig(**VAE_KW),
        unet_params=sd, device="cpu", dtype=torch.bfloat16, latent_t_size=LT,
        latent_f_size=LF, cast_params=cast).model.unet.state_dict() for cast in (False, True)]
    assert all(v.dtype == torch.bfloat16 for v in built[0].values() if v.is_floating_point())
    assert all(torch.equal(built[0][k], built[1][k]) for k in built[0])
