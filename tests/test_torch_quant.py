"""The port's int8 W8A8 serving mode vs the JAX package on the CPU.

The same numpy inputs and parameter trees go through both packages. Layouts
differ at the boundary: the port's int8 weight is (out, in[, kh, kw]), JAX's
kernel (in, out) / (kh, kw, in, out).

Tolerances, and why:
  * `quantize_weight`, the int8 convolution and the quantized state dict:
    bit-equal or f32 epilogue rounding only (1e-6), since both packages take
    the same f32 division, round half to even and exact integer sums;
  * `w8a8_matmul_plain` vs the Pallas kernel in interpret mode: the JAX
    test's 1e-5 in f32, one bf16 step in bf16 (atol 1e-2, rtol 8e-3);
  * the port's `int8_dot` (the kernel's `amax * (1/127)` scale) vs JAX's
    (`amax / 127`): 1e-5, plus for the few outputs where the two scales,
    one ulp apart, round one activation to neighbouring int8 values, one
    int8 step: at most 127 * x_scale * w_scale;
  * every int8 module of the quantized UNet on the input the port's forward
    gave it, vs JAX's int8_conv / int8_dot on the same input: the
    convolutions to 1e-6, the dense layers as int8_dot above;
  * the quantized UNet and the quantized pipelines end to end vs JAX's: a
    relative L2 below 0.05, JAX's own bar for the mode against f32
    (tests/test_quant.py:101). Each package quantizes its own activations,
    which differ by f32 noise; one value that noise moves across a .5
    boundary changes an int8 step, and everything downstream then quantizes
    different inputs (test_quantized_unet_matches_jax says more);
  * that bar holds for the port against its own f32 UNet too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tango_tpu import configs as JC
from tango_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from tango_tpu.models.t5 import T5Config as JT5Config
from tango_tpu.models.t5 import T5Encoder as JT5Encoder
from tango_tpu.models.unet import UNet2DConditionModel as JUNet
from tango_tpu.models.vae import AutoencoderKL as JVAE
from tango_tpu.ops import quant as jq
from tango_tpu.ops.int8_gemm import w8a8_matmul as j_w8a8
from tango_tpu.pipeline import Tango as JTango
from tango_tpu_torch import configs as TC
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.ops import int8_gemm as tg
from tango_tpu_torch.ops import quant as tq
from tango_tpu_torch.pipeline import Tango
from tango_tpu_torch.tokenizer import WordHashTokenizer
from tango_tpu_torch.utils.convert import from_jax_params

from tests._torch_helpers import random_jax_params

torch.set_num_threads(1)

# tests/test_quant.py's TINY UNet
UNET_KW = dict(
    in_channels=8,
    out_channels=8,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(32, 64),
    layers_per_block=2,
    cross_attention_dim=16,
    attention_head_dim=(2, 4),
    norm_num_groups=8,
)
VAE_KW = dict(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2), num_res_blocks=1,
              scale_factor=0.9)
T5_KW = dict(vocab_size=128, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4)
HIFI_KW = dict(num_mels=8, upsample_initial_channel=32)
LT, LF = 16, 4
BF16_STEP = dict(atol=1e-2, rtol=8e-3)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def unet_params():
    return random_jax_params(lambda k: JUNet(JC.UNetConfig(**UNET_KW)).init(
        k, jnp.zeros((1, LT, LF, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 3, 16)))["params"], 0)


# ------------------------------------------------------------------- weights

@pytest.mark.parametrize("shape", [(24, 16), (320, 256), (3, 3, 8, 16), (1, 1, 12, 4)])
def test_quantize_weight_bit_equal_to_jax(shape):
    w = (np.random.RandomState(0).randn(*shape) * 0.05).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-8 floor
    jq_, js = jq.quantize_weight(w)
    q, s = tq.quantize_weight(w)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq_)
    np.testing.assert_array_equal(s, js)
    # the tensor route, as the modules use it, on the port's (out, ...) layout
    axes = (len(shape) - 1,) + tuple(range(len(shape) - 1))
    qt, st = tq.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.transpose(axes))), 0)
    np.testing.assert_array_equal(qt.numpy(), jq_.transpose(axes))
    np.testing.assert_array_equal(st.numpy(), js)


# ---------------------------------------------------------------- the kernel

@pytest.mark.parametrize("m,k,n", [(300, 320, 256), (37, 70, 24), (5, 3, 8)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_w8a8_plain_matches_pallas_kernel(m, k, n, dt):
    """tests/test_quant.py:54-65's shapes and scales, plus a K that is not a
    multiple of 4 and a handful of rows."""
    rng = np.random.RandomState(2)
    w = rng.randn(k, n).astype(np.float32) * 0.05
    q, s = jq.quantize_weight(w)
    x = (rng.randn(m, k) * 0.3).astype(np.float32)
    x[1] = 0.0  # a zero row: the 1e-8 floor
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = j_w8a8(jnp.asarray(x, jdt), jnp.asarray(q), jnp.asarray(s), block_m=256,
                 block_n=128, interpret=True)
    out = tg.w8a8_matmul_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(q.T.copy()),
                               torch.from_numpy(s))
    assert out.dtype == tdt
    tol = dict(atol=1e-5, rtol=1e-5) if dt == "f32" else BF16_STEP
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)


def test_w8a8_wrapper_cpu_route_and_checks():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 6, 40).astype(np.float32))
    q, s = tq.quantize_weight(torch.from_numpy(rng.randn(24, 40).astype(np.float32)), 0)
    tg.w8a8_matmul.launches = 0
    out = tg.w8a8_matmul(x, q, s)
    assert out.shape == (2, 6, 24) and tg.w8a8_matmul.launches == 0
    torch.testing.assert_close(out, tg.w8a8_matmul_plain(x.reshape(12, 40), q, s).reshape(
        2, 6, 24), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tg.w8a8_matmul(x, q.float(), s)
    with pytest.raises(ValueError):
        tg.w8a8_matmul(x[..., :39], q, s)
    with pytest.raises(TypeError):
        tg.w8a8_matmul(x.half(), q, s)
    with pytest.raises(RuntimeError, match="no kernel"):
        tg.w8a8_matmul(x.to("meta"), q.to("meta"), s.to("meta"))
    assert tg.kernel_shape_ok(8192, 5120, 10240)
    assert not tg.kernel_shape_ok(8, 200000, 8)  # K * 127^2 past int32


# ------------------------------------------------------ int8_dot / int8_conv

def test_int8_dot_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(64, 32).astype(np.float32)
    w = rng.randn(32, 48).astype(np.float32)
    q, s = jq.quantize_weight(w)
    ref = np.asarray(jq.int8_dot(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s)))
    out = tq.int8_dot(torch.from_numpy(x), torch.from_numpy(q.T.copy()),
                      torch.from_numpy(s)).numpy()
    x_scale = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127
    one_step = 127 * x_scale * s
    err = np.abs(out - ref)
    assert (err <= 1e-5 + 1e-5 * np.abs(ref) + one_step).all()
    assert (err > 1e-5 + 1e-5 * np.abs(ref)).mean() < 0.01
    assert _rel(out, x @ w) < 0.02  # JAX's bar, tests/test_quant.py:42-51


@pytest.mark.parametrize("stride,pad,ksize", [(1, 1, 3), (2, 1, 3), (2, 0, 3), (1, 0, 1)],
                         ids=["same", "down_pad1", "down_pad0", "shortcut"])
def test_int8_conv_matches_jax(stride, pad, ksize):
    """SAME pad-1 (resnet convs), the stride-2 pad-1 downsampler, the pad-0
    downsampler (asymmetric (0, 1) pre-pad, then VALID), the 1x1 shortcut."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 7, 12).astype(np.float32)  # NHWC, odd sizes
    k = (rng.randn(ksize, ksize, 12, 16) * 0.1).astype(np.float32)
    q, s = jq.quantize_weight(k)
    xj = x
    if stride == 2 and pad == 0:
        xj = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
        jpad = "VALID"
    else:
        jpad = [(pad, pad), (pad, pad)]
    ref = np.asarray(jq.int8_conv(jnp.asarray(xj), jnp.asarray(q), jnp.asarray(s),
                                  (stride, stride), jpad))
    out = tq.int8_conv(torch.from_numpy(np.ascontiguousarray(xj.transpose(0, 3, 1, 2))),
                       torch.from_numpy(np.ascontiguousarray(q.transpose(3, 2, 0, 1))),
                       torch.from_numpy(s), stride, pad)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ the UNet

def test_quantize_unet_scopes(unet_params):
    """quantize_unet_ recurses as quantize_tree does (tests/test_quant.py:67-84),
    leaves conv_in, conv_out, the time embedding and time_emb_proj float, and
    gives the weights quantize_tree gives."""
    sd = from_jax_params(unet_params)

    def port(scope):
        m = UNet2DConditionModel(TC.UNetConfig(**UNET_KW))
        m.load_state_dict(sd)
        return tq.quantize_unet_(m, scope)

    conv = port("conv")
    assert isinstance(conv.down_blocks_0.resnets_0.conv1, tq.QConv2d)
    assert conv.down_blocks_0.resnets_0.conv1.weight.dtype == torch.int8
    assert isinstance(conv.down_blocks_0.attentions_0.proj_in, nn.Linear)
    assert isinstance(conv.down_blocks_0.downsamplers_0.conv, tq.QConv2d)
    dense = port("dense")
    assert isinstance(dense.down_blocks_0.resnets_0.conv1, nn.Conv2d)
    assert isinstance(dense.down_blocks_0.attentions_0.proj_in, tq.QLinear)
    assert isinstance(dense.down_blocks_0.attentions_0.transformer_blocks_0.attn2.to_kv,
                      tq.QLinear)
    full = port("all")
    for m in (full.conv_in, full.conv_out, full.time_embedding.linear_1,
              full.time_embedding.linear_2, full.down_blocks_0.resnets_0.time_emb_proj):
        assert type(m) in (nn.Conv2d, nn.Linear)
    n_q = sum(isinstance(m, (tq.QLinear, tq.QConv2d)) for m in full.modules())
    assert n_q == sum(isinstance(m, (tq.QLinear, tq.QConv2d))
                      for m in port("dense").modules()) + sum(
        isinstance(m, (tq.QLinear, tq.QConv2d)) for m in conv.modules())
    ref = from_jax_params(jq.quantize_tree(unet_params))
    got = full.state_dict()
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        torch.testing.assert_close(got[key], ref[key], rtol=0, atol=0, msg=key)
    with pytest.raises(ValueError, match="scope"):
        tq.quantize_unet_(UNet2DConditionModel(TC.UNetConfig(**UNET_KW)), "int8")


def test_quantized_unet_matches_jax(unet_params):
    """The port's UNet of a quant_int8 config, loaded from a converted
    quantize_tree output, vs JAX's UNet2DConditionModel(TINY_Q).

    Module by module on the same inputs (each int8 module's input as the
    port's forward saw it, through JAX's int8_conv / int8_dot with the JAX
    tree's leaves): the convolutions to 1e-6, the dense layers to 1e-5 up to
    rare one-step flips. End to end the two UNets see their own activations,
    which differ by f32 noise (~1e-7); a value that noise moves across a .5
    boundary changes one int8 step, and the layers after it quantize
    inputs that now differ by that step, so one early flip re-draws the
    quantization noise of everything downstream (measured at this seed on
    the conv scope: a flip in up_blocks_0.resnets_0.conv_shortcut, 2e-2 at
    that layer, 1.8e-2 relative L2 at the output). End to end the bar is
    therefore JAX's own for the mode: a relative L2 below 0.05."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, LT, LF, 8).astype(np.float32)
    t = np.array([100, 700], np.int32)
    ctx = rng.randn(2, 5, 16).astype(np.float32)
    qparams = jq.quantize_tree(unet_params)
    jcfg = JC.dataclasses.replace(JC.UNetConfig(**UNET_KW), quant_int8=True)
    ref = np.asarray(jax.jit(JUNet(jcfg).apply)({"params": qparams}, jnp.asarray(x),
                                                jnp.asarray(t), jnp.asarray(ctx)))

    port = UNet2DConditionModel(TC.UNetConfig(**UNET_KW, quant_int8=True)).eval()
    port.load_state_dict(from_jax_params(qparams))
    floats = UNet2DConditionModel(TC.UNetConfig(**UNET_KW)).eval()
    floats.load_state_dict(from_jax_params(unet_params))
    seen = {}
    for name, m in port.named_modules():
        if isinstance(m, (tq.QLinear, tq.QConv2d)):
            m.register_forward_hook(lambda mod, inp, out, name=name: seen.__setitem__(
                name, (mod, inp[0].numpy(), out.numpy())))
    with torch.no_grad():
        args = (torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(ctx))
        out = port(*args).numpy()
        out_f32 = floats(*args).numpy()
    assert len(seen) == 87  # 6 transformers x 9 projections, 33 convolutions
    j_conv = jax.jit(jq.int8_conv, static_argnums=(3, 4))
    j_dot = jax.jit(jq.int8_dot)

    for name, (mod, xin, got) in seen.items():
        leaves = qparams
        for part in name.split("."):
            leaves = leaves[part]
        kq, ks = jnp.asarray(leaves["kernel_q"]), jnp.asarray(leaves["kernel_scale"])
        if isinstance(mod, tq.QConv2d):
            pad = ((mod.padding, mod.padding),) * 2
            want = np.asarray(j_conv(jnp.asarray(xin.transpose(0, 2, 3, 1)), kq, ks,
                                     (mod.stride, mod.stride), pad))
            want = (want + leaves["bias"]).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6, err_msg=name)
            continue
        want = np.asarray(j_dot(jnp.asarray(xin), kq, ks))
        if "bias" in leaves:
            want = want + leaves["bias"]
        err = np.abs(got - want)
        x_scale = np.maximum(np.abs(xin).max(-1, keepdims=True), 1e-8) / 127
        assert (err <= 1e-5 + 1e-5 * np.abs(want) + 127 * x_scale * np.asarray(ks)).all(), name
        assert (err > 1e-5 + 1e-5 * np.abs(want)).mean() < 0.01, name

    assert _rel(out, ref) < 0.05, _rel(out, ref)
    assert _rel(out, out_f32) < 0.05


# --------------------------------------------------------------- the pipeline

@pytest.fixture(scope="module")
def pipe_params(unet_params):
    return dict(
        unet=unet_params,
        vae=random_jax_params(lambda k: JVAE(JC.VAEConfig(**VAE_KW)).init(
            k, jnp.zeros((1, 32, 16, 1)), k)["params"], 1),
        t5=random_jax_params(lambda k: JT5Encoder(JT5Config(**T5_KW)).init(
            k, jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))["params"], 2),
        hifi=random_jax_params(lambda k: JHiFiGAN(JC.HiFiGANConfig(**HIFI_KW)).init(
            k, jnp.zeros((1, 8, 8)))["params"], 3),
    )


@pytest.mark.parametrize("scope", ["conv", "dense", "all"])
def test_pipeline_quant_matches_jax(pipe_params, scope):
    """Tango.from_components(quant=scope) in both packages from the same float
    trees, the CFG sampler fed the same noise; then the port's generate and
    generate_for_batch run on the quantized pipeline."""
    p = pipe_params
    jt = JTango.from_components(
        unet_config=JC.UNetConfig(**UNET_KW), vae_config=JC.VAEConfig(**VAE_KW),
        unet_params=p["unet"], vae_params=p["vae"], t5_config=JT5Config(**T5_KW),
        t5_params=p["t5"], hifigan_config=JC.HiFiGANConfig(**HIFI_KW),
        hifigan_params=p["hifi"], tokenizer=WordHashTokenizer(vocab_size=128),
        latent_t_size=LT, latent_f_size=LF, quant=scope)
    port = Tango.from_components(
        unet_config=TC.UNetConfig(**UNET_KW), vae_config=TC.VAEConfig(**VAE_KW),
        t5_config=TC.T5Config(**T5_KW), hifigan_config=TC.HiFiGANConfig(**HIFI_KW),
        unet_params=from_jax_params(p["unet"]),
        vae_params=from_jax_params(p["vae"], skip=("encoder", "quant_conv")),
        t5_params=from_jax_params(p["t5"]), hifigan_params=from_jax_params(p["hifi"]),
        device="cpu", latent_t_size=LT, latent_f_size=LF, quant=scope)
    unet = port.model.unet
    assert unet.cfg.quant_int8 and unet.cfg.quant_scope == scope
    assert isinstance(unet.down_blocks_0.resnets_0.conv1,
                      tq.QConv2d if scope != "dense" else nn.Conv2d)
    assert isinstance(unet.down_blocks_0.attentions_0.proj_in,
                      tq.QLinear if scope != "conv" else nn.Linear)
    scales = [m.weight_scale for m in unet.modules() if isinstance(m, (tq.QLinear, tq.QConv2d))]
    assert scales and all(s.dtype == torch.float32 for s in scales)

    prompts = ["a dog barks in the park", "rain on a tin roof"]
    steps = 2
    rng = np.random.RandomState(0)
    init = rng.randn(2, LT, LF, 8).astype(np.float32)
    noises = rng.randn(steps, 2, LT, LF, 8).astype(np.float32)
    j_cond, j_mask = jt.encode_text(prompts)
    j_unc, j_umask = jt.encode_text([""] * 2)
    j_lat = np.asarray(jt.model.sample(
        jt.unet_params, j_cond, j_mask, jax.random.PRNGKey(0), num_steps=steps,
        guidance_scale=3.0, uncond_embeds=j_unc, uncond_mask=j_umask,
        noise_override=(init, noises)))
    p_cond, p_mask = port.encode_text(prompts)
    p_unc, p_umask = port.encode_text([""] * 2)
    p_lat = port.model.sample(p_cond, p_mask, num_steps=steps, guidance_scale=3.0,
                              uncond_embeds=p_unc, uncond_mask=p_umask,
                              noise_override=(torch.from_numpy(init),
                                              torch.from_numpy(noises))).numpy()
    # the UNet test's end-to-end bar: flips re-draw the quantization noise
    assert _rel(p_lat, j_lat) < 0.05, _rel(p_lat, j_lat)

    wav = port.generate("a dog barks", steps=1, seed=0)
    assert wav.dtype == np.int16 and wav.shape == (2 * LT * 160 + 32,)
    wavs = port.generate_for_batch(["a", "b", "c"], steps=1, batch_size=2, seed=0)
    assert len(wavs) == 3 and all(w.shape == wav.shape for w in wavs)


def test_unknown_quant_scope_raises():
    """A typo'd scope raises, as JAX's Tango does (tests/test_quant.py:143-149)."""
    for bad in ("int8", "convs", True):
        with pytest.raises(ValueError, match="quant must be"):
            Tango(device="cpu", quant=bad)
    assert Tango(device="cpu", quant=None).quant is None
