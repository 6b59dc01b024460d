"""The port's Winograd F(2x2, 3x3) convolution vs the JAX package on the CPU.

`winograd_conv3x3` on a CPU tensor is its plain version, the XLA formulation
with V and U rounded to x.dtype; it is held against the Pallas kernel
(`winograd_conv3x3_pallas`, interpret mode) and the XLA function
(`winograd_conv3x3`) at tests/test_winograd.py's shapes, in f32 and bf16.
The port is NCHW / OIHW, JAX NHWC / HWIO: inputs are transposed at the
boundary. Tolerances: f32 atol 1e-4 / rtol 1e-4 (tests/test_winograd.py's);
bf16 2e-2 / 2e-2, the kernel tests' bf16 limit, above one bf16 step of the
outputs (|y| up to ~5: a step of 2^-5 there, 2e-2 + 2e-2 * 5 = 0.12); the
weight transform 1e-6 (the same f32 sums of halves); the gradients, the
direct convolution's on both sides, 1e-4 / 1e-3 as the backward kernels'
tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.ops import winograd as jwin
from tango_tpu_torch.ops import winograd as twin

torch.set_num_threads(1)

TOL = {"f32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=2e-2, rtol=2e-2)}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}

# tests/test_winograd.py:21-28 (the XLA formulation) and :37-44 (the kernel)
XLA_SHAPES = [(2, 8, 6, 16, 24), (1, 256, 16, 8, 8), (2, 4, 4, 8, 16)]
PALLAS_SHAPES = [(2, 8, 8, 16, 24), (1, 64, 16, 32, 8), (2, 256, 16, 16, 16)]


def _inputs(b, h, w, ci, co, seed=0):
    """x (B, H, W, Ci) and an HWIO kernel, numpy f32, the JAX test's scales."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, ci).astype(np.float32)
    k = (rng.randn(3, 3, ci, co) * 0.1).astype(np.float32)
    return x, k


def _port(x_nhwc, k_hwio, dt):
    """The port's winograd_conv3x3 on the same values, NHWC f32 numpy out."""
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))).to(TDT[dt])
    w = torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))
    return twin.winograd_conv3x3(x, w).float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
def test_plain_matches_pallas_kernel(shape, dt):
    x, k = _inputs(*shape)
    ref = jwin.winograd_conv3x3_pallas(jnp.asarray(x, JDT[dt]), jnp.asarray(k), interpret=True)
    np.testing.assert_allclose(_port(x, k, dt), np.asarray(ref, np.float32), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", XLA_SHAPES)
def test_plain_matches_xla_formulation(shape, dt):
    x, k = _inputs(*shape, seed=1)
    ref = jax.jit(jwin.winograd_conv3x3)(jnp.asarray(x, JDT[dt]), jnp.asarray(k))
    np.testing.assert_allclose(_port(x, k, dt), np.asarray(ref, np.float32), **TOL[dt])
    if dt == "f32":  # and the convolution it computes
        direct = torch.nn.functional.conv2d(
            torch.from_numpy(x.transpose(0, 3, 1, 2)), torch.from_numpy(k.transpose(3, 2, 0, 1)),
            padding=1)
        np.testing.assert_allclose(_port(x, k, dt), direct.numpy().transpose(0, 2, 3, 1),
                                   **TOL[dt])


def test_weight_transform_matches_jax():
    rng = np.random.RandomState(2)
    k = rng.randn(3, 3, 4, 6).astype(np.float32)
    u = twin.winograd_weight_transform(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    assert u.shape == (4, 4, 4, 6)
    np.testing.assert_allclose(u.numpy(), np.asarray(jwin.winograd_weight_transform(k)),
                               atol=1e-6, rtol=0)
    # a delta input reproduces the direct conv (tests/test_winograd.py:59-62)
    x = np.zeros((1, 8, 8, 4), np.float32)
    x[0, 4, 4, 0] = 1.0
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(_port(x, k, "f32"), np.asarray(ref), atol=1e-5)


def test_vjp_matches_jax(monkeypatch):
    """winograd_conv3x3_vjp's forward and gradients vs jax.vjp of JAX's
    custom-VJP function, its Pallas forward in interpret mode."""
    monkeypatch.setattr(jwin, "winograd_conv3x3_pallas", functools.partial(
        jwin.winograd_conv3x3_pallas, interpret=True))
    x, k = _inputs(2, 8, 8, 16, 24, seed=3)
    g = np.random.RandomState(4).randn(2, 8, 8, 24).astype(np.float32)
    y, vjp = jax.vjp(jwin.winograd_conv3x3_vjp, jnp.asarray(x), jnp.asarray(k))
    jdx, jdk = vjp(jnp.asarray(g))

    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).requires_grad_()
    out = twin.winograd_conv3x3_vjp(xt, wt)
    out.backward(torch.from_numpy(np.ascontiguousarray(g.transpose(0, 3, 1, 2))))
    tol = dict(atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y),
                               **TOL["f32"])
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jdx), **tol)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(jdk), **tol)


def test_wino_supported_matches_jax():
    """The same answer over a grid of shapes: x (B, H, W, C) / (B, C, H, W),
    kernels (kh, kw, I, O) / (O, I, kh, kw), strides."""
    for h in (4, 5, 8):
        for w in (2, 3, 16):
            for kh, kw in ((3, 3), (1, 1), (3, 1)):
                for strides in ((1, 1), (2, 2), (1, 2)):
                    want = jwin.wino_supported((2, h, w, 8), (kh, kw, 8, 16), strides)
                    got = twin.wino_supported((2, 8, h, w), (16, 8, kh, kw), strides)
                    assert got == want, (h, w, kh, kw, strides)
    assert not twin.wino_supported((8, 8, 8), (16, 8, 3, 3), (1, 1))
    assert not jwin.wino_supported((8, 8, 8), (3, 3, 8, 16), (1, 1))


def test_wrapper_checks_and_cpu_route():
    x = torch.randn(1, 4, 6, 6)
    w = torch.randn(8, 4, 3, 3)
    twin.winograd_conv3x3.launches = 0
    assert twin.winograd_conv3x3(x, w).shape == (1, 8, 6, 6)
    assert twin.winograd_conv3x3.launches == 0  # the CPU runs the plain version
    with pytest.raises(ValueError, match="even"):
        twin.winograd_conv3x3(torch.randn(1, 4, 5, 6), w)
    with pytest.raises(ValueError):
        twin.winograd_conv3x3(x, torch.randn(8, 4, 1, 1))
    with pytest.raises(TypeError):
        twin.winograd_conv3x3(x.half(), w)
    with pytest.raises(RuntimeError, match="no kernel"):
        twin.winograd_conv3x3(x.to("meta"), w.to("meta"))
    # the GEMM's (tile block, split, channel block) grid past 2^31 - 1 blocks
    assert not twin.kernel_shape_ok((65536, 4, 128, 128), 4096)
    assert twin.kernel_shape_ok((65536, 4, 128, 128), 4032)
    assert twin.kernel_shape_ok((2, 2560, 32, 2), 1280)
