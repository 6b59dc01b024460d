"""The Winograd tensor-core body (csrc/winograd_tc.cu) on the CPU.

The CUDA body itself runs only on the card (`chip_smoke.py` holds it against
the plain version there). Here: the rule that picks it (`wino_tc_body`) at
every 3x3 stride-1 shape of the full-width UNet and at tests/test_winograd.py's
shapes; U's two layouts (`kernel_weight`); the point split
(`wino_splits`); the launch path's scratch and `tc_launches` with the C
library replaced by a recorder; and `wino_walk`, a plain-torch emulation of
the body's arithmetic: V = B^T d B in f32 rounded to x.dtype, U likewise,
the 16 points one after another, each summed over Ci in 64-channel chunks
into an f32 accumulator and then folded into the four outputs with the signs
of A^T[a,p] A^T[d,q], the splits' f32 partial sums added in order. The walk
is held against JAX's `winograd_conv3x3_pallas` in interpret mode in bf16 at
2e-2 (the kernel tests' bf16 limit) and, in f32, against the Pallas kernel
and the XLA formulation at tests/test_winograd.py's 1e-4.
"""

import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tango_tpu.ops import winograd as jwin
from tango_tpu_torch import configs, ops
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.ops import winograd as wg
from tests._torch_helpers import fake_kernel_library

torch.set_num_threads(1)

SMS = 132  # the H100's SMs
TOL = {"f32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=2e-2, rtol=2e-2)}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
# the 3x3 stride-1 convolutions of one full-width UNet evaluation at CFG
# batch 2, ((B, Ci, H, W), Co), as chip_smoke.py's hooks record them
UNET_SHAPES = [
    ((2, 8, 256, 16), 320), ((2, 320, 128, 8), 640), ((2, 320, 256, 16), 8),
    ((2, 320, 256, 16), 320), ((2, 640, 64, 4), 1280), ((2, 640, 128, 8), 640),
    ((2, 640, 256, 16), 320), ((2, 640, 256, 16), 640), ((2, 960, 128, 8), 640),
    ((2, 960, 256, 16), 320), ((2, 1280, 32, 2), 1280), ((2, 1280, 64, 4), 1280),
    ((2, 1280, 128, 8), 640), ((2, 1280, 128, 8), 1280), ((2, 1920, 64, 4), 1280),
    ((2, 1920, 128, 8), 640), ((2, 2560, 32, 2), 1280), ((2, 2560, 64, 4), 1280),
]
# tests/test_winograd.py:21-28 (the XLA formulation) and :37-44 (the kernel),
# (B, H, W, Ci, Co)
XLA_SHAPES = [(2, 8, 6, 16, 24), (1, 256, 16, 8, 8), (2, 4, 4, 8, 16)]
PALLAS_SHAPES = [(2, 8, 8, 16, 24), (1, 64, 16, 32, 8), (2, 256, 16, 16, 16)]


def test_tc_body_rule():
    """bf16 takes the tensor-core body at any Ci, f32 the CUDA-core one."""
    assert wg.wino_tc_body(torch.bfloat16) and not wg.wino_tc_body(torch.float32)


@pytest.mark.parametrize("xshape,co", UNET_SHAPES)
def test_kernel_takes_every_unet_shape(xshape, co):
    assert wg.kernel_shape_ok(xshape, co)


def test_unet_shapes_are_every_full_width_conv3x3():
    """The listed shapes cover the input widths of every 3x3 stride-1
    convolution of the full-width UNet (built on the meta device)."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(configs.TANGO_UNET)
    cis = {m.in_channels for m in unet.modules() if isinstance(m, torch.nn.Conv2d)
           and m.kernel_size == (3, 3) and m.stride == (1, 1)}
    assert cis == {xshape[1] for xshape, _ in UNET_SHAPES}


@pytest.mark.parametrize("ci", [8, 16, 20, 320])
def test_kernel_weight_layouts(ci):
    """U = G w G^T rounded to the type: (16, Ci, Co) for the CUDA-core body,
    (16, Co, Cs) with zeros past Ci for the tensor-core one (Cs = Ci rounded
    up to 16), the same values."""
    w = torch.from_numpy(np.random.RandomState(ci).randn(12, ci, 3, 3).astype(np.float32))
    core = wg.kernel_weight(w, torch.float32)
    ref = wg.winograd_weight_transform(w).reshape(16, ci, 12)
    assert core.shape == (16, ci, 12) and torch.equal(core, ref)
    u = wg.kernel_weight(w, torch.bfloat16)
    cs = -(-ci // 16) * 16
    assert u.shape == (16, 12, cs) and u.is_contiguous()
    assert torch.equal(u[:, :, :ci], ref.to(torch.bfloat16).transpose(1, 2))
    assert not u[:, :, ci:].any()


@pytest.mark.parametrize("xshape,co", UNET_SHAPES)
def test_splits_rule(xshape, co):
    """One split where the (128-tile, 64-channel) blocks reach half the SMs,
    else the least power of two (at most 16) that gives every SM a block."""
    b, _, h, w = xshape
    tiles = b * (h // 2) * (w // 2)
    blocks = math.ceil(tiles / 128) * math.ceil(co / 64)
    s = wg.wino_splits(tiles, co, SMS)
    assert s in (1, 2, 4, 8, 16)
    if 2 * blocks >= SMS:
        assert s == 1
    else:
        assert (blocks * s >= SMS or s == 16) and blocks * s // 2 < SMS


# --------------------------------------------- the body's arithmetic in torch

def _bt(a0, a1, a2, a3):
    """The rows of B^T applied to four values, the kernels' bt_combine."""
    return a0 - a2, a1 + a2, a2 - a1, a1 - a3


def _at(a, p):
    """A^T[a, p] with A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]."""
    return ((1, 1, 1, 0), (0, 1, -1, -1))[a][p]


def wino_walk(x: torch.Tensor, w: torch.Tensor, splits: int = 1) -> torch.Tensor:
    """The tensor-core body's arithmetic on NCHW x and an OIHW weight."""
    b, ci, h, ww = x.shape
    co, th, tw = w.shape[0], h // 2, ww // 2
    tiles, cs = b * th * tw, -(-ci // 16) * 16
    xp = F.pad(x.float(), (1, 1, 1, 1))
    d = [[xp[:, :, i:i + h:2, j:j + ww:2] for j in range(4)] for i in range(4)]
    t = [_bt(*(d[i][j] for i in range(4))) for j in range(4)]          # t[j][p]
    v = [_bt(*(t[j][p] for j in range(4))) for p in range(4)]          # v[p][q]
    v = torch.stack([v[p][q] for p in range(4) for q in range(4)])     # (16, B, Ci, th, tw)
    v = F.pad(v.permute(0, 1, 3, 4, 2).reshape(16, tiles, ci), (0, cs - ci))
    v = v.to(x.dtype).float()
    u = wg.kernel_weight(w, x.dtype).float()
    if not wg.wino_tc_body(x.dtype):  # the CUDA-core layout (f32): to the GEMM's
        u = F.pad(u.transpose(1, 2), (0, cs - ci))
    y = None
    for s in range(splits):
        part = torch.zeros(4, tiles, co)
        for pq in range(s * 16 // splits, (s + 1) * 16 // splits):
            m = torch.zeros(tiles, co)
            for c0 in range(0, cs, 64):
                m = m + v[pq, :, c0:c0 + 64] @ u[pq, :, c0:c0 + 64].t()
            for o, (a, dd) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                sign = _at(a, pq // 4) * _at(dd, pq % 4)
                if sign:
                    part[o] = part[o] + sign * m
        y = part if y is None else y + part
    y = y.reshape(2, 2, b, th, tw, co).permute(2, 5, 3, 0, 4, 1)      # (B, Co, th, a, tw, d)
    return y.reshape(b, co, h, ww).to(x.dtype)


def _inputs(b, h, w, ci, co, seed=0):
    """x (B, H, W, Ci) and an HWIO kernel, numpy f32, the JAX test's scales."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, ci).astype(np.float32),
            (rng.randn(3, 3, ci, co) * 0.1).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_ref(shape, dt, kind):
    x, k = _inputs(*shape)
    fn = (functools.partial(jwin.winograd_conv3x3_pallas, interpret=True) if kind == "pallas"
          else jax.jit(jwin.winograd_conv3x3))
    return np.asarray(fn(jnp.asarray(x, JDT[dt]), jnp.asarray(k)), np.float32)


def _walk(shape, dt, splits):
    """wino_walk on the same numpy inputs as _jax_ref, NHWC f32 numpy out."""
    x, k = _inputs(*shape)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(TDT[dt])
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    return wino_walk(xt, wt, splits).float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("shape", PALLAS_SHAPES + [(1, 6, 8, 20, 13)])
def test_walk_bf16_matches_pallas(shape, splits):
    """The JAX kernel tests' shapes, and chip_smoke.py's ragged one (Ci = 20,
    zero-padded to 32 channels; odd Co)."""
    np.testing.assert_allclose(_walk(shape, "bf16", splits), _jax_ref(shape, "bf16", "pallas"),
                               **TOL["bf16"])


@pytest.mark.parametrize("shape", PALLAS_SHAPES)
def test_walk_f32_matches_pallas(shape):
    np.testing.assert_allclose(_walk(shape, "f32", 2), _jax_ref(shape, "f32", "pallas"),
                               **TOL["f32"])


@pytest.mark.parametrize("shape", XLA_SHAPES)
def test_walk_f32_matches_xla_formulation(shape):
    np.testing.assert_allclose(_walk(shape, "f32", 1), _jax_ref(shape, "f32", "xla"),
                               **TOL["f32"])


def test_walk_bf16_matches_the_plain_version():
    """The walk and the plain version (the XLA formulation) round V and U
    alike and differ in the f32 order of the sums only: within one bf16 step
    of the outputs (|y| below ~4 here)."""
    x, k = _inputs(2, 16, 8, 64, 40, seed=7)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).bfloat16()
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    np.testing.assert_allclose(wino_walk(xt, wt, 2).float().numpy(),
                               wg.winograd_conv3x3_plain(xt, wt).float().numpy(),
                               atol=2e-2, rtol=8e-3)


# ------------------------------------------------------------ the launch path

@pytest.fixture
def card(monkeypatch):
    """The device query of the launch path, answered for an H100."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(multi_processor_count=SMS))


def test_launch_path_scratch_and_counters(monkeypatch, card):
    """With the C library replaced by a recorder: bf16 passes V's scratch (and the partial sums when the points split) and counts the
    reported tensor-core launch; f32 passes none and counts none."""
    args = []
    calls = fake_kernel_library(monkeypatch, [ops.TC_LAUNCHED, ops.TC_LAUNCHED, 0], args)
    ops.reset_counters()
    fn = wg.winograd_conv3x3
    w = torch.zeros(24, 16, 3, 3)
    x = torch.zeros(2, 16, 8, 8, dtype=torch.bfloat16)
    y = wg.launch(x, wg.kernel_weight(w, x.dtype), 24)
    assert y.shape == (2, 24, 8, 8) and y.dtype == torch.bfloat16
    v, part, splits = args[-1][3:6]
    assert v and splits == wg.wino_splits(32, 24, SMS) == 16 and part
    x = torch.zeros(2, 320, 256, 16, dtype=torch.bfloat16)
    wg.launch(x, torch.zeros(16, 320, 320, dtype=torch.bfloat16), 320)
    v, part, splits = args[-1][3:6]
    assert v and part is None and splits == 1
    x = torch.zeros(2, 16, 8, 8)
    wg.launch(x, wg.kernel_weight(w, x.dtype), 24)
    assert args[-1][3:6] == (None, None, 1)
    assert fn.launches == 3 and fn.tc_launches == 2 and calls == ["tt_wino_conv3x3"] * 3
    assert fn.shapes == {((2, 16, 8, 8), (24, 16, 3, 3)), ((2, 320, 256, 16), (320, 320, 3, 3))}
    ops.reset_counters()
    assert fn.launches == 0 and fn.tc_launches == 0


def test_tc_launches_count_the_entry_points_report(monkeypatch, card):
    """A report of the other body than the rule names raises (either way
    round) and counts no tensor-core launch; a CUDA error code raises."""
    fake_kernel_library(monkeypatch, [0, ops.TC_LAUNCHED, 700, ops.TC_LAUNCHED])
    ops.reset_counters()
    fn = wg.winograd_conv3x3
    w = torch.zeros(8, 16, 3, 3)
    tc = torch.zeros(1, 16, 4, 4, dtype=torch.bfloat16)
    core = torch.zeros(1, 16, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA-core body against"):
        wg.launch(tc, wg.kernel_weight(w, tc.dtype), 8)
    with pytest.raises(RuntimeError, match="tensor-core body against"):
        wg.launch(core, wg.kernel_weight(w, core.dtype), 8)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wg.launch(tc, wg.kernel_weight(w, tc.dtype), 8)
    assert fn.tc_launches == 0
    wg.launch(tc, wg.kernel_weight(w, tc.dtype), 8)
    assert fn.tc_launches == 1 and fn.launches == 3
    ops.reset_counters()


def test_weight_kernel_call(monkeypatch):
    """weight_tc hands the U kernel the f32 weight and a (16, Co, Cs) bf16
    output, and raises on a CUDA error."""
    args = []
    calls = fake_kernel_library(monkeypatch, [0, 700], args)
    w = torch.zeros(24, 8, 3, 3, dtype=torch.bfloat16)
    u = wg.weight_tc(w)
    assert u.shape == (16, 24, 16) and u.dtype == torch.bfloat16
    assert calls == ["tt_wino_weight"] and args[0][1] == u.data_ptr() and args[0][2:4] == (24, 8)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wg.weight_tc(w)


def test_wrapper_source_fields():
    assert wg.winograd_conv3x3.source.endswith("csrc/winograd_tc.cu")
    assert wg.winograd_conv3x3.core_source.endswith("csrc/winograd.cu")
    assert wg.winograd_conv3x3.replaces == "tango_tpu/ops/winograd.py:100"
