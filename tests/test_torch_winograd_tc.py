"""The Winograd tensor-core bodies (csrc/winograd_tc.cu) on the CPU.

The CUDA bodies themselves run only on the card (`chip_smoke.py` holds them
against the plain version there). Here: the rule that picks them
(`wino_tc_body`: f32 and bf16) at every 3x3 stride-1 shape of the
full-width UNet and at tests/test_winograd.py's shapes; U's layout
(`kernel_weight`); the point split (`wino_splits`); the launch path's
scratch and `tc_launches` with the C library replaced by a recorder; and
`wino_walk`, a plain-torch emulation of the bodies' arithmetic: V = B^T d B
in f32 rounded to x.dtype, U likewise, the 16 points one after another, Ci
in 64-channel chunks, the splits' f32 partial sums added in order. bf16: a
point's chunks summed in one f32 accumulator, then folded into the four
outputs with the signs of A^T[a,p] A^T[d,q]; f32: each chunk's product in
3xTF32 (`product`, round-to-nearest-away splits, as the f32 attention
bodies') folded into the outputs at once. The walk is held against JAX's
`winograd_conv3x3_pallas` in interpret mode in bf16 at 2e-2 (the kernel
tests' bf16 limit) and, in f32, against the Pallas kernel and the XLA
formulation at tests/test_winograd.py's 1e-4, and against float64 at deep
Ci; one test pins why f32 takes 3xTF32 (one-product TF32 misses 1e-4).
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
from tests.test_torch_attn_bwd_tc import product

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
    """bf16 and f32 (3xTF32) take the tensor-core body at any Ci; a type
    the kernel does not take has no body."""
    assert wg.wino_tc_body(torch.bfloat16) and wg.wino_tc_body(torch.float32)
    assert not wg.wino_tc_body(torch.float16)


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
    """U = G w G^T rounded to the type, in the one layout of both types:
    (16, Co, Cs) with zeros past Ci (Cs = Ci rounded up to 16)."""
    w = torch.from_numpy(np.random.RandomState(ci).randn(12, ci, 3, 3).astype(np.float32))
    ref = wg.winograd_weight_transform(w).reshape(16, ci, 12)
    cs = -(-ci // 16) * 16
    for dt in (torch.float32, torch.bfloat16):
        u = wg.kernel_weight(w, dt)
        assert u.shape == (16, 12, cs) and u.dtype == dt and u.is_contiguous()
        assert torch.equal(u[:, :, :ci], ref.to(dt).transpose(1, 2))
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


def wino_walk(x: torch.Tensor, w: torch.Tensor, splits: int = 1,
              scheme: str = "3xtf32") -> torch.Tensor:
    """The tensor-core bodies' arithmetic on NCHW x and an OIHW weight; f32
    takes its chunk products by `scheme` (`product`: "3xtf32", the body's;
    "tf32", "f32")."""
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
    f32 = x.dtype == torch.float32

    def fold(part, pq, m):
        for o, (a, dd) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            sign = _at(a, pq // 4) * _at(dd, pq % 4)
            if sign:
                part[o] = part[o] + sign * m

    y = None
    for s in range(splits):
        part = torch.zeros(4, tiles, co)
        for pq in range(s * 16 // splits, (s + 1) * 16 // splits):
            m = torch.zeros(tiles, co)
            for c0 in range(0, cs, 64):
                if f32:  # each chunk's product folded at once
                    fold(part, pq, product(v[pq, :, c0:c0 + 64], u[pq, :, c0:c0 + 64].t(),
                                           scheme))
                else:
                    m = m + v[pq, :, c0:c0 + 64] @ u[pq, :, c0:c0 + 64].t()
            if not f32:
                fold(part, pq, m)
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


def _torch_inputs(shape, dt, seed=0):
    """The numpy inputs of _jax_ref as NCHW x in dt and an OIHW f32 weight."""
    x, k = _inputs(*shape, seed=seed)
    return (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(TDT[dt]),
            torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))))


def _walk(shape, dt, splits, scheme="3xtf32"):
    """wino_walk on the same numpy inputs as _jax_ref, NHWC f32 numpy out."""
    return wino_walk(*_torch_inputs(shape, dt), splits, scheme).float().numpy().transpose(
        0, 2, 3, 1)


def _share(out, ref, tol):
    """The largest |out - ref| / (atol + rtol |ref|): at most 1 meets tol."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(out - ref) / (tol["atol"] + tol["rtol"] * np.abs(ref))).max())


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


@pytest.mark.parametrize("splits", [1, 4])
def test_walk_f32_matches_pallas_at_the_ragged_shape(splits):
    """chip_smoke.py's ragged shape (Ci = 20 zero-padded to 32 channels, odd
    Co, a 3 x 4 tile grid) in f32, one split and four."""
    shape = (1, 6, 8, 20, 13)
    np.testing.assert_allclose(_walk(shape, "f32", splits), _jax_ref(shape, "f32", "pallas"),
                               **TOL["f32"])


@pytest.mark.parametrize("ci", [320, 1280])
def test_walk_f32_against_float64_at_deep_ci(ci):
    """At the UNet's input widths (5 and 20 chunks of 64 channels a point,
    each folded into the outputs at once) the 3xTF32 walk stays within
    1e-4 / 1e-4 of the float64 direct convolution, as close as exact f32
    chunk products (within 1.5x of their share, plus 0.02)."""
    x, w = _torch_inputs((1, 8, 8, ci, 16), "f32", seed=ci)
    exact = F.conv2d(x.double(), w.double(), padding=1).numpy()
    walk = _share(wino_walk(x, w, 2).numpy(), exact, TOL["f32"])
    f32 = _share(wino_walk(x, w, 2, "f32").numpy(), exact, TOL["f32"])
    assert walk < 1.0 and walk <= 1.5 * f32 + 0.02, (walk, f32)


def test_one_product_tf32_walk_misses_f32_limit():
    """One TF32 product a chunk (V and U rounded to 10 mantissa bits) misses
    JAX's f32 limit (1e-4 / 1e-4) against the Pallas kernel at
    tests/test_winograd.py's (1, 64, 16, 32, 8) many times over; 3xTF32 meets
    it on the same inputs with a wide margin."""
    shape = (1, 64, 16, 32, 8)
    ref = _jax_ref(shape, "f32", "pallas")
    assert _share(_walk(shape, "f32", 1, "tf32"), ref, TOL["f32"]) > 5.0
    assert _share(_walk(shape, "f32", 1), ref, TOL["f32"]) < 0.5


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
    """With the C library replaced by a recorder: both types pass V's
    scratch in x's type (and the partial sums when the points split) and
    count the reported tensor-core launch."""
    args = []
    calls = fake_kernel_library(monkeypatch, [ops.TC_LAUNCHED] * 3, args)
    ops.reset_counters()
    fn = wg.winograd_conv3x3
    w = torch.zeros(24, 16, 3, 3)
    for dt in (torch.bfloat16, torch.float32):
        x = torch.zeros(2, 16, 8, 8, dtype=dt)
        y = wg.launch(x, wg.kernel_weight(w, x.dtype), 24)
        assert y.shape == (2, 24, 8, 8) and y.dtype == dt
        v, part, splits = args[-1][3:6]
        assert v and splits == wg.wino_splits(32, 24, SMS) == 16 and part
    x = torch.zeros(2, 320, 256, 16, dtype=torch.bfloat16)
    wg.launch(x, torch.zeros(16, 320, 320, dtype=torch.bfloat16), 320)
    v, part, splits = args[-1][3:6]
    assert v and part is None and splits == 1
    assert fn.launches == 3 and fn.tc_launches == 3 and calls == ["tt_wino_conv3x3"] * 3
    assert [a[11] for a in args] == [1, 0, 1]  # the dtype codes
    assert fn.shapes == {((2, 16, 8, 8), (24, 16, 3, 3)), ((2, 320, 256, 16), (320, 320, 3, 3))}
    ops.reset_counters()
    assert fn.launches == 0 and fn.tc_launches == 0


def test_tc_launches_count_the_entry_points_report(monkeypatch, card):
    """A report of a CUDA-core launch raises in either type (neither has a
    CUDA-core body) and counts no tensor-core launch; a CUDA error code
    raises."""
    fake_kernel_library(monkeypatch, [0, 0, 700, ops.TC_LAUNCHED, ops.TC_LAUNCHED])
    ops.reset_counters()
    fn = wg.winograd_conv3x3
    w = torch.zeros(8, 16, 3, 3)
    bf = torch.zeros(1, 16, 4, 4, dtype=torch.bfloat16)
    f32 = torch.zeros(1, 16, 4, 4)
    for x in (bf, f32):
        with pytest.raises(RuntimeError, match="CUDA-core body against"):
            wg.launch(x, wg.kernel_weight(w, x.dtype), 8)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wg.launch(bf, wg.kernel_weight(w, bf.dtype), 8)
    assert fn.tc_launches == 0
    for x in (bf, f32):
        wg.launch(x, wg.kernel_weight(w, x.dtype), 8)
    assert fn.tc_launches == 2 and fn.launches == 4
    ops.reset_counters()


def test_weight_kernel_call(monkeypatch):
    """weight_tc hands the U kernel the f32 weight, a (16, Co, Cs) output
    in the type asked for and that type's code, and raises on a CUDA
    error."""
    args = []
    calls = fake_kernel_library(monkeypatch, [0, 0, 700], args)
    w = torch.zeros(24, 8, 3, 3, dtype=torch.bfloat16)
    for code, dt in enumerate((torch.float32, torch.bfloat16)):
        u = wg.weight_tc(w, dt)
        assert u.shape == (16, 24, 16) and u.dtype == dt
        assert args[-1][1] == u.data_ptr() and args[-1][2:5] == (24, 8, code)
    assert calls == ["tt_wino_weight"] * 2
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wg.weight_tc(w, torch.bfloat16)


def test_wrapper_source_fields():
    """The bodies' file is the source; no CUDA-core body is left."""
    assert wg.winograd_conv3x3.source.endswith("csrc/winograd_tc.cu")
    assert not hasattr(wg.winograd_conv3x3, "core_source")
    assert wg.winograd_conv3x3.replaces == "tango_tpu/ops/winograd.py:100"
