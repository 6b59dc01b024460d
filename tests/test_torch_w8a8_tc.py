"""The W8A8 tensor-core body (csrc/int8_gemm_tc.cu) on the CPU.

The CUDA body itself runs only on the card (`chip_smoke.py` holds it against
the plain version there, bit for bit). Here: the rule that picks it
(`w8a8_tc_body`) at every shape the int8 serving path and the smoke use and
at the ragged ones; the K split (`w8a8_splits`); the wrapper's scratch,
alignment check and `tc_launches` through the real launch path with the C
library replaced by a recorder; and `tc_emulate`, a plain-torch emulation of
the body's arithmetic (the quantize pass, then int32 products over K padded
to the 128-byte stages in k32 steps, split K, the f32 epilogue), which must
be bit-equal to JAX's `w8a8_matmul` in interpret mode: the integer sums are
exact and the epilogue multiplies in the same order.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.ops import quant as jq
from tango_tpu.ops.int8_gemm import w8a8_matmul as j_w8a8
from tango_tpu_torch import configs, ops
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.ops import int8_gemm as tg
from tests._torch_helpers import fake_kernel_library

torch.set_num_threads(1)

SMS = 132  # the H100's SMs
# (M, K, N) of w8a8_matmul on the int8 path (full-width UNet, CFG batch 2:
# 128 text tokens, 8192 / 2048 / 512 / 128 latent tokens), as chip_smoke.py
# records them, and tests/test_quant.py's shape, which the smoke adds
PATH_SHAPES = [
    (128, 1280, 1280), (128, 1280, 3840), (128, 1280, 10240), (128, 5120, 1280),
    (256, 1024, 640), (256, 1024, 1280), (256, 1024, 2560),
    (512, 1280, 1280), (512, 1280, 3840), (512, 1280, 10240), (512, 5120, 1280),
    (2048, 640, 640), (2048, 640, 1920), (2048, 640, 5120), (2048, 2560, 640),
    (8192, 320, 320), (8192, 320, 960), (8192, 320, 2560), (8192, 1280, 320),
]
W8A8_TEST_SHAPE = (300, 320, 256)
RAGGED = [(37, 70, 24), (5, 3, 8)]  # chip_smoke.py's W8A8_RAGGED: K % 16 != 0
TC_RAGGED = [(37, 64, 24), (5, 32, 7), (70, 2560, 6)]  # its W8A8_TC_RAGGED


@pytest.mark.parametrize("m,k,n", PATH_SHAPES + [W8A8_TEST_SHAPE] + TC_RAGGED)
def test_tc_body_takes_every_path_shape(m, k, n):
    assert tg.w8a8_tc_body(k)
    assert tg.kernel_shape_ok(m, k, n)


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_ragged_shapes_keep_the_dp4a_body(m, k, n):
    assert not tg.w8a8_tc_body(k)


def test_every_full_width_unet_linear_takes_the_tc_body():
    """Every Linear of the full-width UNet (the int8 path quantizes them all)
    has an input width that is a multiple of 16; built on the meta device."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(configs.TANGO_UNET)
    widths = {m.in_features for m in unet.modules() if isinstance(m, torch.nn.Linear)}
    assert widths and all(tg.w8a8_tc_body(k) for k in widths), sorted(widths)


@pytest.mark.parametrize("m,k,n", PATH_SHAPES + [W8A8_TEST_SHAPE, (64, 16384, 64)])
def test_splits_rule(m, k, n):
    """A power of two up to 16, at least 8 K chunks a split, one wave of
    blocks; K splits only at K = 5120 on the int8 path."""
    s = tg.w8a8_splits(m, k, n, SMS)
    tiles, chunks = math.ceil(m / 128) * math.ceil(n / 128), math.ceil(k / 128)
    assert s in (1, 2, 4, 8, 16)
    assert s == 1 or (chunks >= 8 * s and tiles * s <= SMS)
    assert (s > 1) == (k == 5120 and m <= 512) or (m, k, n) == (64, 16384, 64)
    if (m, k, n) == (64, 16384, 64):
        assert s == 16


def tc_emulate(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, splits: int = 1):
    """The tensor-core body's arithmetic in plain torch: (a) the quantize
    pass, row maximum, scale, round half to even, clip; (b) K zero-padded to
    the 128-byte stages, split into `splits` runs of stages, each summed in
    k32 steps in int64 (exact, as the s32 accumulator: every sum stays below
    2^31); the splits' sums added; (c) (float(acc) * scale) * w_scale."""
    m, k = x.shape
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp(min=1e-8) * (1.0 / 127.0)
    xq = torch.round(xf / scale).clamp(-127, 127).to(torch.int64)
    kp = -(-k // 128) * 128
    xq = torch.nn.functional.pad(xq, (0, kp - k))
    wq = torch.nn.functional.pad(w_q.to(torch.int64), (0, kp - k))
    per = -(-(kp // 128) // splits) * 128
    acc = torch.zeros(m, w_q.shape[0], dtype=torch.int64)
    for s0 in range(0, kp, per):
        part = torch.zeros_like(acc)
        for k0 in range(s0, min(s0 + per, kp), 32):
            part += xq[:, k0:k0 + 32] @ wq[:, k0:k0 + 32].t()
        assert part.abs().max() < 2**31
        acc += part
    return (acc.to(torch.int32).float() * scale * w_scale.float()).to(x.dtype)


def _jax_and_port_inputs(m, k, n, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(k, n).astype(np.float32) * 0.05
    q, s = jq.quantize_weight(w)
    x = (rng.randn(m, k) * 0.3).astype(np.float32)
    x[1] = 0.0  # a zero row: the 1e-8 floor
    return x, q, s


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("m,k,n", [W8A8_TEST_SHAPE, (37, 80, 24), (20, 2560, 40)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_emulation_bit_equal_to_pallas(m, k, n, dt, splits):
    """tests/test_quant.py's shape, a K that is not a multiple of 32 (80), and
    a K of 20 stages that splits; f32 and bf16: bit-equal."""
    x, q, s = _jax_and_port_inputs(m, k, n, seed=5)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = j_w8a8(jnp.asarray(x, jdt), jnp.asarray(q), jnp.asarray(s), block_m=256,
                 block_n=128, interpret=True)
    out = tc_emulate(torch.from_numpy(x).to(tdt), torch.from_numpy(q.T.copy()),
                     torch.from_numpy(s), splits)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


def test_emulation_equals_the_plain_version():
    """The plain version (a float64 integer product) and the emulation agree
    bit for bit, so the smoke's comparison of kernel and plain version is a
    bit-equality check of the body."""
    x, q, s = _jax_and_port_inputs(64, 2560, 48, seed=6)
    xt, qt, st = torch.from_numpy(x).bfloat16(), torch.from_numpy(q.T.copy()), torch.from_numpy(s)
    assert torch.equal(tc_emulate(xt, qt, st, 2), tg.w8a8_matmul_plain(xt, qt, st))


def _misaligned(shape, dtype):
    base = torch.zeros(math.prod(shape) + 1, dtype=dtype)
    view = base[1:].view(*shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.fixture
def card(monkeypatch):
    """The device query of the launch path, answered for an H100."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(multi_processor_count=SMS))


def test_launch_path_scratch_alignment_and_counters(monkeypatch, card):
    """The launch path with the C library replaced by a recorder: a TC-rule
    shape passes xq, the scale and (for a split K) the int32 partial sums as
    scratch and counts the reported tensor-core launch; a ragged K passes no
    scratch, launches the __dp4a body and counts none; a misaligned x on the
    tensor-core route raises before any launch."""
    args = []
    calls = fake_kernel_library(monkeypatch, [ops.TC_LAUNCHED, ops.TC_LAUNCHED, 0], args)
    ops.reset_counters()
    fn = tg.w8a8_matmul
    with pytest.raises(ValueError, match="16-byte"):
        tg._launch(_misaligned((4, 64), torch.bfloat16), torch.zeros(8, 64, dtype=torch.int8),
                   torch.ones(8))
    assert calls == [] and fn.launches == 0
    w = torch.zeros(24, 64, dtype=torch.int8)
    y = tg._launch(torch.zeros(37, 64, dtype=torch.bfloat16), w, torch.ones(24))
    assert y.shape == (37, 24) and y.dtype == torch.bfloat16
    xq, scale, part, splits = args[-1][4:8]
    assert xq and scale and part is None and splits == 1
    tg._launch(torch.zeros(64, 5120), torch.zeros(64, 5120, dtype=torch.int8), torch.ones(64))
    xq, scale, part, splits = args[-1][4:8]
    assert part and splits == tg.w8a8_splits(64, 5120, 64, SMS) == 4
    assert fn.launches == 2 and fn.tc_launches == 2
    tg._launch(torch.zeros(37, 70), torch.zeros(24, 70, dtype=torch.int8), torch.ones(24))
    assert args[-1][4:8] == (None, None, None, 1)
    assert fn.launches == 3 and fn.tc_launches == 2 and calls == ["tt_w8a8_gemm"] * 3
    ops.reset_counters()
    assert fn.launches == 0 and fn.tc_launches == 0


def test_tc_launches_count_the_entry_points_report(monkeypatch, card):
    """A report of the other body than the rule names raises (either way
    round) and counts no tensor-core launch; a CUDA error code raises."""
    fake_kernel_library(monkeypatch, [0, ops.TC_LAUNCHED, 700, ops.TC_LAUNCHED])
    ops.reset_counters()
    fn = tg.w8a8_matmul
    tc_args = (torch.zeros(8, 64), torch.zeros(16, 64, dtype=torch.int8), torch.ones(16))
    core_args = (torch.zeros(8, 70), torch.zeros(16, 70, dtype=torch.int8), torch.ones(16))
    with pytest.raises(RuntimeError, match="CUDA-core body against"):
        tg._launch(*tc_args)
    with pytest.raises(RuntimeError, match="tensor-core body against"):
        tg._launch(*core_args)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tg._launch(*tc_args)
    assert fn.tc_launches == 0
    tg._launch(*tc_args)
    assert fn.tc_launches == 1 and fn.launches == 3
    ops.reset_counters()


def test_wrapper_source_fields():
    """The kernels line names the tensor-core source, the __dp4a one beside it."""
    assert tg.w8a8_matmul.source.endswith("csrc/int8_gemm_tc.cu")
    assert tg.w8a8_matmul.core_source.endswith("csrc/int8_gemm.cu")
    assert tg.w8a8_matmul.replaces == "tango_tpu/ops/int8_gemm.py:30"
