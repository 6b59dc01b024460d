"""The biased form of the tensor-core attention body (csrc/attention_tc.cu,
`attn_fwd_bias` in bf16 at head dim 64) on the CPU.

The CUDA body runs only on the card (`chip_smoke.py` holds it against the
plain version there). Here: `tc_walk_bias`, a plain-torch emulation of its
arithmetic (128-key tiles, the bias times log2(e) added to the f32 logits
before the running max, p rounded to bf16 for the PV product, f32
denominators of the unrounded p), held within one bf16 step of JAX's
`_attn_kernel_bias` (through `flash_attention(bias=..., interpret=True)`),
which takes the max over the whole key set at once, and of the port's plain
version; and the wrapper's launch path for it: the alignment check (bias
included) and `tc_launches` through a recording kernel library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tango_tpu.ops.flash_attention as jfa
from tango_tpu_torch import ops
from tango_tpu_torch.ops import flash_attention as tfa
from tests._torch_helpers import fake_kernel_library

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)

TILE = 128  # keys a K/V tile of the bf16 tensor-core body
LOG2_E = np.float32(tfa.LOG2_E)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def tc_walk_bias(q, k, v, bias, heads, scale):
    """The biased tensor-core body's arithmetic on (BH, S, 64) f32 tensors
    that hold bf16 values, bias (B, 1 | Sq, Skv) f32 (head bh adds batch row
    bh // heads): 128-key tiles, l = qs . k + bias * log2(e) in f32, the
    running max of the tiles so far, p = exp2(l - m) rounded to bf16 for the
    PV product, f32 denominators of the unrounded p."""
    qs = _bf16(q * tfa._qscale(scale))
    b = bias.repeat_interleave(heads, 0) * torch.tensor(LOG2_E)
    bh, sq, d = q.shape
    m = torch.full((bh, sq, 1), -1e30)
    den = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    for k0 in range(0, k.shape[1], TILE):
        s = torch.matmul(qs, k[:, k0:k0 + TILE].transpose(-1, -2)) + b[..., k0:k0 + TILE]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        den = alpha * den + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.matmul(_bf16(p), v[:, k0:k0 + TILE])
        m = m_new
    return _bf16(acc / den)


def _inputs(b, h, sq, skv, rows, keep, seed):
    """numpy q, k, v (B, H, S, 64) rounded to bf16, as JAX bf16 arrays and as
    (B*H, S, 64) f32 tensors; a bias (B, rows, Skv): the reference's padding
    mask (0 for the first keep[i] keys of batch row i, -10000 after) plus
    unit noise, so that the max moves from tile to tile."""
    rng = np.random.RandomState(seed)
    arrays = [jnp.asarray(rng.randn(b, h, s, 64).astype(np.float32), jnp.bfloat16)
              for s in (sq, skv, skv)]
    flat = [torch.from_numpy(np.asarray(a, np.float32).reshape(b * h, a.shape[2], 64))
            for a in arrays]
    keys = np.arange(skv)[None, None, :]
    bias = np.where(keys < np.asarray(keep)[:, None, None], 0.0, -10000.0)
    bias = (bias + rng.randn(b, rows, skv)).astype(np.float32)
    return arrays, flat, bias


def _one_bf16_step(ref):
    """The spacing of bf16 values at the output's largest magnitude."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _assert_within_one_step(out, ref):
    step = _one_bf16_step(ref)
    err = np.abs(out - ref).max()
    assert np.isfinite(out).all() and err <= step, f"max abs error {err} > one bf16 step {step}"


CASES = {
    "one_row": (2, 2, 256, 256, 1, (200, 150)),
    "sq_rows": (2, 2, 256, 256, 256, (150, 230)),
    "ragged": (2, 2, 200, 333, 1, (300, 20)),
    "ragged_sq_rows": (2, 1, 200, 333, 200, (333, 90)),
    "masked_batch_row": (2, 2, 256, 256, 1, (100, 0)),
    "padding_second_tile": (2, 2, 256, 256, 1, (100, 60)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tc_walk_bias_matches_pallas(case):
    """The walk within one bf16 step of JAX's biased kernel: one bias row and
    a row a query, ragged Sq and Skv (333 keys: a last tile of 77), a batch
    row whose keys are all masked (finite, as JAX's), and key sets whose
    second tile is all padding (-10000), where the running max of the first
    tile is the final one."""
    b, h, sq, skv, rows, keep = CASES[case]
    (qj, kj, vj), (q, k, v), bias = _inputs(b, h, sq, skv, rows, keep, 31)
    if case == "masked_batch_row":
        bias[1] = -10000.0
    ref = np.asarray(jfa.flash_attention(qj, kj, vj, bias=jnp.asarray(bias)[:, None],
                                         scale=0.125, interpret=True), np.float32)
    out = tc_walk_bias(q, k, v, torch.from_numpy(bias), h, 0.125).numpy().reshape(ref.shape)
    _assert_within_one_step(out, ref)
    if case == "masked_batch_row":  # the masked row alone, at its own magnitude
        _assert_within_one_step(out[1], ref[1])


@pytest.mark.parametrize("rows", [1, 200])
def test_tc_walk_bias_matches_plain_version(rows):
    """The walk against the port's plain version in bf16, which the card
    holds the tensor-core body against (atol 4e-3, rtol 1e-2): within one
    bf16 step, at a ragged shape."""
    _, (q, k, v), bias = _inputs(2, 2, 200, 333, rows, (250, 40), 32)
    bias = torch.from_numpy(bias)
    ref = tfa.attn_fwd_bias_plain(*(t.to(torch.bfloat16) for t in (q, k, v)), bias, 2,
                                  0.125).float().numpy()
    out = tc_walk_bias(q, k, v, bias, 2, 0.125).numpy()
    _assert_within_one_step(out, ref)


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous view whose data starts one element past a 16-byte
    boundary."""
    base = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)
    view = base[1:].view(*shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def test_bias_launch_checks_alignment_and_counts_tc(monkeypatch):
    """attn_fwd_bias's launch path with a recording kernel library: at D = 64
    a misaligned q or bias raises before any launch, in bf16 and in f32 (the
    3xTF32 body); an aligned call counts the reported tensor-core launch and
    passes the bias rows and heads; another head dim, in either type,
    launches the CUDA-core body with no alignment demand and no tc count;
    reset_counters zeroes tc_launches."""
    args = []
    calls = fake_kernel_library(monkeypatch, [ops.TC_LAUNCHED] * 2 + [0] * 2, args)
    ops.reset_counters()
    fn = tfa.attn_fwd_bias
    bias = torch.zeros(2, 1, 128)
    for dt in (torch.bfloat16, torch.float32):
        good = torch.zeros(4, 128, 64, dtype=dt)
        with pytest.raises(ValueError, match="16-byte"):
            tfa._launch_fwd(fn, _misaligned((4, 128, 64), dt), good, good, 0.125, bias, 2)
        with pytest.raises(ValueError, match="16-byte"):
            tfa._launch_fwd(fn, good, good, good, 0.125, _misaligned((2, 1, 128), torch.float32),
                            2)
    assert calls == [] and fn.tc_launches == 0
    for dt in (torch.bfloat16, torch.float32):
        good = torch.zeros(4, 128, 64, dtype=dt)
        tfa._launch_fwd(fn, good, good, good, 0.125, bias, 2)
    assert fn.launches == 2 and fn.tc_launches == 2
    # q, k, v, bias, o pointers, then BH, Sq, Skv, D, heads, bias rows, qscale, dtype, stream
    assert args[0][5:11] == (4, 128, 128, 64, 2, 1) and [a[12] for a in args] == [1, 0]
    for dt in (torch.bfloat16, torch.float32):
        narrow = _misaligned((4, 128, 32), dt)
        tfa._launch_fwd(fn, narrow, narrow, narrow, 0.125, _misaligned((2, 1, 128), torch.float32),
                        2)
    assert fn.launches == 4 and fn.tc_launches == 2 and calls == ["tt_attn_fwd_bias"] * 4
    ops.reset_counters()
    assert fn.launches == 0 and fn.tc_launches == 0


def test_bias_tc_launches_count_the_entry_points_report(monkeypatch):
    """A report of the other body than the rule names raises, either way
    round, and counts no tensor-core launch; a CUDA error raises as one."""
    fake_kernel_library(monkeypatch, [0, ops.TC_LAUNCHED, 700, ops.TC_LAUNCHED])
    ops.reset_counters()
    fn = tfa.attn_fwd_bias
    tc = torch.zeros(2, 128, 64)
    core = torch.zeros(2, 128, 32)
    bias = torch.zeros(1, 1, 128)
    with pytest.raises(RuntimeError, match="CUDA-core body against"):
        tfa._launch_fwd(fn, tc, tc, tc, 0.125, bias, 2)
    with pytest.raises(RuntimeError, match="tensor-core body against"):
        tfa._launch_fwd(fn, core, core, core, 0.125, bias, 2)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tfa._launch_fwd(fn, tc, tc, tc, 0.125, bias, 2)
    assert fn.tc_launches == 0
    tfa._launch_fwd(fn, tc, tc, tc, 0.125, bias, 2)
    assert fn.tc_launches == 1 and fn.launches == 3
    ops.reset_counters()
