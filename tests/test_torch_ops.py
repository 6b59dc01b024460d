"""Port ops vs the JAX package on the CPU.

Each CUDA kernel's plain PyTorch version (the path its wrapper takes for a CPU
tensor) is held against the Pallas kernel it replaces, run in interpret mode,
on the same numpy inputs. The dispatching entry points (`group_norm`,
`multi_head_attention`) are held against their JAX counterparts.

Tolerances are those of the JAX kernel tests (tests/test_gn_pallas.py,
tests/test_flash_attention.py): f32 atol 2e-5 / rtol 1e-4 (3e-5 for the
two-stage GN, as there), bf16 2e-2, and the extreme-logit rows 5e-5 / 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.ops import attention as jattn
from tango_tpu.ops import basic as jbasic
from tango_tpu.ops.flash_attention import flash_attention as j_flash
from tango_tpu.ops.gn_silu_pallas import group_norm_pallas, group_norm_pallas2
from tango_tpu_torch.ops import KERNELS, int8_gemm, winograd  # noqa: F401 (registers them)
from tango_tpu_torch.ops import attention as tattn
from tango_tpu_torch.ops import basic as tbasic
from tango_tpu_torch.ops.flash_attention import attn_fwd, attn_fwd_plain
from tango_tpu_torch.ops.gn_silu import (
    gn_apply,
    gn_silu_fwd,
    gn_stats,
    gn_stats_plain,
    group_norm_two_stage,
    n_chunks,
)

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)


def _nhwc(x):  # port (B, C, H, W) -> JAX (B, H, W, C)
    return np.transpose(x, (0, 2, 3, 1))


def _gn_inputs(shape_nhwc, seed, loc=0.5, scale=2.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape_nhwc) * scale + loc).astype(np.float32)
    c = shape_nhwc[-1]
    g = (rng.randn(c) * 0.2 + 1.0).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    return x, g, b


def _port_gn(fn, x_nhwc, g, b, *args, dtype=torch.float32, **kw):
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x_nhwc, (0, 3, 1, 2)))).to(dtype)
    out = fn(xt, torch.from_numpy(g), torch.from_numpy(b), *args, **kw)
    return _nhwc(out.float().numpy())


@pytest.mark.parametrize(
    "shape,groups,act",
    [
        ((2, 16, 8, 64), 8, "silu"),
        ((2, 8, 4, 128), 32, None),
        ((3, 37, 8, 64), 8, "silu"),  # odd spatial size
    ],
)
def test_gn_single_pass_plain_matches_pallas(shape, groups, act):
    x, g, b = _gn_inputs(shape, 0)
    ref = group_norm_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), groups, 1e-6,
                            act=act, interpret=True)
    out = _port_gn(gn_silu_fwd, x, g, b, groups, 1e-6, act)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_gn_single_pass_plain_bf16_matches_pallas():
    x, g, b = _gn_inputs((2, 32, 8, 64), 1, loc=0.0, scale=1.0)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = group_norm_pallas(xb, jnp.asarray(g), jnp.asarray(b), 8, 1e-5, act="silu",
                            interpret=True)
    x_rounded = np.asarray(xb, np.float32)
    out = _port_gn(gn_silu_fwd, x_rounded, g, b, 8, 1e-5, "silu", dtype=torch.bfloat16)
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize(
    "shape,groups,act",
    [
        ((2, 64, 8, 64), 16, "silu"),   # 512 positions -> 2 chunks
        ((1, 128, 64, 32), 32, "silu"),  # VAE-like map -> 16 chunks
        ((3, 37, 8, 64), 8, None),       # odd spatial -> 1 chunk
    ],
)
def test_gn_two_stage_plain_matches_pallas(shape, groups, act):
    x, g, b = _gn_inputs(shape, 3, loc=0.3, scale=1.5)
    ref = group_norm_pallas2(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), groups, 1e-5,
                             act=act, interpret=True)
    out = _port_gn(group_norm_two_stage, x, g, b, groups, 1e-5, act)
    np.testing.assert_allclose(out, np.asarray(ref), atol=3e-5, rtol=1e-4)


def test_gn_stats_partials_sum_to_group_totals():
    """The chunked partial sums of gn_stats add up to each group's sums."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 32, 16, 32).astype(np.float32))
    chunks = n_chunks(16 * 32)
    assert chunks == 2
    parts = gn_stats(x, 8, chunks)
    assert parts.shape == (2, 8, chunks, 2)
    whole = gn_stats_plain(x, 8, 1)[:, :, 0]
    torch.testing.assert_close(parts.sum(2), whole, atol=1e-3, rtol=1e-5)


def test_n_chunks_rule():
    # the JAX `_chunks` rule: the largest of 512/256/128/64 giving >= 2 chunks
    assert [n_chunks(s) for s in (4096, 512, 256, 192, 37)] == [8, 2, 2, 3, 1]


@pytest.mark.parametrize(
    "shape,groups,branch",
    [
        ((2, 16, 8, 64), 8, "single"),
        ((1, 4096, 4, 160), 32, "two_stage"),   # 10.5 MB f32 sample
        ((1, 8320, 1, 256), 128, "reference"),  # over 8 MB, and more than 64 groups
    ],
)
def test_group_norm_dispatch_matches_jax(shape, groups, branch, monkeypatch):
    x, g, b = _gn_inputs(shape, 5)
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    taken = {
        "single": tbasic.gn_single_pass_supported(xt, groups),
        "two_stage": (not tbasic.gn_single_pass_supported(xt, groups)
                      and tbasic.gn_two_stage_supported(xt, groups)),
        "reference": (not tbasic.gn_single_pass_supported(xt, groups)
                      and not tbasic.gn_two_stage_supported(xt, groups)),
    }
    assert taken[branch]
    ref = jbasic.group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), groups, 1e-5,
                            act="silu")
    out = _port_gn(tbasic.group_norm, x, g, b, groups, 1e-5, "silu")
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=1e-4)


def _qkv(b, h, sq, skv, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for s in (sq, skv, skv)]


def _port_attn(q, k, v, scale, dtype=torch.float32):
    b, h, sq, d = q.shape
    t = [torch.from_numpy(a.reshape(b * h, a.shape[2], d)).to(dtype) for a in (q, k, v)]
    out = attn_fwd(*t, scale)
    return out.float().numpy().reshape(b, h, sq, d)


@pytest.mark.parametrize(
    "b,h,sq,skv,d",
    [
        (2, 4, 256, 256, 64),   # self-attention level shape
        (2, 2, 256, 64, 64),    # short key set
        (1, 5, 512, 512, 32),
        (1, 2, 300, 200, 16),   # ragged tiles
    ],
)
def test_attn_plain_matches_pallas(b, h, sq, skv, d):
    q, k, v = _qkv(b, h, sq, skv, d, 0)
    scale = d**-0.5
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, interpret=True)
    np.testing.assert_allclose(_port_attn(q, k, v, scale), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_attn_plain_bf16_matches_pallas():
    q, k, v = _qkv(1, 2, 256, 256, 64, 1)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = j_flash(qb, kb, vb, scale=0.125, interpret=True)
    rounded = [np.asarray(a, np.float32) for a in (qb, kb, vb)]
    out = _port_attn(*rounded, 0.125, dtype=torch.bfloat16)
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=2e-2, rtol=2e-2)


def _extreme_qk(sign, ck_base, seed):
    """tests/test_flash_attention.py: q rows ~ c*u, k rows ~ sign*|g|*u, so
    every logit is ~ sign * large with an O(1) spread inside each row."""
    rng = np.random.RandomState(seed)
    sq, skv, d = 128, 256, 64
    u = rng.randn(d)
    u /= np.linalg.norm(u)
    cq = 2.0 + 0.2 * rng.rand(sq, 1)
    ck = ck_base + 8.0 * rng.rand(skv, 1)
    q = (cq * u[None, :] + 0.01 * rng.randn(sq, d)).astype(np.float32)[None, None]
    k = (sign * ck * u[None, :] + 0.01 * rng.randn(skv, d)).astype(np.float32)[None, None]
    v = rng.randn(1, 1, skv, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_attn_plain_extreme_logits(sign):
    q, k, v = _extreme_qk(sign, 220.0, 0)
    scale = 64**-0.5
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, interpret=True)
    out = _port_attn(q, k, v, scale)
    assert np.all(np.isfinite(out)) and np.abs(out).max() > 1e-3
    np.testing.assert_allclose(out, np.asarray(ref), atol=5e-5, rtol=1e-3)


def test_attn_plain_underflow_row_is_zero_not_nan():
    q, k, v = _extreme_qk(-1.0, 480.0, 1)
    scale = 64**-0.5
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                             interpret=True))
    out = _port_attn(q, k, v, scale)
    assert np.all(np.isfinite(out)) and np.abs(out).max() == 0.0
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize(
    "sq,skv,heads,inner,masked,route",
    [
        (256, 256, 4, 128, False, "flash"),  # UNet self-attention: the kernel
        (256, 16, 2, 64, True, "plain"),     # cross-attention to short text: plain
        (64, 64, 4, 128, False, "plain"),    # Sq < 256: plain
        (256, 256, 2, 64, True, "bias"),     # biased Skv >= 256: the bias kernel
    ],
)
def test_multi_head_attention_dispatch_matches_jax(sq, skv, heads, inner, masked, route,
                                                   monkeypatch):
    rng = np.random.RandomState(7)
    q = rng.randn(2, sq, inner).astype(np.float32)
    k = rng.randn(2, skv, inner).astype(np.float32)
    v = rng.randn(2, skv, inner).astype(np.float32)
    bias = None
    if masked:
        mask = np.ones((2, 1, skv), np.float32)
        mask[:, :, skv // 2:] = 0.0
        bias = (1.0 - mask) * -10000.0
    calls = []
    for name in ("flash_attention", "biased_flash_attention"):
        orig = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, _f=orig, **kw:
                            calls.append(_n) or _f(*a, **kw))
    ref = jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     heads=heads,
                                     bias=None if bias is None else jnp.asarray(bias))
    out = tattn.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), heads=heads,
                                     bias=None if bias is None else torch.from_numpy(bias))
    assert calls == {"flash": ["flash_attention"], "bias": ["biased_flash_attention"],
                     "plain": []}[route]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_geglu_and_silu_match_jax():
    x = np.random.RandomState(8).randn(4, 32).astype(np.float32) * 3
    np.testing.assert_allclose(tbasic.geglu(torch.from_numpy(x)).numpy(),
                               np.asarray(jbasic.geglu(jnp.asarray(x))), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tbasic.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(jbasic.silu(jnp.asarray(x))), atol=1e-6, rtol=1e-5)


def test_wrappers_reject_what_kernels_do_not_take():
    x = torch.zeros(2, 8, 4, 4)
    g, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(TypeError):
        gn_silu_fwd(x.half(), g, b, 4)
    with pytest.raises(ValueError):
        gn_silu_fwd(x.transpose(2, 3), g, b, 4)  # not contiguous
    with pytest.raises(ValueError):
        gn_silu_fwd(x, g, b, 3)  # 8 channels, 3 groups
    with pytest.raises(ValueError):
        gn_apply(x, torch.zeros(2, 8, dtype=torch.float64), torch.zeros(2, 8), None)
    with pytest.raises(ValueError):
        attn_fwd(torch.zeros(2, 4, 8), torch.zeros(2, 5, 8), torch.zeros(2, 4, 8), 1.0)
    with pytest.raises(TypeError):
        attn_fwd(torch.zeros(2, 4, 8), torch.zeros(2, 4, 8).double(), torch.zeros(2, 4, 8), 1.0)


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor that is neither on the CPU nor on a CUDA card reaches no plain
    version: the wrappers raise instead of computing somewhere else."""
    x = torch.empty(2, 8, 4, 4, device="meta")
    with pytest.raises(RuntimeError):
        gn_silu_fwd(x, torch.ones(8), torch.zeros(8), 4)
    with pytest.raises(RuntimeError):
        gn_stats(x, 4, 2)
    q = torch.empty(2, 64, 64, device="meta")
    with pytest.raises(RuntimeError):
        attn_fwd(q, q, q, 0.125)


def test_plain_path_counts_no_launches():
    for fn in KERNELS.values():
        fn.launches = 0
    q = torch.randn(1, 64, 16)
    attn_fwd_plain(q, q, q, 0.25)
    attn_fwd(q, q, q, 0.25)
    gn_silu_fwd(torch.randn(1, 8, 4, 4), torch.ones(8), torch.zeros(8), 4)
    assert sorted(KERNELS) == ["attn_fwd", "attn_fwd_bias", "attn_fwd_v2", "gn_apply",
                               "gn_silu_fwd", "gn_stats", "w8a8_matmul", "winograd_conv3x3"]
    assert all(fn.launches == 0 for fn in KERNELS.values())
