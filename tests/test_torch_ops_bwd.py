"""Backward ops of the port vs the JAX package on the CPU.

The plain versions of the backward kernels (the path their wrappers take for
a CPU tensor) are held against the Pallas backward kernels they replace, run
in interpret mode on the same numpy inputs, at the JAX kernel tests' shapes
and tolerances: attention atol 1e-4 / rtol 1e-3
(tests/test_flash_attention.py:131-158), GroupNorm atol 2e-4 / rtol 1e-3
(tests/test_gn_pallas.py:69-92). The bf16 cases use the bf16 limit of the
kernel tests, 2e-2. The autograd Functions of `group_norm` and
`multi_head_attention` are held against torch autograd through the plain
forward, at the same tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.ops.flash_attention import flash_attention_bwd as j_flash_bwd
from tango_tpu.ops.gn_silu_pallas import group_norm_pallas_bwd
from tango_tpu_torch.ops import BACKWARD_KERNELS, KERNELS, all_kernels
from tango_tpu_torch.ops import attention as tattn
from tango_tpu_torch.ops import basic as tbasic
from tango_tpu_torch.ops.flash_attention import (
    attn_bwd_dkv,
    attn_bwd_dkv_plain,
    attn_bwd_dq,
    attn_bwd_dq_plain,
    flash_attention_bwd,
    flash_bwd_supported,
)
from tango_tpu_torch.ops.gn_silu import (
    gn_bwd_apply,
    gn_bwd_apply_plain,
    gn_bwd_stats,
    gn_bwd_stats_plain,
    gn_bwd_supported,
    gn_silu_bwd,
    gn_silu_bwd_plain,
    group_stats,
    group_sums,
)

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)


def _qkvg(b, h, sq, skv, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32), rng.randn(b, h, skv, d).astype(np.float32),
            rng.randn(b, h, skv, d).astype(np.float32), rng.randn(b, h, sq, d).astype(np.float32))


def _flat(x, dtype=torch.float32):  # (B, H, S, D) numpy -> (B*H, S, D) torch
    return torch.from_numpy(x.reshape(-1, *x.shape[2:])).to(dtype)


@pytest.mark.parametrize(
    "b,h,sq,skv,d",
    [
        (1, 2, 256, 256, 64),   # single q/kv block
        (1, 2, 512, 512, 64),   # multi-block both axes
        (2, 1, 384, 128, 64),   # Sq != Skv
    ],
)
def test_attn_bwd_plain_matches_pallas(b, h, sq, skv, d):
    q, k, v, g = _qkvg(b, h, sq, skv, d, 7)
    scale = d**-0.5
    rq, rk, rv = j_flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
                             scale=scale, interpret=True)
    dq, dk, dv = flash_attention_bwd(_flat(q), _flat(k), _flat(v), _flat(g), scale)
    for out, ref in ((dq, rq), (dk, rk), (dv, rv)):
        np.testing.assert_allclose(out.numpy().reshape(ref.shape), np.asarray(ref),
                                   atol=1e-4, rtol=1e-3)


def test_attn_bwd_plain_bf16_matches_pallas():
    q, k, v, g = _qkvg(1, 2, 256, 256, 64, 8)
    qb, kb, vb, gb = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, g))
    rq, rk, rv = j_flash_bwd(qb, kb, vb, gb, scale=0.125, interpret=True)
    tq, tk, tv, tg = (_flat(np.asarray(t, np.float32), torch.bfloat16) for t in (qb, kb, vb, gb))
    dq, dk, dv = flash_attention_bwd(tq, tk, tv, tg, 0.125)
    for out, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy().reshape(ref.shape),
                                   np.asarray(ref, np.float32), atol=2e-2, rtol=2e-2)


def test_attn_bwd_stats_are_exact_softmax():
    """lse is log-sum-exp of the scaled logits and delta = sum p * dp: what
    _bwd_dq_kernel hands to _bwd_dkv_kernel."""
    q, k, v, g = (_flat(t) for t in _qkvg(1, 2, 128, 256, 32, 9))
    _, lse, delta = attn_bwd_dq(q, k, v, g, 0.2)
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * 0.2
    p = torch.softmax(s, -1)
    dp = torch.matmul(g.double(), v.double().transpose(-1, -2))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(delta.numpy(), (p * dp).sum(-1).numpy(), atol=1e-4, rtol=1e-4)
    dk, dv = attn_bwd_dkv(q, k, v, g, lse, delta, 0.2)
    rk, rv = attn_bwd_dkv_plain(q, k, v, g, lse, delta, 0.2)
    assert torch.equal(dk, rk) and torch.equal(dv, rv)


def _nchw(x):  # JAX (B, H, W, C) -> port (B, C, H, W)
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


@pytest.mark.parametrize(
    "shape,groups,act",
    [
        ((2, 64, 8, 128), 16, "silu"),
        ((2, 32, 4, 320), 32, None),
    ],
)
def test_gn_bwd_plain_matches_pallas(shape, groups, act):
    rng = np.random.RandomState(5)
    x = (rng.randn(*shape) * 1.7 + 0.4).astype(np.float32)
    scale = (rng.randn(shape[-1]) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    rx, rs, rb = group_norm_pallas_bwd(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                       jnp.asarray(g), groups, 1e-5, act, interpret=True)
    dx, ds, db = gn_silu_bwd(torch.from_numpy(_nchw(x)), torch.from_numpy(_nchw(g)),
                             torch.from_numpy(scale), torch.from_numpy(bias), groups, 1e-5, act)
    np.testing.assert_allclose(np.transpose(dx.numpy(), (0, 2, 3, 1)), np.asarray(rx),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(ds.numpy(), np.asarray(rs), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(db.numpy(), np.asarray(rb), atol=2e-4, rtol=1e-3)


def test_gn_bwd_plain_bf16_matches_pallas():
    rng = np.random.RandomState(6)
    shape = (2, 16, 8, 64)
    x = jnp.asarray(rng.randn(*shape) * 1.5, jnp.bfloat16)
    g = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
    scale = (rng.randn(64) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    rx, rs, rb = group_norm_pallas_bwd(x, jnp.asarray(scale), jnp.asarray(bias), g, 8, 1e-5,
                                       "silu", interpret=True)
    tx, tg = (torch.from_numpy(_nchw(np.asarray(t, np.float32))).bfloat16() for t in (x, g))
    dx, ds, db = gn_silu_bwd(tx, tg, torch.from_numpy(scale), torch.from_numpy(bias), 8, 1e-5,
                             "silu")
    assert dx.dtype == torch.bfloat16 and ds.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(np.transpose(dx.float().numpy(), (0, 2, 3, 1)),
                               np.asarray(rx, np.float32), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(ds.numpy(), np.asarray(rs), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(db.numpy(), np.asarray(rb), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("slabs", [1, 2, 4])
@pytest.mark.parametrize("act", ["silu", None])
def test_gn_split_bwd_plain_matches_whole_and_pallas(slabs, act):
    """The split backward (sequence parallelism) over 1, 2 and 4 slabs of
    the first spatial axis: each slab's gn_bwd_stats with the whole's
    statistics, the group sums added over the slabs (the all-reduce), each
    slab's gn_bwd_apply over the whole group's count; dgamma, dbeta the
    slabs' sums over the batch. Against gn_silu_bwd_plain on the whole and
    JAX's _gn_bwd_kernel in interpret mode, f32, at the GroupNorm limits."""
    rng = np.random.RandomState(7)
    shape, groups = (2, 8, 16, 64), 16   # JAX layout (B, H, W, C)
    x = (rng.randn(*shape) * 1.7 + 0.4).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    scale = (rng.randn(shape[-1]) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    rx, rs, rb = group_norm_pallas_bwd(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                       jnp.asarray(g), groups, 1e-5, act, interpret=True)
    tx, tg = torch.from_numpy(_nchw(x)), torch.from_numpy(_nchw(g))
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    count = tx[0, :shape[-1] // groups].numel()
    mean, inv = group_stats(group_sums(tx, groups), count, 1e-5)
    xs, gs = tx.chunk(slabs, 2), tg.chunk(slabs, 2)
    stats = [gn_bwd_stats(a.contiguous(), b.contiguous(), mean, inv, ts, tb, act)
             for a, b in zip(xs, gs)]
    sums = sum(st[0] for st in stats)
    dx = torch.cat([gn_bwd_apply(a.contiguous(), b.contiguous(), mean, inv, ts, tb, act, sums,
                                 count) for a, b in zip(xs, gs)], 2)
    dparam = sum(st[1] for st in stats).sum(0)
    wx, ws, wb = gn_silu_bwd_plain(tx, tg, ts, tb, groups, 1e-5, act)
    for got, plain, jax_ref in ((dx, wx, np.transpose(np.asarray(rx), (0, 3, 1, 2))),
                                (dparam[0], ws, rs), (dparam[1], wb, rb)):
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_ref), atol=2e-4, rtol=1e-3)


def test_gn_split_bwd_wrappers_reject():
    x = torch.randn(2, 8, 4, 4)
    mean, inv = torch.zeros(2, 4), torch.ones(2, 4)
    w, b = torch.ones(8), torch.zeros(8)
    sums, dparam = gn_bwd_stats(x, x, mean, inv, w, b, "silu")
    assert sums.shape == (2, 4, 2) and dparam.shape == (2, 2, 8)
    with pytest.raises(ValueError):
        gn_bwd_stats(x, x, mean[:, :3].contiguous(), inv, w, b)  # mean and inv disagree
    with pytest.raises(ValueError):
        gn_bwd_stats(x, x, mean.double(), inv.double(), w, b)  # statistics not f32
    with pytest.raises(ValueError):
        gn_bwd_apply(x, x.transpose(2, 3), mean, inv, w, b, None, sums, 16)  # g not contiguous
    with pytest.raises(ValueError):
        gn_bwd_apply(x, x, mean, inv, w, b, None, sums[:, :, :1], 16)  # sums not (B, G, 2)
    with pytest.raises(ValueError):
        gn_bwd_apply(x, x, mean, inv, w, b, "gelu", sums, 16)


@pytest.mark.parametrize(
    "shape,groups,act,force_two_stage,bwd_kernel",
    [
        ((2, 32, 8, 16), 8, "silu", False, True),    # single-pass forward
        ((2, 16, 4, 6), 4, None, False, True),
        ((2, 32, 8, 16), 8, "silu", True, True),     # two-stage forward
        ((2, 32, 8, 16), 8, "silu", False, False),   # a shape the backward kernel cannot take
    ],
)
def test_group_norm_function_grads_match_autograd(shape, groups, act, force_two_stage,
                                                  bwd_kernel, monkeypatch):
    """group_norm's kernel routes differentiate through gn_silu_bwd (or, for a
    shape it cannot take, the plain reference) to the gradients of plain
    autograd through the plain forward."""
    if force_two_stage:
        monkeypatch.setattr(tbasic, "gn_single_pass_supported", lambda x, g: False)
    if not bwd_kernel:
        monkeypatch.setattr(tbasic, "gn_bwd_supported", lambda x, g: False)
    calls = []
    orig = tbasic.gn_silu_bwd
    monkeypatch.setattr(tbasic, "gn_silu_bwd", lambda *a: calls.append(1) or orig(*a))
    rng = np.random.RandomState(11)
    x = torch.from_numpy((rng.randn(*shape) * 1.5 + 0.3).astype(np.float32)).requires_grad_()
    w = torch.from_numpy((rng.randn(shape[1]) * 0.2 + 1.0).astype(np.float32)).requires_grad_()
    b = torch.from_numpy((rng.randn(shape[1]) * 0.1).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    out = tbasic.group_norm(x, w, b, groups, 1e-5, act)
    got = torch.autograd.grad(out.transpose(2, 3), (x, w, b), g.transpose(2, 3))
    want = torch.autograd.grad(tbasic._gn_reference(x, w, b, groups, 1e-5, act), (x, w, b), g)
    assert len(calls) == int(bwd_kernel)
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("sq,skv,kernel_bwd", [(256, 256, True), (256, 384, True),
                                                (320, 320, False)])
def test_flash_function_grads_match_autograd(sq, skv, kernel_bwd, monkeypatch):
    """multi_head_attention's kernel route differentiates through the two
    backward kernels where flash_bwd_supported holds, else through autograd
    of plain_attention, to the gradients of plain autograd."""
    assert flash_bwd_supported(sq, skv, 32) == kernel_bwd
    calls = []
    orig = tattn.flash_attention_bwd
    monkeypatch.setattr(tattn, "flash_attention_bwd", lambda *a: calls.append(1) or orig(*a))
    rng = np.random.RandomState(12)
    heads, inner = 2, 64
    q, k, v = (torch.from_numpy(rng.randn(2, s, inner).astype(np.float32)).requires_grad_()
               for s in (sq, skv, skv))
    g = torch.from_numpy(rng.randn(2, sq, inner).astype(np.float32))
    got = torch.autograd.grad(tattn.multi_head_attention(q, k, v, heads=heads), (q, k, v), g)

    def plain(q, k, v):
        qh, kh, vh = (t.reshape(2, -1, heads, 32).transpose(1, 2) for t in (q, k, v))
        out = tattn.plain_attention(qh, kh, vh, bias=None, scale=32**-0.5, upcast=True)
        return out.transpose(1, 2).reshape(2, sq, inner)

    want = torch.autograd.grad(plain(q, k, v), (q, k, v), g)
    assert len(calls) == int(kernel_bwd)
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-4, rtol=1e-3)


def test_gn_bwd_supported_has_no_sample_size_limit():
    """Unlike JAX's 8 MB VMEM rule, the backward kernel takes the large
    two-stage maps; it stops at more than 4096 channels a group."""
    big = torch.empty(2, 960, 256, 16, device="meta")
    assert gn_bwd_supported(big, 32)
    assert not gn_bwd_supported(torch.empty(1, 8192, 1, 1, device="meta"), 1)


def test_backward_wrappers_reject_and_raise():
    x = torch.zeros(2, 8, 4, 4)
    w, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError):
        gn_silu_bwd(x, x.transpose(2, 3), w, b, 4)  # g not contiguous
    with pytest.raises(ValueError):
        gn_silu_bwd(x, x.double(), w, b, 4)  # g's dtype differs
    q = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError):
        attn_bwd_dq(q, torch.zeros(2, 5, 8), torch.zeros(2, 5, 8), torch.zeros(2, 5, 8), 1.0)
    with pytest.raises(ValueError):
        attn_bwd_dkv(q, q, q, q, torch.zeros(2, 4, dtype=torch.float64), torch.zeros(2, 4), 1.0)
    # neither CPU nor CUDA: no plain version runs in the kernel's place
    m = torch.empty(2, 8, 4, 4, device="meta")
    with pytest.raises(RuntimeError):
        gn_silu_bwd(m, m, w, b, 4)
    mq = torch.empty(2, 64, 64, device="meta")
    with pytest.raises(RuntimeError):
        attn_bwd_dq(mq, mq, mq, mq, 0.125)


def test_backward_plain_path_counts_no_launches():
    for fn in all_kernels().values():
        fn.launches = 0
    q = torch.randn(1, 128, 16)
    dq, lse, delta = attn_bwd_dq(q, q, q, q, 0.25)
    attn_bwd_dkv(q, q, q, q, lse, delta, 0.25)
    x = torch.randn(1, 8, 4, 4)
    gn_silu_bwd(x, x, torch.ones(8), torch.zeros(8), 4)
    stats = (torch.zeros(1, 4), torch.ones(1, 4), torch.ones(8), torch.zeros(8))
    sums, _ = gn_bwd_stats(x, x, *stats)
    gn_bwd_apply(x, x, *stats, None, sums, 16)
    assert sorted(BACKWARD_KERNELS) == ["attn_bwd_dkv", "attn_bwd_dq", "gn_bwd_apply",
                                        "gn_bwd_stats", "gn_silu_bwd"]
    assert not set(BACKWARD_KERNELS) & set(KERNELS)
    assert all(fn.launches == 0 for fn in all_kernels().values())
    assert all(fn.source.startswith("tango_tpu_torch/csrc/") for fn in BACKWARD_KERNELS.values())
    assert gn_silu_bwd_plain is not gn_silu_bwd and attn_bwd_dq_plain is not attn_bwd_dq
