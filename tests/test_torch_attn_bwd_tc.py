"""The backward tensor-core body (csrc/attention_bwd_tc.cu) on the CPU.

The CUDA body itself runs only on the card (`chip_smoke.py` holds it against
the plain versions there). Here: the rule that picks it (`bwd_tc_body`), the
wrappers' alignment check and counters for it, and `bwd_walk`, a plain-torch
emulation of its arithmetic: the products under the body's splits (f32:
3xTF32 with round-to-nearest-away splits for all five products, the logits
S and dP and the gradients dQ, dK and dV; bf16: one product each, ds and
p rounded to bf16), its tile walks (64 keys in dq; 32 queries in f32 dkv,
64 in bf16) and dq's online first pass (m, l and dl rescaled as the max grows). The
emulation is held against JAX's `flash_attention_bwd` in interpret mode on
the same numpy inputs, at JAX's f32 limits (atol 1e-4, rtol 1e-3,
tests/test_flash_attention.py:156-158) with q and k at amplitude 1 and 3,
and in bf16 at the bf16 bar of tests/test_torch_ops_bwd.py. Two tests pin
the choice of products: one-product TF32 misses the f32 limits, and split
bf16 on the logit products misses them once the logits are large, where the
hybrid of 3xTF32 logits and split-bf16 gradients meets them on the same
inputs; a third shows that the hybrid's split-bf16 gradient products carry
most of its error there, which is why the body's gradient products are
3xTF32 too (tests/test_torch_attn_f32_tc.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.ops.flash_attention import flash_attention_bwd as j_flash_bwd
from tango_tpu_torch import configs
from tango_tpu_torch import ops
from tango_tpu_torch.ops import flash_attention as tfa
from tests._torch_helpers import fake_kernel_library

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)

F32_TOL = (1e-4, 1e-3)  # JAX's f32 backward limits
BF16_TOL = (2e-2, 2e-2)  # tests/test_torch_ops_bwd.py's bf16 limit against JAX
# streamed rows a tile of the body: (keys in dq, queries in dkv)
TILES = {torch.float32: (64, 32), torch.bfloat16: (64, 64)}


def _unet_head_dims(cfg):
    """Head dims of every attention of a UNet config: channels / heads."""
    return {ch // cfg.heads_for_level(i) for i, ch in enumerate(cfg.block_out_channels)}


@pytest.mark.parametrize("d", tfa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_tc_body_rule(dtype, d):
    """The backward kernels' rule, `bwd_tc_body`: f32 and bf16 at head dim 64
    take the tensor-core body; every other head dim the CUDA-core one, 32
    included, where the forward's static form has a tensor-core body
    (`tc_body`); a type the kernels do not take has none."""
    assert tfa.bwd_tc_body(dtype, d) == (d == 64)
    assert not tfa.bwd_tc_body(torch.float16, d)
    assert tfa.tc_body(dtype, d, "static") == (d in (32, 64))


def test_bwd_tc_body_takes_every_full_width_unet_attention():
    """Every attention of the full-width UNet has head dim 64: its backward,
    like its forward, takes the tensor-core body in the trainer's f32 and in
    bf16."""
    dims = _unet_head_dims(configs.TANGO_UNET)
    assert dims == {64}
    assert all(tfa.bwd_tc_body(dt, d) and tfa.tc_body(dt, d, "static")
               for d in dims for dt in (torch.float32, torch.bfloat16))


def _misaligned(shape, dtype=torch.float32):
    """A contiguous view whose data starts one element past a 16-byte
    boundary."""
    base = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)
    view = base[1:].view(*shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _launch_dq(q, k, v, do):
    return tfa._launch_dq(q, k, v, do, 0.125)


def _launch_dkv(q, k, v, do):
    stats = torch.zeros(q.shape[:2])
    return tfa._launch_dkv(q, k, v, do, stats, stats, 0.125)


@pytest.mark.parametrize("fn,launch", [(tfa.attn_bwd_dq, _launch_dq),
                                       (tfa.attn_bwd_dkv, _launch_dkv)])
def test_bwd_launch_checks_alignment_and_counts_tc(fn, launch, monkeypatch):
    """The wrappers' launch path (with the C library replaced by a recorder
    that reports the body a C entry point would launch): a misaligned f32 or
    bf16 D = 64 view raises before any launch; an aligned one launches and
    counts the reported tensor-core launch in either type; another head dim
    launches the CUDA-core body with no alignment demand and no tc count;
    reset_counters zeroes tc_launches."""
    calls = fake_kernel_library(monkeypatch, [ops.TC_LAUNCHED, ops.TC_LAUNCHED, 0])
    ops.reset_counters()
    good = torch.zeros(2, 128, 64)
    for dt in (torch.float32, torch.bfloat16):
        g = good.to(dt)
        with pytest.raises(ValueError, match="16-byte"):
            launch(g, g, _misaligned((2, 128, 64), dt), g)
    assert calls == [] and fn.tc_launches == 0
    launch(good, good, good, good)
    launch(*(good.to(torch.bfloat16),) * 4)
    assert fn.launches == 2 and fn.tc_launches == 2
    odd = _misaligned((2, 128, 32))
    launch(odd, odd, odd, odd)
    assert fn.launches == 3 and fn.tc_launches == 2 and calls == [f"tt_{fn.__name__}"] * 3
    ops.reset_counters()
    assert fn.launches == 0 and fn.tc_launches == 0


@pytest.mark.parametrize("name", ["attn_fwd", "attn_fwd_v2", "attn_bwd_dq", "attn_bwd_dkv"])
def test_tc_launches_count_the_entry_points_report(name, monkeypatch):
    """tc_launches counts what the C entry point reports, not the wrapper's
    copy of its rule: a report of the other body than the rule names raises
    (either way round: head dim 64, and 16, which every kernel runs on its
    CUDA-core body) and counts no tensor-core launch; a CUDA error code
    raises as one."""
    fn = getattr(tfa, name)
    tc_dtype = torch.bfloat16 if name.startswith("attn_fwd") else torch.float32
    launch = {"attn_fwd": lambda *t: tfa._launch_fwd(fn, *t[:3], 0.125),
              "attn_fwd_v2": lambda *t: tfa._launch_fwd(fn, *t[:3], 0.125),
              "attn_bwd_dq": _launch_dq, "attn_bwd_dkv": _launch_dkv}[name]
    fake_kernel_library(monkeypatch, [0, ops.TC_LAUNCHED, 700, ops.TC_LAUNCHED])
    ops.reset_counters()
    tc = torch.zeros(2, 128, 64, dtype=tc_dtype)
    core = torch.zeros(2, 128, 16, dtype=tc_dtype)
    with pytest.raises(RuntimeError, match="CUDA-core body against"):
        launch(tc, tc, tc, tc)
    with pytest.raises(RuntimeError, match="tensor-core body against"):
        launch(core, core, core, core)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        launch(tc, tc, tc, tc)
    assert fn.tc_launches == 0
    launch(tc, tc, tc, tc)
    assert fn.tc_launches == 1 and fn.launches == 3
    ops.reset_counters()


# --------------------------------------------- the body's arithmetic in torch


def rna_tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from zero
    (the carry of the low 13 bits goes into the magnitude)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16(x):
    return x.to(torch.bfloat16).float()


def product(a, b, scheme):
    """a @ b in f32 as the body computes it: "3xtf32" and "split_bf16" take
    hi = split(x), lo = split(x - hi) of both operands and add the cross terms
    a_hi b_lo + a_lo b_hi to a_hi b_hi; "tf32" and "bf16" one product of the
    rounded operands; "f32" the plain product."""
    if scheme == "f32":
        return a @ b
    if scheme in ("tf32", "bf16"):
        r = rna_tf32 if scheme == "tf32" else bf16
        return r(a) @ r(b)
    split = rna_tf32 if scheme == "3xtf32" else bf16
    ah, bh = split(a), split(b)
    return (ah @ split(b - bh) + split(a - ah) @ bh) + ah @ bh


def bwd_walk(q, k, v, do, scale, logit="3xtf32", grad="3xtf32", tiles=(64, 32),
             bf16_io=False):
    """(dq, dk, dv, lse, delta) of (BH, S, D) f32 tensors by the body's
    arithmetic: base-2 logits t = (q . k) * scale * log2 e; dq's first pass
    over key tiles carries m, l = sum exp2(t - m) and dl = sum exp2(t - m) dp,
    rescaled when m grows; its second recomputes S and dP and adds dS K; dkv
    walks query tiles with p = exp2(t - lse * log2 e). bf16_io rounds ds (and
    p before dV) to bf16 and the outputs to bf16, as the bf16 body does;
    tiles are the (dq, dkv) tile rows."""
    rnd = bf16 if bf16_io else (lambda x: x)
    tile, qtile = tiles
    c2 = float(np.float32(scale * tfa.LOG2_E))
    bh, sq, d = q.shape
    skv = k.shape[1]
    kt, vt = k.transpose(-1, -2), v.transpose(-1, -2)
    m = torch.full((bh, sq, 1), -math.inf)
    l = torch.zeros(bh, sq, 1)
    dl = torch.zeros(bh, sq, 1)
    for k0 in range(0, skv, tile):
        t = product(q, kt[..., k0:k0 + tile], logit) * c2
        dp = product(do, vt[..., k0:k0 + tile], logit)
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        alpha, e = torch.exp2(m - m_new), torch.exp2(t - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        dl = dl * alpha + (e * dp).sum(-1, keepdim=True)
        m = m_new
    lse2, delta = m + torch.log2(l), dl / l
    dq = torch.zeros(bh, sq, d)
    for k0 in range(0, skv, tile):
        t = product(q, kt[..., k0:k0 + tile], logit) * c2
        dp = product(do, vt[..., k0:k0 + tile], logit)
        ds = rnd(torch.exp2(t - lse2) * (dp - delta) * scale)
        dq = dq + product(ds, k[:, k0:k0 + tile], grad)
    lse = (lse2 * math.log(2.0))[..., 0]
    delta = delta[..., 0]
    lse2_in = lse * tfa.LOG2_E  # dkv reads lse in natural units
    qt, dot = q.transpose(-1, -2), do.transpose(-1, -2)
    dk = torch.zeros(bh, skv, d)
    dv = torch.zeros(bh, skv, d)
    for q0 in range(0, sq, qtile):
        rows = slice(q0, q0 + qtile)
        t = product(k, qt[..., rows], logit) * c2  # (keys, queries)
        dpt = product(v, dot[..., rows], logit)
        p = torch.exp2(t - lse2_in[:, None, rows])
        ds = rnd(p * (dpt - delta[:, None, rows]) * scale)
        dv = dv + product(rnd(p), do[:, rows], grad)
        dk = dk + product(ds, q[:, rows], grad)
    return rnd(dq), rnd(dk), rnd(dv), lse, delta


def _inputs(b, h, sq, skv, amp, seed, dtype=jnp.float32, d=64):
    """numpy q, k (at amplitude amp), v, do (B, H, S, d) in dtype, as JAX
    arrays and as (B*H, S, d) f32 torch tensors holding the same values."""
    rng = np.random.RandomState(seed)
    shapes = ((sq, amp), (skv, amp), (skv, 1.0), (sq, 1.0))
    arrays = [jnp.asarray((rng.randn(b, h, s, d) * a).astype(np.float32), dtype)
              for s, a in shapes]
    flat = [torch.from_numpy(np.array(x, np.float32).reshape(b * h, x.shape[2], d))
            for x in arrays]
    return arrays, flat


def _ratio(out, ref, tol):
    """The largest |out - ref| / (atol + rtol |ref|): at most 1 meets tol."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(out - ref) / (tol[0] + tol[1] * np.abs(ref))).max())


def _pallas(arrays):
    return [np.asarray(g, np.float32) for g in j_flash_bwd(*arrays, scale=0.125,
                                                           interpret=True)]


@pytest.mark.parametrize("amp", [1.0, 3.0])
@pytest.mark.parametrize("s", [256, 512])
def test_bwd_walk_f32_matches_pallas(s, amp):
    """The f32 body (3xTF32 logits and gradients, its tile walks) within
    JAX's f32 limits of the Pallas backward kernels, with q and
    k at amplitude 1 and 3; its lse and delta within the same limits of the
    port's plain attn_bwd_dq."""
    arrays, (q, k, v, do) = _inputs(1, 2, s, s, amp, 21)
    refs = _pallas(arrays)
    dq, dk, dv, lse, delta = bwd_walk(q, k, v, do, 0.125, tiles=TILES[torch.float32])
    for out, ref in zip((dq, dk, dv), refs):
        np.testing.assert_allclose(out.numpy().reshape(ref.shape), ref, atol=F32_TOL[0],
                                   rtol=F32_TOL[1])
    _, rl, rd = tfa.attn_bwd_dq_plain(q, k, v, do, 0.125)
    np.testing.assert_allclose(lse.numpy(), rl.numpy(), atol=F32_TOL[0], rtol=F32_TOL[1])
    np.testing.assert_allclose(delta.numpy(), rd.numpy(), atol=F32_TOL[0], rtol=F32_TOL[1])


@pytest.mark.parametrize("s", [256, 512])
def test_bwd_walk_bf16_matches_pallas(s):
    """The bf16 body (one bf16 product each, ds and p rounded to bf16, its
    tile walks) within the bf16 limit of the Pallas backward kernels."""
    arrays, (q, k, v, do) = _inputs(1, 2, s, s, 1.0, 22, jnp.bfloat16)
    refs = _pallas(arrays)
    outs = bwd_walk(q, k, v, do, 0.125, logit="bf16", grad="bf16",
                    tiles=TILES[torch.bfloat16], bf16_io=True)
    for out, ref in zip(outs[:3], refs):
        np.testing.assert_allclose(out.numpy().reshape(ref.shape), ref, atol=BF16_TOL[0],
                                   rtol=BF16_TOL[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_walk_matches_plain_versions_ragged(dtype):
    """The walk against the port's plain versions, which the card holds the
    body against, at the smoke's ragged shape (200 queries, 333 keys: ragged
    tiles on both sides) and the smoke's limits: f32 1e-4 / 1e-3, bf16
    4e-3 / 1e-2; lse and delta 1e-4 / 1e-3."""
    _, (q, k, v, do) = _inputs(1, 3, 200, 333, 1.0, 23, jnp.bfloat16 if dtype ==
                               torch.bfloat16 else jnp.float32)
    tol = F32_TOL if dtype == torch.float32 else (4e-3, 1e-2)
    schemes = {} if dtype == torch.float32 else dict(logit="bf16", grad="bf16", bf16_io=True)
    dq, dk, dv, lse, delta = bwd_walk(q, k, v, do, 0.125, tiles=TILES[dtype], **schemes)
    tq, tk, tv, tdo = (t.to(dtype) for t in (q, k, v, do))
    rq, rl, rd = tfa.attn_bwd_dq_plain(tq, tk, tv, tdo, 0.125)
    rk, rv = tfa.attn_bwd_dkv_plain(tq, tk, tv, tdo, rl, rd, 0.125)
    for out, ref in ((dq, rq), (dk, rk), (dv, rv)):
        np.testing.assert_allclose(out.numpy(), ref.float().numpy(), atol=tol[0], rtol=tol[1])
    for out, ref in ((lse, rl), (delta, rd)):
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_TOL[0], rtol=F32_TOL[1])


def _float64_grads(q, k, v, do, scale):
    """dq, dk, dv of softmax(q k^T scale) v in float64."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, -1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    return ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


def _worst_ratio(scheme_logit, scheme_grad, tensors):
    ref = _float64_grads(*tensors, 0.125)
    out = bwd_walk(*tensors, 0.125, logit=scheme_logit, grad=scheme_grad)[:3]
    return max(_ratio(o.numpy(), r.numpy(), F32_TOL) for o, r in zip(out, ref))


def test_one_product_tf32_misses_f32_limits():
    """Plain TF32 (one product of rounded operands, all five products) misses
    JAX's f32 limits against float64 at 256 tokens and unit amplitude; the
    hybrid meets them on the same inputs."""
    _, tensors = _inputs(1, 2, 256, 256, 1.0, 24)
    assert _worst_ratio("tf32", "tf32", tensors) > 1.5
    assert _worst_ratio("3xtf32", "split_bf16", tensors) < 0.5


def test_split_bf16_logits_miss_f32_limits_at_amplitude_3():
    """Split bf16 (three products) on all five products holds at unit
    amplitude, but with q and k at amplitude 3 its logit error, which exp
    passes on as a relative error of p, misses JAX's f32 limits against
    float64 (1024 tokens); the hybrid, 3xTF32 on the logits, meets them."""
    _, tensors = _inputs(1, 2, 1024, 1024, 3.0, 25)
    assert _worst_ratio("split_bf16", "split_bf16", tensors) > 1.0
    assert _worst_ratio("3xtf32", "split_bf16", tensors) < 1.0
    _, unit = _inputs(1, 2, 1024, 1024, 1.0, 25)
    assert _worst_ratio("split_bf16", "split_bf16", unit) < 1.0


@pytest.mark.parametrize("seed", [27, 28, 29])
def test_split_bf16_gradients_carry_most_of_the_error_at_amplitude_3(seed):
    """Where the hybrid's margin goes with q and k at amplitude 3 (512
    tokens): its split-bf16 gradient products, whose hi + lo keep each
    operand to ~2^-17, put it more than 1.5x as far from float64 as the same
    walk with f32 gradient products (whose error is the logits'), still
    within JAX's f32 limits."""
    _, tensors = _inputs(1, 2, 512, 512, 3.0, seed)
    hybrid = _worst_ratio("3xtf32", "split_bf16", tensors)
    assert 1.5 * _worst_ratio("3xtf32", "f32", tensors) < hybrid < 1.0


def test_rna_tf32_rounds_to_nearest_away():
    """The emulated cvt.rna.tf32.f32 keeps 10 mantissa bits and rounds a tie
    away from zero, for either sign; hi + lo of the split is within 2^-21 of
    x."""
    one_ulp = 2.0**-10
    x = torch.tensor([1.0 + 0.5 * one_ulp, -(1.0 + 0.5 * one_ulp), 1.0 + 0.49 * one_ulp,
                      1.0 + 1.5 * one_ulp])
    assert rna_tf32(x).tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + 2 * one_ulp]
    y = torch.from_numpy(np.random.RandomState(26).randn(1000).astype(np.float32)) * 100
    hi = rna_tf32(y)
    lo = rna_tf32(y - hi)
    assert ((hi + lo - y).abs() <= y.abs() * 2.0**-21).all()
