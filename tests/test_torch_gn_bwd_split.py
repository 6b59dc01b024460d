"""The new bodies of the split GroupNorm backward (csrc/gn_silu.cu) on the CPU.

`gn_bwd_stats` runs a thread-block-cluster body and `gn_bwd_apply` a flat
body over the slab's 16-byte packets; both run only on the card
(`chip_smoke.py` holds them against the plain versions there). Here:
`stats_walk` and `apply_walk`, plain-torch emulations of the two bodies'
arithmetic (the group cut into R slices of whole packets, each slice's
per-channel sums combined in rank order, the gamma-weighted group sums; the
per-(b, c) coefficients a, b, k2, k0 and dx = a*dpre + k2*x + k0), summed
over 1, 2 and 4 slabs as sequence parallelism does and held against JAX's
`group_norm_pallas_bwd(interpret=True)` at the limits of
`tests/test_torch_ops_bwd.py::test_gn_split_bwd_plain_matches_whole_and_pallas`
(atol 2e-4, rtol 1e-3 in f32; bf16 2e-2), with and without SiLU, for several
R; the R rule's Python twin (`gn_bwd_stats_cluster_size`) at the 18 slab
shapes of path `sp_train` and at its limits, and the flat grid's
(`gn_bwd_apply_flat_grid`); and the wrappers' launch path with the C library
replaced by a recorder.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.ops.gn_silu_pallas import group_norm_pallas_bwd
from tango_tpu_torch import ops
from tango_tpu_torch.ops import gn_silu as tgn
from tests._torch_helpers import fake_kernel_library

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)


def _dsilu(y):
    """silu'(y) as the bodies take it: s*(1 + y*(1 - s)), s = 1/(1 + e^-y)."""
    s = 1.0 / (1.0 + torch.exp(-y))
    return s * (1.0 + y * (1.0 - s))


def stats_walk(x, g, mean, inv, gamma, beta, act, r: int):
    """(sums (B, G, 2), dparam (B, 2, C)) of a slab x, g (B, C, *spatial) by
    the cluster body's arithmetic: each group cut into R slices of whole
    16-byte packets (rank q owns [q*L, (q+1)*L), clipped to the group), each
    slice's per-channel sum dpre and sum dpre*xhat in f32 (a channel may
    straddle slices: each adds only its own elements), the R partials of a
    channel added in rank order (rank 0's inbox), then the group's sum
    gamma*dbeta and sum gamma*dgamma over its channels."""
    b, c = x.shape[:2]
    groups = mean.shape[1]
    cg = c // groups
    hw = math.prod(x.shape[2:])
    n = cg * hw
    xf = x.float().reshape(b, groups, n)
    gf = g.float().reshape(b, groups, n)
    xh = (xf - mean[..., None]) * inv[..., None]
    chan = torch.arange(n) // hw  # each element's channel within its group
    gam = gamma.float().reshape(groups, cg)
    dpre = gf
    if act == "silu":
        dpre = gf * _dsilu(xh * gam[:, chan] + beta.float().reshape(groups, cg)[:, chan])
    length = tgn.cluster_slice_len(x.element_size(), n, r)
    db = dg = torch.zeros(b, groups, cg)
    for rank in range(r):
        lo, hi = min(rank * length, n), min(rank * length + length, n)
        idx = chan[lo:hi]
        db = db + torch.zeros(b, groups, cg).index_add_(-1, idx, dpre[..., lo:hi])
        dg = dg + torch.zeros(b, groups, cg).index_add_(-1, idx, (dpre * xh)[..., lo:hi])
    sums = torch.stack([(gam * db).sum(-1), (gam * dg).sum(-1)], -1)
    return sums, torch.stack([dg.reshape(b, c), db.reshape(b, c)], 1)


def apply_walk(x, g, mean, inv, gamma, beta, act, sums, count: int):
    """dx of a slab by the flat body's arithmetic: each row (b, c) folded
    into a = inv*gamma, b = beta - mean*a, k2 = -inv^2*m2, k0 = inv^2*m2*mean
    - inv*m1 (m1, m2 the group sums over `count`), then dx = a*dpre + k2*x +
    k0 with dpre = g*silu'(x*a + b), in f32, rounded to x's type."""
    bsz, c = x.shape[:2]
    cg = c // mean.shape[1]
    rows = lambda t: t.repeat_interleave(cg, 1)[..., None]  # noqa: E731  (B, G) -> (B, C, 1)
    inv_c, mean_c = rows(inv), rows(mean)
    m1, m2 = rows(sums[..., 0] / float(count)), rows(sums[..., 1] / float(count))
    a = inv_c * gamma.float()[None, :, None]
    bb = beta.float()[None, :, None] - mean_c * a
    k2 = -inv_c * inv_c * m2
    k0 = -mean_c * k2 - inv_c * m1
    xf = x.float().reshape(bsz, c, -1)
    gf = g.float().reshape(bsz, c, -1)
    dpre = gf * _dsilu(xf * a + bb) if act == "silu" else gf
    return (a * dpre + k2 * xf + k0).reshape(x.shape).to(x.dtype)


def _nchw(x):  # JAX (B, H, W, C) -> port (B, C, H, W)
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


def _split_case(shape, groups, act, dtype="float32"):
    """Seeded numpy inputs (B, H, W, C) and the Pallas backward's outputs,
    as port tensors (x, g, scale, bias, mean, inv, count) and numpy (dx
    NCHW, dscale, dbias)."""
    rng = np.random.RandomState(7)
    x = (rng.randn(*shape) * 1.7 + 0.4).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    scale = (rng.randn(shape[-1]) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    rx, rs, rb = group_norm_pallas_bwd(jx, jnp.asarray(scale), jnp.asarray(bias), jg, groups,
                                       1e-5, act, interpret=True)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tx, tg = (torch.from_numpy(_nchw(np.asarray(t, np.float32))).to(tdt) for t in (jx, jg))
    count = tx[0, :tx.shape[1] // groups].numel()
    mean, inv = tgn.group_stats(tgn.group_sums(tx, groups), count, 1e-5)
    ref = (np.transpose(np.asarray(rx, np.float32), (0, 3, 1, 2)), np.asarray(rs, np.float32),
           np.asarray(rb, np.float32))
    return (tx, tg, torch.from_numpy(scale), torch.from_numpy(bias), mean, inv, count), ref


def _split_walk(case, slabs: int, r: int, act):
    """dx, dgamma, dbeta of the whole through the walks over `slabs` slabs of
    the first spatial axis: each slab's stats_walk, the group sums added
    over the slabs (the all-reduce), each slab's apply_walk over the whole
    group's count; dgamma, dbeta the slabs' rows summed over the batch."""
    x, g, scale, bias, mean, inv, count = case
    parts = [stats_walk(a.contiguous(), b.contiguous(), mean, inv, scale, bias, act, r)
             for a, b in zip(x.chunk(slabs, 2), g.chunk(slabs, 2))]
    sums = sum(p[0] for p in parts)
    dx = torch.cat([apply_walk(a.contiguous(), b.contiguous(), mean, inv, scale, bias, act, sums,
                               count) for a, b in zip(x.chunk(slabs, 2), g.chunk(slabs, 2))], 2)
    dparam = sum(p[1] for p in parts).sum(0)
    return dx, dparam[0], dparam[1]


# (B, H, W, C), groups: test_gn_split_bwd_plain_matches_whole_and_pallas's
# shape, and groups of 6 channels of 120 elements a slab at 1 slab (slices
# cut mid-channel at every R > 1, and a slab's HW of 60, 30 or 15 elements)
SPLIT_SHAPES = [((2, 8, 16, 64), 16), ((2, 12, 10, 48), 8)]


@pytest.mark.parametrize("r", [1, 2, 8])
@pytest.mark.parametrize("slabs", [1, 2, 4])
@pytest.mark.parametrize("act", ["silu", None])
@pytest.mark.parametrize("shape,groups", SPLIT_SHAPES)
def test_split_walks_match_pallas(shape, groups, act, slabs, r):
    case, (rx, rs, rb) = _split_case(shape, groups, act)
    dx, dgamma, dbeta = _split_walk(case, slabs, r, act)
    np.testing.assert_allclose(dx.numpy(), rx, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(dgamma.numpy(), rs, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(dbeta.numpy(), rb, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("r", [2, 16])
@pytest.mark.parametrize("slabs", [1, 2])
def test_split_walks_bf16_match_pallas(slabs, r):
    """bf16 storage (8-element packets, so other slice lengths), f32
    arithmetic, dx rounded to bf16: within the bf16 limit, 2e-2."""
    case, (rx, rs, rb) = _split_case((2, 8, 16, 64), 16, "silu", "bfloat16")
    dx, dgamma, dbeta = _split_walk(case, slabs, r, "silu")
    assert dx.dtype == torch.bfloat16
    np.testing.assert_allclose(dx.float().numpy(), rx, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(dgamma.numpy(), rs, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(dbeta.numpy(), rb, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("r", [1, 4, 16])
@pytest.mark.parametrize("act", ["silu", None])
def test_walks_match_the_plain_versions(act, r):
    """On one slab (a 3-row slice of a group's 8 rows), the walks against
    gn_bwd_stats_plain / gn_bwd_apply_plain: the same function, summed in
    another order and with SiLU' in its other form."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 3, 8, generator=gen) * 2.0 + 0.5
    g = torch.randn(2, 32, 3, 8, generator=gen)
    gamma, beta = torch.randn(32, generator=gen) * 0.2 + 1.0, torch.randn(32, generator=gen) * 0.1
    mean, inv = torch.randn(2, 8, generator=gen), torch.rand(2, 8, generator=gen) + 0.5
    sums, dparam = stats_walk(x, g, mean, inv, gamma, beta, act, r)
    psums, pdparam = tgn.gn_bwd_stats_plain(x, g, mean, inv, gamma, beta, act)
    torch.testing.assert_close(sums, psums, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(dparam, pdparam, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(apply_walk(x, g, mean, inv, gamma, beta, act, psums, 96),
                               tgn.gn_bwd_apply_plain(x, g, mean, inv, gamma, beta, act, psums, 96),
                               atol=2e-5, rtol=1e-4)


# The slabs of path sp_train (SP = 2 over the long clip's 512 x 16 latents,
# batch 1, 32 groups): (C, rows, F, act), and the cluster size the rule gives
# each in f32 and bf16
SP_TRAIN_SLABS = [
    ((320, 256, 16), "silu", 16, 8), ((320, 256, 16), None, 16, 8),
    ((640, 256, 16), "silu", 16, 16), ((960, 256, 16), "silu", 16, 16),
    ((320, 128, 8), "silu", 8, 8), ((640, 128, 8), "silu", 8, 8), ((640, 128, 8), None, 8, 8),
    ((960, 128, 8), "silu", 8, 8), ((1280, 128, 8), "silu", 16, 8),
    ((1920, 128, 8), "silu", 16, 8), ((640, 64, 4), "silu", 8, 8),
    ((1280, 64, 4), "silu", 8, 8), ((1280, 64, 4), None, 8, 8), ((1920, 64, 4), "silu", 8, 8),
    ((2560, 64, 4), "silu", 8, 8), ((1280, 32, 2), "silu", 8, 8), ((1280, 32, 2), None, 8, 8),
    ((2560, 32, 2), "silu", 8, 8)]


@pytest.mark.parametrize("chw,act,r32,r16", SP_TRAIN_SLABS)
def test_stats_cluster_size_at_sp_train_slabs(chw, act, r32, r16):
    """Every slab of path sp_train takes the cluster body: at batch 1 and 32
    groups at least 132 CTAs (R = 8), and 512 (R = 16) where the slices of x
    and g at 16 stay at least 16 KB."""
    c, h, w = chw
    for dt, want in ((torch.float32, r32), (torch.bfloat16, r16)):
        r = tgn.gn_bwd_stats_cluster_size(dt, 1, c, h * w, 32)
        assert r == want, (chw, dt, r)
        esize = torch.empty((), dtype=dt).element_size()
        n = c // 32 * h * w
        assert 32 * r >= tgn._CLUSTER_MIN_CTAS
        if r < 16:  # stopped below 264 CTAs: the next R's slices fall below the floor
            assert 2 * tgn.cluster_slice_len(esize, n, 2 * r) * esize < tgn._STATS_MIN_SLICE


def test_stats_cluster_size_limits():
    """The C rule's documented limits: HW a whole number of 16-byte packets;
    the least R (a power of two up to 16) whose grid has 264 CTAs, or 132
    where the slices at 2R fall below 16 KB; the streaming fallback where
    the exchange's shared memory passes 226 KB, for groups of 2^30 elements
    and for 2^31 groups."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert tgn.gn_bwd_stats_cluster_size(f32, 1, 64, 6, 32) == 0       # 6 % 4
    assert tgn.gn_bwd_stats_cluster_size(bf16, 1, 64, 25, 32) == 0     # 25 % 8
    assert tgn.gn_bwd_stats_cluster_size(f32, 200, 64, 16, 32) == 1    # 6400 groups
    assert tgn.gn_bwd_stats_cluster_size(f32, 4, 64, 16, 32) == 2      # 256 CTAs, tiny slices
    assert tgn.gn_bwd_stats_cluster_size(f32, 8, 64, 4096, 32) == 2    # 512 CTAs at R = 2
    # the slices are read from device memory, not held: a 4 MiB group of f32
    # x and g takes 16 CTAs like any other at 32 groups
    assert tgn.gn_bwd_stats_cluster_size(f32, 1, 128, 131072, 32) == 16
    assert tgn.gn_bwd_stats_cluster_size(bf16, 1, 32, 2**30, 32) == 0  # 2^30 elements a group
    # the exchange's inbox: 4096 channels a group at R = 8 take 288 KB
    assert tgn.gn_bwd_stats_cluster_size(bf16, 1, 131072, 8, 32) == 0
    assert tgn.gn_bwd_stats_cluster_size(bf16, 32, 131072, 8, 32) == 1  # 1024 groups: 64 KB
    assert tgn.gn_bwd_stats_cluster_size(f32, 2**26, 64, 4096, 32) == 0  # 2^31 groups
    # the smoke's checks of the streaming fallback (GN_SPLIT_STREAMING): a
    # misaligned view of a slab the rule takes, and odd packets
    assert tgn.gn_bwd_stats_cluster_size(f32, 1, 320, 256 * 16, 32) == 16
    assert tgn.gn_bwd_stats_cluster_size(bf16, 1, 64, 25, 32) == 0


@pytest.mark.parametrize("dtype,numel,want", [
    (torch.bfloat16, 320 * 4096, (3, 214)), (torch.bfloat16, 960 * 4096, (4, 480)),
    (torch.bfloat16, 1280 * 64, (1, 40)), (torch.float32, 320 * 4096, (4, 320)),
    (torch.float32, 640 * 256, (1, 160)), (torch.float32, 4, (1, 1)),
    (torch.bfloat16, 2**31, (4, 262144))])
def test_flat_grid(dtype, numel, want):
    """K, the packets a thread, is the least up to 4 that keeps the grid
    within 264 CTAs of 256 threads; the CTAs cover every packet once."""
    k, ctas = tgn.gn_bwd_apply_flat_grid(dtype, numel)
    assert (k, ctas) == want
    packets = numel // (16 // torch.empty((), dtype=dtype).element_size())
    assert (ctas - 1) * 256 * k < packets <= ctas * 256 * k


@pytest.mark.parametrize("hw,esize", [(4, 4), (8, 2), (64, 2), (4096, 4)])
def test_flat_rows_fit_the_coefficients(hw, esize):
    """A CTA of the flat body folds the coefficients of every row its packets
    touch into 256*4 + 1 float4 of shared memory: at most one row a packet
    and one more, whatever HW (a whole number of packets)."""
    pack = 16 // esize
    for k in range(1, tgn._FLAT_MAX_PACKETS + 1):
        chunk = tgn._FLAT_THREADS * k * pack
        for e0 in range(0, 5 * chunk, chunk):
            rows = (e0 + chunk - 1) // hw - e0 // hw + 1
            assert rows <= tgn._FLAT_THREADS * tgn._FLAT_MAX_PACKETS + 1


def _misaligned(shape, dtype=torch.float32):
    base = torch.zeros(math.prod(shape) + 1, dtype=dtype)
    view = base[1:].view(*shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _operands(shape, groups=32):
    b, c = shape[:2]
    return (torch.zeros(b, groups), torch.ones(b, groups), torch.ones(c), torch.zeros(c))


def test_stats_launch_path(monkeypatch):
    """One entry-point call a gn_bwd_stats, and no ticket buffer where the
    rule takes the cluster body (the done pointer is null); a misaligned x
    and a HW of odd packets launch the streaming fallback with B*G zeroed
    tickets, counted in launches only; reset_counters zeroes
    cluster_launches."""
    fn = tgn.gn_bwd_stats
    good, odd = torch.zeros(1, 64, 8, 8), torch.zeros(1, 64, 3, 2)
    args = []
    calls = fake_kernel_library(monkeypatch, [ops.CLUSTER_LAUNCHED, 0, 0], args)
    ops.reset_counters()
    tgn._launch_bwd_stats(good, good, *_operands(good.shape), "silu")
    tgn._launch_bwd_stats(_misaligned(good.shape), good, *_operands(good.shape), "silu")
    tgn._launch_bwd_stats(odd, odd, *_operands(odd.shape), None)
    assert calls == ["tt_gn_bwd_stats"] * 3
    assert [a[8] is None for a in args] == [True, False, False]  # the tickets
    assert fn.launches == 3 and fn.cluster_launches == 1
    ops.reset_counters()
    assert fn.launches == 0 and fn.cluster_launches == 0


def test_apply_launch_path(monkeypatch):
    """gn_bwd_apply counts the flat body's launches in flat_launches where
    HW is a whole number of packets and x, g, dx are aligned; a misaligned g
    and a HW of odd packets launch the fallback, counted in launches only."""
    fn = tgn.gn_bwd_apply
    good, odd = torch.zeros(1, 64, 8, 8), torch.zeros(1, 64, 3, 2)
    sums = torch.zeros(1, 32, 2)
    calls = fake_kernel_library(monkeypatch, [ops.FLAT_LAUNCHED, 0, 0])
    ops.reset_counters()
    tgn._launch_bwd_apply(good, good, *_operands(good.shape), "silu", sums, 128)
    tgn._launch_bwd_apply(good, _misaligned(good.shape), *_operands(good.shape), None, sums, 128)
    tgn._launch_bwd_apply(odd, odd, *_operands(odd.shape), None, sums, 12)
    assert calls == ["tt_gn_bwd_apply"] * 3
    assert fn.launches == 3 and fn.flat_launches == 1
    ops.reset_counters()
    assert fn.launches == 0 and fn.flat_launches == 0


@pytest.mark.parametrize("half,shape,code", [
    ("stats", (1, 64, 8, 8), 0), ("stats", (1, 64, 3, 2), ops.CLUSTER_LAUNCHED),
    ("apply", (1, 64, 8, 8), 0), ("apply", (1, 64, 3, 2), ops.FLAT_LAUNCHED)])
def test_report_against_the_rule_raises(half, shape, code, monkeypatch):
    """A report that disagrees with the rule (the fallback where the rule
    takes the new body, or the reverse) raises, as does a CUDA error."""
    x = torch.zeros(shape)
    operands = _operands(shape)

    def launch():
        if half == "stats":
            return tgn._launch_bwd_stats(x, x, *operands, None)
        return tgn._launch_bwd_apply(x, x, *operands, None, torch.zeros(1, 32, 2), 16)

    fake_kernel_library(monkeypatch, [code, 700])
    with pytest.raises(RuntimeError, match="against the wrapper's rule"):
        launch()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        launch()


def test_f32_parameters_pass_without_a_cast():
    """_param_f32 hands a contiguous f32 parameter on the device through as
    it is (no cast launch a call on the f32 training path); other types and
    layouts get an f32 copy."""
    p = torch.randn(64)
    assert tgn._param_f32(p, 64, p.device) is p
    q = tgn._param_f32(p.bfloat16(), 64, p.device)
    assert q.dtype == torch.float32 and q.is_contiguous()
    strided = torch.randn(128)[::2]
    assert tgn._param_f32(strided, 64, p.device).is_contiguous()
    with pytest.raises(ValueError):
        tgn._param_f32(p, 32, p.device)
