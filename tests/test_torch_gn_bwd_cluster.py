"""The thread-block-cluster body of gn_silu_bwd (csrc/gn_silu.cu) on the CPU.

The CUDA body runs only on the card (`chip_smoke.py` holds it against the
plain version there). Here: the rule that picks it and its cluster size R
(`gn_bwd_cluster_size`, the twin of the C rule) at the trainer's GroupNorm
shapes and at the C rule's documented limits; the wrapper's launch path and
`cluster_launches` counter with the C library replaced by a recorder; and
`gn_bwd_walk`, a plain-torch emulation of the body's arithmetic (the group
cut into R slices of whole 16-byte packets, each slice's sums in f32
combined in rank order, channels straddling slices, the samples' parameter
gradients added in order), held against JAX's
`group_norm_pallas_bwd(interpret=True)` at the limits
`tests/test_torch_ops_bwd.py::test_gn_bwd_plain_matches_pallas` uses (atol
2e-4, rtol 1e-3; bf16 2e-2), with and without SiLU, for R in {1, 2, 8}.
"""

import ctypes
import functools
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


def _slices(n: int, esize: int, r: int):
    """(lo, hi) of each rank's slice of an n-element group, as the body cuts
    it (rank r owns [r*L, (r+1)*L), clipped to the group)."""
    length = tgn.cluster_slice_len(esize, n, r)
    return [(min(i * length, n), min(i * length + length, n)) for i in range(r)]


def gn_bwd_walk(x, g, gamma, beta, groups: int, eps: float, act, r: int):
    """(dx, dgamma, dbeta) of x, g (B, C, *spatial) by the cluster body's
    arithmetic: per slice the sums of x and x^2, combined in rank order into
    mean and inv (var = E[x^2] - mean^2); per slice and channel dbeta_c =
    sum dpre and dgamma_c = sum dpre * xhat, combined in rank order; dx =
    inv * (gamma_c dpre - m1 - xhat m2) with m1, m2 the group means of
    gamma_c dbeta_c and gamma_c dgamma_c; dgamma, dbeta of the samples
    added in order (rank 0 of a cluster that holds the batch)."""
    b, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    cg = c // groups
    n = cg * hw
    xf = x.float().reshape(b, groups, n)
    gf = g.float().reshape(b, groups, n)
    cuts = _slices(n, x.element_size(), r)
    s = ss = torch.zeros(b, groups)
    for lo, hi in cuts:
        seg = xf[..., lo:hi]
        s = s + seg.sum(-1)
        ss = ss + (seg * seg).sum(-1)
    mean = (s / n)[..., None]
    inv = 1.0 / torch.sqrt(ss[..., None] / n - mean * mean + eps)
    xh = (xf - mean) * inv
    chan = torch.arange(n) // hw  # the channel of each element, within its group
    gam = gamma.float().reshape(groups, cg)[:, chan]
    bet = beta.float().reshape(groups, cg)[:, chan]
    if act == "silu":
        y = xh * gam + bet
        sig = 1.0 / (1.0 + torch.exp(-y))
        dpre = gf * (sig * (1.0 + y * (1.0 - sig)))
    else:
        dpre = gf
    db = dg = torch.zeros(b, groups, cg)
    for lo, hi in cuts:
        idx = chan[lo:hi]
        db = db + torch.zeros(b, groups, cg).index_add_(-1, idx, dpre[..., lo:hi])
        dg = dg + torch.zeros(b, groups, cg).index_add_(-1, idx, (dpre * xh)[..., lo:hi])
    gam_c = gamma.float().reshape(groups, cg)
    m1 = ((gam_c * db).sum(-1) / n)[..., None]
    m2 = ((gam_c * dg).sum(-1) / n)[..., None]
    dx = inv * (gam * dpre - m1 - xh * m2)
    dgamma, dbeta = dg.reshape(b, c)[0], db.reshape(b, c)[0]
    for i in range(1, b):
        dgamma, dbeta = dgamma + dg.reshape(b, c)[i], dbeta + db.reshape(b, c)[i]
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


def _nchw(x):  # JAX (B, H, W, C) -> port (B, C, H, W)
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


@functools.lru_cache(maxsize=None)
def _case(shape, groups, act, dtype="float32"):
    """Seeded numpy inputs (B, H, W, C) and the Pallas backward's outputs,
    as port tensors (x, g, scale, bias) and numpy (dx NHWC, dscale, dbias)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(*shape) * 1.7 + 0.4).astype(np.float32)
    scale = (rng.randn(shape[-1]) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    ref = group_norm_pallas_bwd(jx, jnp.asarray(scale), jnp.asarray(bias), jg, groups, 1e-5, act,
                                interpret=True)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tx, tg = (torch.from_numpy(_nchw(np.asarray(t, np.float32))).to(tdt) for t in (jx, jg))
    return ((tx, tg, torch.from_numpy(scale), torch.from_numpy(bias)),
            tuple(np.asarray(t, np.float32) for t in ref))


# (B, H, W, C), groups: tests/test_torch_ops_bwd.py's two shapes (at R = 8
# the 1280-element groups of the second cut mid-channel), and groups of 6
# channels of 120 elements, which slices cut mid-channel at every R > 1
SHAPES = [((2, 64, 8, 128), 16), ((2, 32, 4, 320), 32), ((2, 12, 10, 48), 8)]


@pytest.mark.parametrize("r", [1, 2, 8])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_gn_bwd_walk_matches_pallas(shape, groups, act, r):
    (x, g, scale, bias), (rx, rs, rb) = _case(shape, groups, act)
    dx, ds, db = gn_bwd_walk(x, g, scale, bias, groups, 1e-5, act, r)
    np.testing.assert_allclose(np.transpose(dx.numpy(), (0, 2, 3, 1)), rx, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(ds.numpy(), rs, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(db.numpy(), rb, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("r", [2, 8])
def test_gn_bwd_walk_bf16_matches_pallas(r):
    """bf16 storage (8-element packets, so other slice lengths), f32
    arithmetic, dx rounded to bf16: within the bf16 limit, 2e-2."""
    (x, g, scale, bias), (rx, rs, rb) = _case((2, 12, 10, 48), 8, "silu", "bfloat16")
    dx, ds, db = gn_bwd_walk(x, g, scale, bias, 8, 1e-5, "silu", r)
    assert dx.dtype == torch.bfloat16
    np.testing.assert_allclose(np.transpose(dx.float().numpy(), (0, 2, 3, 1)), rx, atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(ds.numpy(), rs, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(db.numpy(), rb, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("r", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("esize,n,hw", [(4, 720, 120), (2, 720, 120), (4, 122880, 4096),
                                        (4, 20, 4)])
def test_slices_count_every_element_once(esize, n, hw, r):
    """The R slices partition the group into whole packets (the last ones
    may be short or empty), so the per-channel partials of the ranks add up
    to each channel once, straddling slices included."""
    cuts = _slices(n, esize, r)
    pack = 16 // esize
    assert cuts[0][0] == 0 and cuts[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert all(lo % pack == 0 for lo, _ in cuts)
    counts = torch.zeros(n // hw)
    for lo, hi in cuts:
        counts += torch.bincount(torch.arange(lo, hi) // hw, minlength=n // hw)
    assert torch.equal(counts, torch.full((n // hw,), float(hw)))


# The trainer's GroupNorm shapes at batch 2 ((C, H, W) at 32 groups: the
# full-width UNet's levels 256 x 16 down to 32 x 2) and the cluster size the
# rule gives each, f32 and bf16
TRAIN_GN = [((320, 256, 16), 8, 4), ((640, 256, 16), 16, 8), ((960, 256, 16), 16, 8),
            ((320, 128, 8), 4, 4), ((640, 128, 8), 4, 4), ((960, 128, 8), 4, 4),
            ((1280, 128, 8), 8, 4), ((1920, 128, 8), 8, 4), ((640, 64, 4), 4, 4),
            ((1280, 64, 4), 4, 4), ((1920, 64, 4), 4, 4), ((2560, 64, 4), 4, 4),
            ((1280, 32, 2), 4, 4), ((2560, 32, 2), 4, 4)]


@pytest.mark.parametrize("chw,r32,r16", TRAIN_GN)
def test_cluster_size_at_training_shapes(chw, r32, r16):
    """Every GroupNorm of the trainer takes the cluster body: at batch 2 and
    32 groups the least R whose slice fits 72 KB with at least 132 CTAs, so
    256 to 1024 CTAs where the streaming body had 64 blocks; a cluster holds
    both samples of a group (rank 0 writes the batch's dgamma, dbeta) where
    the 2R CTAs fit a cluster of 16."""
    c, h, w = chw
    for dt, want in ((torch.float32, r32), (torch.bfloat16, r16)):
        r = tgn.gn_bwd_cluster_size(dt, 2, c, h * w, 32)
        assert r == want, (chw, dt, r)
        assert tgn.gn_bwd_cluster_samples(2, r) == (2 if r <= 8 else 1)
        esize = torch.empty((), dtype=dt).element_size()
        assert tgn._cluster_smem(esize, c // 32 * h * w, c // 32, r) <= tgn._SLICE_TARGET
        assert 2 * 32 * r >= tgn._CLUSTER_MIN_CTAS


def test_cluster_size_limits():
    """The C rule's documented limits: HW a whole number of 16-byte packets;
    the least R (a power of two up to 16) whose slice fits 72 KB with at
    least 132 CTAs; else 8 where the slice fits 226 KB (one CTA an SM);
    else the streaming body; and the grid below 2^31 CTAs."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert tgn.gn_bwd_cluster_size(f32, 2, 64, 6, 32) == 0          # 6 % 4
    assert tgn.gn_bwd_cluster_size(bf16, 2, 64, 12, 32) == 0        # 12 % 8
    assert tgn.gn_bwd_cluster_size(bf16, 2, 64, 16, 32) == 4        # tiny: 132 CTAs rule
    assert tgn.gn_bwd_cluster_size(f32, 200, 64, 16, 32) == 1       # 6400 groups
    # the smoke's LIMIT_GN_SHAPE backward view (1024, 128, 256, 64): 64 KB slices
    assert tgn.gn_bwd_cluster_size(f32, 1024, 128, 256 * 64, 32) == 8
    assert tgn.gn_bwd_cluster_size(bf16, 1024, 128, 256 * 64, 32) == 4
    # 2 MiB of f32 x and g a group: 16 slices of 128 KB miss 72 KB, and 8 of
    # 256 KB miss 226 KB; in bf16 16 slices of 64 KB fit
    assert tgn.gn_bwd_cluster_size(f32, 4, 128, 65536, 32) == 0
    assert tgn.gn_bwd_cluster_size(bf16, 4, 128, 65536, 32) == 16
    # 1.5 MiB of f32 x and g a group: sixteen slices of 96 KB miss 72 KB,
    # eight of 192 KB fit 226 KB
    assert tgn.gn_bwd_cluster_size(f32, 2, 128, 49152, 32) == 8
    # 2^27 groups: sixteen 64 KB slices would make 2^31 CTAs, so eight
    assert tgn.gn_bwd_cluster_size(bf16, 2**22, 128, 65536, 32) == 8
    # 2^31 groups: no grid
    assert tgn.gn_bwd_cluster_size(f32, 2**26, 64, 4096, 32) == 0
    # the smoke's checks of the streaming body (GN_BWD_STREAMING)
    assert tgn.gn_bwd_cluster_size(f32, 2, 128, 256 * 256, 32) == 0
    assert tgn.gn_bwd_cluster_size(bf16, 2, 64, 25, 32) == 0
    # samples a cluster holds: the batch where its B * R CTAs fit 16
    assert [tgn.gn_bwd_cluster_samples(b, r) for b, r in
            ((1, 16), (2, 8), (2, 16), (4, 4), (4, 8), (16, 1), (17, 1))] == [1, 2, 1, 4, 1, 16, 1]


def _misaligned(shape, dtype=torch.float32):
    base = torch.zeros(math.prod(shape) + 1, dtype=dtype)
    view = base[1:].view(*shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def test_launch_counts_cluster_launches(monkeypatch):
    """The wrapper's launch path with the C library replaced by a recorder
    that reports the body the entry point would launch: a shape the rule
    takes counts a cluster launch; a misaligned x and a HW of odd packets
    launch the streaming body, counted in launches only; reset_counters
    zeroes cluster_launches."""
    fn = tgn.gn_silu_bwd
    w, b = torch.ones(64), torch.zeros(64)
    good = torch.zeros(2, 64, 8, 8)
    odd = torch.zeros(2, 64, 3, 2)
    calls = fake_kernel_library(monkeypatch, [ops.CLUSTER_LAUNCHED, 0, 0])
    ops.reset_counters()
    tgn._launch_bwd(good, good, w, b, 32, 1e-5, "silu")
    tgn._launch_bwd(_misaligned(good.shape), good, w, b, 32, 1e-5, "silu")
    tgn._launch_bwd(odd, odd, w, b, 32, 1e-5, None)
    assert calls == ["tt_gn_silu_bwd"] * 3
    assert fn.launches == 3 and fn.cluster_launches == 1
    ops.reset_counters()
    assert fn.launches == 0 and fn.cluster_launches == 0


@pytest.mark.parametrize("shape,code,rows,want", [
    ((2, 64, 8, 8), ops.CLUSTER_LAUNCHED, 1, 1.0),     # R = 4: one cluster holds both samples
    ((2, 960, 256, 16), ops.CLUSTER_LAUNCHED, 2, 3.0),  # R = 16: a cluster a sample
    ((2, 64, 3, 2), 0, 2, 3.0),                         # the streaming body: a row a sample
])
def test_parameter_gradients_from_the_rows_written(shape, code, rows, want, monkeypatch):
    """dgamma and dbeta come from the one row a batch-wide cluster writes,
    or from the sum of the per-sample rows the other bodies write (row i
    holds i + 1 in dgamma and -(i + 1) in dbeta here)."""

    class Library:
        @staticmethod
        def tt_gn_silu_bwd(*a):
            b, c = a[6], a[7]
            dp = (ctypes.c_float * (b * 2 * c)).from_address(a[5])
            for i in range(rows):
                dp[2 * i * c:(2 * i + 1) * c] = [i + 1.0] * c
                dp[(2 * i + 1) * c:(2 * i + 2) * c] = [-(i + 1.0)] * c
            return code

    fake_kernel_library(monkeypatch, [])
    monkeypatch.setattr(tgn._build, "load", Library)
    x = torch.zeros(shape)
    c = shape[1]
    _, dgamma, dbeta = tgn._launch_bwd(x, x, torch.ones(c), torch.zeros(c), 32, 1e-5, None)
    assert torch.equal(dgamma, torch.full((c,), want))
    assert torch.equal(dbeta, torch.full((c,), -want))


@pytest.mark.parametrize("shape,code", [((2, 64, 8, 8), 0), ((2, 64, 3, 2), -2)])
def test_report_against_the_rule_raises(shape, code, monkeypatch):
    """A report that disagrees with the rule (the streaming body where the
    rule takes a cluster, or the reverse) raises, as does a CUDA error."""
    x = torch.zeros(shape)
    fake_kernel_library(monkeypatch, [code, 700])
    with pytest.raises(RuntimeError, match="against the wrapper's rule"):
        tgn._launch_bwd(x, x, torch.ones(64), torch.zeros(64), 32, 1e-5, None)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tgn._launch_bwd(x, x, torch.ones(64), torch.zeros(64), 32, 1e-5, None)
