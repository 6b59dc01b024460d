"""The thread-block-cluster body of gn_silu_fwd (csrc/gn_silu.cu) on the CPU.

The CUDA body runs only on the card (`chip_smoke.py` holds it against the
plain version there). Here: `gn_fwd_walk`, a plain-torch emulation of the
body's arithmetic (the group cut into R slices of whole 16-byte packets,
each slice's sums of x and x^2 in f32 added in rank order, var = E[x^2] -
mean^2, the per-channel affine a_c = inv * gamma_c, b_c = beta_c - mean *
a_c, SiLU, one rounding to x's type), held against JAX's
`group_norm_pallas(interpret=True)` at the limits of
`tests/test_torch_ops.py::test_gn_single_pass_plain_matches_pallas` (atol
2e-5, rtol 1e-4; bf16 2e-2), with and without SiLU, for R in {1, 2, 4, 8,
16}; the slices at the full-width geometries; the rule that picks the body
and its R (`gn_fwd_cluster_size`, the twin of the C rule) at every
single-pass GroupNorm geometry of the full-width UNet and VAE and at its
documented limits; and the wrapper's launch path and `cluster_launches`
counter with the C library replaced by a recorder.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.ops.gn_silu_pallas import group_norm_pallas
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


def gn_fwd_walk(x, gamma, beta, groups: int, eps: float, act, r: int):
    """GroupNorm(+SiLU) of x (B, C, *spatial) by the cluster body's
    arithmetic: per slice the sums of x and x^2 in f32, added in rank order
    into mean and inv (var = E[x^2] - mean^2); per channel a_c = inv *
    gamma_c and b_c = beta_c - mean * a_c; y = x * a_c + b_c, SiLU as y / (1
    + exp(-y)), rounded once to x's type."""
    b, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    cg = c // groups
    n = cg * hw
    xf = x.float().reshape(b, groups, n)
    s = ss = torch.zeros(b, groups)
    for lo, hi in _slices(n, x.element_size(), r):
        seg = xf[..., lo:hi]
        s = s + seg.sum(-1)
        ss = ss + (seg * seg).sum(-1)
    mean = s / n
    inv = 1.0 / torch.sqrt(ss / n - mean * mean + eps)
    a = inv[..., None] * gamma.float().reshape(groups, cg)       # (B, G, C/G)
    bb = beta.float().reshape(groups, cg) - mean[..., None] * a
    chan = torch.arange(n) // hw  # the channel of each element, within its group
    y = xf * a[..., chan] + bb[..., chan]
    if act == "silu":
        y = y / (1.0 + torch.exp(-y))
    return y.reshape(x.shape).to(x.dtype)


def _nchw(x):  # JAX (B, H, W, C) -> port (B, C, H, W)
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


@functools.lru_cache(maxsize=None)
def _case(shape, groups, act, dtype="float32"):
    """Seeded numpy inputs (B, H, W, C) and the Pallas kernel's output, as
    port tensors (x, scale, bias) and numpy (y NCHW)."""
    rng = np.random.RandomState(9)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.randn(shape[-1]) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = group_norm_pallas(jx, jnp.asarray(scale), jnp.asarray(bias), groups, 1e-5, act,
                            interpret=True)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tx = torch.from_numpy(_nchw(np.asarray(jx, np.float32))).to(tdt)
    return (tx, torch.from_numpy(scale), torch.from_numpy(bias)), _nchw(np.asarray(ref, np.float32))


# (B, H, W, C), groups: groups of 2 channels of 512 elements (R = 2 cuts on a
# channel edge, R = 8 mid-channel), of 10 channels of 32 (the 1280-channel
# maps' shape of a group at 32 groups, a few packets a slice at R = 16), and
# of 6 channels of 120, which slices cut mid-channel at every R > 1 and
# where the last slice is short (R = 8) or empty (R = 16)
SHAPES = [((2, 64, 8, 32), 16), ((2, 8, 4, 320), 32), ((2, 12, 10, 48), 8)]


@pytest.mark.parametrize("r", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_gn_fwd_walk_matches_pallas(shape, groups, act, r):
    (x, scale, bias), ref = _case(shape, groups, act)
    y = gn_fwd_walk(x, scale, bias, groups, 1e-5, act, r)
    np.testing.assert_allclose(y.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("r", [2, 16])
@pytest.mark.parametrize("act", [None, "silu"])
def test_gn_fwd_walk_bf16_matches_pallas(act, r):
    """bf16 storage (8-element packets, so other slice lengths), f32
    arithmetic, y rounded to bf16: within the bf16 limit, 2e-2."""
    (x, scale, bias), ref = _case((2, 12, 10, 48), 8, act, "bfloat16")
    y = gn_fwd_walk(x, scale, bias, 8, 1e-5, act, r)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_gn_fwd_walk_matches_plain_version():
    """The walk and gn_silu_fwd's plain version (the smoke's reference on the
    card) agree at R = 16 on a short and an empty last slice."""
    (x, scale, bias), _ = _case((2, 12, 10, 48), 8, "silu")
    torch.testing.assert_close(gn_fwd_walk(x, scale, bias, 8, 1e-5, "silu", 16),
                               tgn.gn_silu_fwd_plain(x, scale, bias, 8, 1e-5, "silu"),
                               atol=2e-5, rtol=1e-4)


# Every single-pass GroupNorm geometry (C, H, W) of the full-width model at
# 32 groups: the UNet's four levels (256 x 16 down to 32 x 2; the 20 s
# clip's 512 x 32 first level goes two-stage, its 256 x 16 second level is
# here), its up blocks' concatenated widths, and the VAE decoder's levels
# that fit one pass (512 x 256 x 16 at 10.24 s, 256 and 128 channels above);
# with the R the rule gives at batch 1, 2, 4 in f32, then in bf16
FULL_WIDTH_GN = [
    ((320, 256, 16), (8, 8, 4, 4, 4, 4)), ((320, 128, 8), (2, 2, 2, 1, 1, 1)),
    ((640, 128, 8), (4, 4, 4, 2, 2, 2)), ((960, 128, 8), (4, 4, 4, 2, 2, 2)),
    ((1280, 128, 8), (8, 8, 4, 4, 4, 4)), ((1920, 128, 8), (8, 8, 4, 4, 4, 4)),
    ((320, 256, 8), (4, 4, 4, 2, 2, 2)), ((640, 256, 8), (8, 8, 4, 4, 4, 4)),
    ((960, 256, 8), (8, 8, 4, 4, 4, 4)), ((640, 64, 4), (1, 1, 1, 1, 1, 1)),
    ((1280, 64, 4), (2, 2, 2, 1, 1, 1)), ((1920, 64, 4), (2, 2, 2, 1, 1, 1)),
    ((2560, 64, 4), (4, 4, 4, 2, 2, 2)), ((640, 128, 4), (2, 2, 2, 1, 1, 1)),
    ((1280, 128, 4), (4, 4, 4, 2, 2, 2)), ((1920, 128, 4), (4, 4, 4, 2, 2, 2)),
    ((2560, 128, 4), (8, 8, 4, 4, 4, 4)), ((1280, 32, 2), (1, 1, 1, 1, 1, 1)),
    ((2560, 32, 2), (1, 1, 1, 1, 1, 1)), ((1280, 64, 2), (1, 1, 1, 1, 1, 1)),
    ((2560, 64, 2), (2, 2, 2, 1, 1, 1)), ((512, 256, 16), (16, 8, 4, 8, 8, 4)),
    ((256, 256, 16), (8, 8, 4, 4, 4, 4)), ((128, 512, 32), (16, 8, 4, 8, 8, 4)),
]


@pytest.mark.parametrize("chw,want", FULL_WIDTH_GN)
def test_cluster_size_at_full_width(chw, want):
    """Every single-pass GroupNorm of the paths takes the cluster body, at
    batch 1 (VAE decode), 2 (CFG, training) and 4 (CFG of two prompts), in
    both types: the least R whose slice fits 72 KB and whose grid has 264
    CTAs or whose slices would fall below 16 KB at 2R (one CTA a group,
    with no exchange, for the 64- and 256-token maps' small groups)."""
    c, h, w = chw
    got = []
    for dt in (torch.float32, torch.bfloat16):
        esize = torch.empty((), dtype=dt).element_size()
        n = c // 32 * h * w
        for b in (1, 2, 4):
            r = tgn.gn_fwd_cluster_size(dt, b, c, h * w, 32)
            got.append(r)
            assert tgn._fwd_smem(esize, n, c // 32, r) <= tgn._SLICE_TARGET
            assert (b * 32 * r >= tgn._FWD_MIN_CTAS
                    or tgn.cluster_slice_len(esize, n, 2 * r) * esize < tgn._FWD_MIN_SLICE)
    assert tuple(got) == want, (chw, got)


@pytest.mark.parametrize("chw", [(320, 256, 16), (1920, 128, 8), (2560, 32, 2), (128, 512, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slices_partition_full_width_groups(chw, dtype):
    """At the full-width geometries and the rule's R for each batch, the
    slices partition the group into whole packets (the last ones may be
    short or empty), so each element is read, summed and written once."""
    c, h, w = chw
    esize = torch.empty((), dtype=dtype).element_size()
    hw, pack = h * w, 16 // esize
    n = c // 32 * hw
    for bsz in (1, 2, 4):
        cuts = _slices(n, esize, tgn.gn_fwd_cluster_size(dtype, bsz, c, hw, 32))
        assert cuts[0][0] == 0 and cuts[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        assert all(lo % pack == 0 and (hi - lo) % pack == 0 for lo, hi in cuts)
        assert sum(hi - lo for lo, hi in cuts) == n


def test_cluster_size_limits():
    """The C rule's documented limits: HW a whole number of 16-byte packets;
    the least R (a power of two up to 16) whose slice fits 72 KB, with at
    least 264 CTAs or slices that would fall below 16 KB at 2R; else the
    largest R whose slice fits 226 KB (16, or 8 where 16 would pass 2^31 - 1
    CTAs); else the streaming body."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert tgn.gn_fwd_cluster_size(f32, 2, 64, 6, 32) == 0          # 6 % 4
    assert tgn.gn_fwd_cluster_size(bf16, 2, 64, 12, 32) == 0        # 12 % 8
    assert tgn.gn_fwd_cluster_size(bf16, 2, 64, 16, 32) == 1        # tiny: a CTA a group
    assert tgn.gn_fwd_cluster_size(f32, 200, 64, 16, 32) == 1       # 6400 groups
    # groups of 80 KB in bf16: at batch 2, 256 CTAs of 20 KB (at 2R the
    # slices would be 10 KB); at batch 4, 512 CTAs; at batch 8, 512 of 40 KB;
    # at batch 9, 288 groups, but a whole group passes 72 KB
    assert tgn.gn_fwd_cluster_size(bf16, 2, 1280, 1024, 32) == 4
    assert tgn.gn_fwd_cluster_size(bf16, 4, 1280, 1024, 32) == 4
    assert tgn.gn_fwd_cluster_size(bf16, 8, 1280, 1024, 32) == 2
    assert tgn.gn_fwd_cluster_size(bf16, 9, 1280, 1024, 32) == 2
    # 2 MiB of f32 a group: eight slices of 256 KB miss 72 KB (and 226 KB),
    # so sixteen of 128 KB, one CTA an SM
    assert tgn.gn_fwd_cluster_size(f32, 2, 32, 512 * 1024, 32) == 16
    # 4 MiB of f32 a group: sixteen slices of 256 KB miss 226 KB; in bf16
    # sixteen of 128 KB fit
    assert tgn.gn_fwd_cluster_size(f32, 1, 32, 1024 * 1024, 32) == 0
    assert tgn.gn_fwd_cluster_size(bf16, 1, 32, 1024 * 1024, 32) == 16
    # 2^27 groups of 1 MiB in bf16: sixteen slices would make 2^31 CTAs, so
    # eight of 128 KB
    assert tgn.gn_fwd_cluster_size(bf16, 2**22, 128, 131072, 32) == 8
    # 2^31 groups: no grid
    assert tgn.gn_fwd_cluster_size(f32, 2**26, 64, 4096, 32) == 0
    # the smoke's checks of the streaming body (GN_FWD_STREAMING)
    assert tgn.gn_fwd_cluster_size(f32, 1, 32, 1024 * 1024, 32) == 0
    assert tgn.gn_fwd_cluster_size(bf16, 2, 64, 25, 32) == 0


def _misaligned(shape, dtype=torch.float32):
    base = torch.zeros(math.prod(shape) + 1, dtype=dtype)
    view = base[1:].view(*shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _launch(x, groups=32, act="silu"):
    """gn_silu_fwd down its CUDA route (the wrapper routes CPU tensors to
    the plain version)."""
    c = x.shape[1]
    return tgn.gn_silu_fwd(x, torch.ones(c), torch.zeros(c), groups, 1e-5, act)


@pytest.fixture(autouse=True)
def _kernel_route(monkeypatch):
    monkeypatch.setattr(tgn, "_route", lambda x, name: True)


def test_launch_counts_cluster_launches(monkeypatch):
    """The wrapper's launch path with the C library replaced by a recorder
    that reports the body the entry point would launch: a shape the rule
    takes counts a cluster launch; a misaligned x and a HW of odd packets
    launch the streaming body, counted in launches only; the entry point
    gets the shape, groups, eps, act and dtype; reset_counters zeroes
    cluster_launches."""
    fn = tgn.gn_silu_fwd
    args = []
    calls = fake_kernel_library(monkeypatch, [ops.CLUSTER_LAUNCHED, 0, 0], args)
    ops.reset_counters()
    y = _launch(torch.zeros(2, 64, 8, 8, dtype=torch.bfloat16))
    _launch(_misaligned((2, 64, 8, 8)))
    _launch(torch.zeros(2, 64, 3, 2), act=None)
    assert calls == ["tt_gn_silu_fwd"] * 3
    assert y.shape == (2, 64, 8, 8) and y.dtype == torch.bfloat16
    assert [a[4:11] for a in args] == [(2, 64, 64, 32, 1e-5, 1, 1), (2, 64, 64, 32, 1e-5, 1, 0),
                                       (2, 64, 6, 32, 1e-5, 0, 0)]
    assert fn.launches == 3 and fn.cluster_launches == 1
    assert fn.shapes == {((2, 64, 8, 8), 32, "silu"), ((2, 64, 3, 2), 32, None)}
    ops.reset_counters()
    assert fn.launches == 0 and fn.cluster_launches == 0


@pytest.mark.parametrize("shape,code", [((2, 64, 8, 8), 0), ((2, 64, 3, 2), -2)])
def test_report_against_the_rule_raises(shape, code, monkeypatch):
    """A report that disagrees with the rule (the streaming body where the
    rule takes a cluster, or the reverse) raises, as does a CUDA error; no
    launch is counted."""
    fake_kernel_library(monkeypatch, [code, 700])
    ops.reset_counters()
    with pytest.raises(RuntimeError, match="against the wrapper's rule"):
        _launch(torch.zeros(shape))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _launch(torch.zeros(shape))
    assert tgn.gn_silu_fwd.launches == 0 and tgn.gn_silu_fwd.cluster_launches == 0
