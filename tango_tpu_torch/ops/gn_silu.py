"""GroupNorm(+SiLU) kernels and their plain PyTorch versions.

Six kernels from `csrc/gn_silu.cu`:
  * `gn_silu_fwd` — single pass, replaces `_gn_kernel`
    (tango_tpu/ops/gn_silu_pallas.py:27). Where `gn_fwd_cluster_size` gives
    a cluster size R (every path's shape), one thread-block cluster of R
    CTAs a group reads the group once into shared memory and writes y once;
    `gn_silu_fwd.cluster_launches` counts the launches the C entry point
    reports as such. Other groups (too large for 16 CTAs' shared memory, of
    odd packets, or unaligned) take the streaming body;
  * `gn_stats` + `gn_apply` — two stage, replace `_gn_stats_kernel` (:234) and
    `_gn_apply_kernel` (:257), with the per-channel combine in torch between
    them, as it was XLA between the two Pallas calls;
  * `gn_bwd_stats` + `gn_bwd_apply` — the backward split at its group sums
    (sequence parallelism, where a group spans every slab), together
    replacing `_gn_bwd_kernel` (:119) as gn_stats / gn_apply split the
    forward: the slab's sums, all-reduced over 'model' by the caller, then
    dx; dgamma, dbeta stay the slab's. `gn_bwd_stats` runs a thread-block
    cluster of R CTAs a group where `gn_bwd_stats_cluster_size` gives R
    (`gn_bwd_stats.cluster_launches`), `gn_bwd_apply` a flat body over the
    slab's 16-byte packets where HW is a whole number of them
    (`gn_bwd_apply.flat_launches`, grid `gn_bwd_apply_flat_grid`); other
    shapes and unaligned operands take the streaming fallbacks;
  * `gn_silu_bwd` — the backward, replaces `_gn_bwd_kernel` (:119): dx and
    per-sample dgamma/dbeta with the statistics recomputed, summed over the
    batch here in torch, as `group_norm_pallas_bwd` sums them in XLA. Where
    `gn_bwd_cluster_size` gives a cluster size R (every training shape), one
    thread-block cluster of R CTAs a group holds the group in shared memory
    and reads x and g once; `gn_silu_bwd.cluster_launches` counts the
    launches the C entry point reports as such. Other groups (too large for
    R CTAs' shared memory, or unaligned) take the streaming body.

Layout: channels-first, x is (B, C, *spatial) and contiguous, so one
(batch, group) is one contiguous run of (C/G)*HW elements. Storage f32 or
bf16; statistics f32 with var = E[x^2] - mean^2, as the Pallas kernels.
Bound on the H100: bytes (one read of x, one write of y); the design notes
are at the top of the CUDA file.

Each wrapper launches its kernel for a CUDA tensor and runs the plain version
beside it for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import functools
import math

import torch

from tango_tpu_torch.ops import (
    CLUSTER_LAUNCHED,
    FLAT_LAUNCHED,
    _build,
    count_cluster,
    kernel_wrapper,
)

_SRC = "tango_tpu_torch/csrc/gn_silu.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32 = 2**31


def kernel_shape_ok(x: torch.Tensor, num_groups: int) -> bool:
    """Whether the kernels take x (B, C, *spatial): their element offsets are
    64-bit, so the element count has no cap, but B, C, HW and the grids' block
    counts (B*C rows, B*G*chunks) are 32-bit. The dispatch in ops/basic.py
    asks this before it picks a kernel."""
    b, c, hw = x.shape[0], x.shape[1], math.prod(x.shape[2:])
    return hw < _INT32 and b * c < _INT32 and b * num_groups * n_chunks(hw) < _INT32


def _check(x: torch.Tensor, c_div: int, name: str) -> tuple[int, int, int]:
    """Validate a (B, C, *spatial) activation; return (B, C, HW)."""
    if x.dim() < 2:
        raise ValueError(f"{name}: expected (B, C, *spatial), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    b, c = x.shape[0], x.shape[1]
    hw = math.prod(x.shape[2:])
    if c % c_div:
        raise ValueError(f"{name}: channels {c} not divisible by groups {c_div}")
    if not kernel_shape_ok(x, c_div):
        raise ValueError(f"{name}: shape {tuple(x.shape)} exceeds the kernels' 32-bit "
                         "dimensions")
    return b, c, hw


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for device {x.device}")


def _param_f32(p: torch.Tensor, c: int, device) -> torch.Tensor:
    """p as a contiguous (c,) f32 tensor on `device`: p itself where it is
    one already (no cast, no copy, no launch)."""
    if p.shape != (c,):
        raise ValueError(f"expected a ({c},) parameter, got {tuple(p.shape)}")
    return p.to(device=device, dtype=torch.float32).contiguous()


def _silu(y: torch.Tensor) -> torch.Tensor:
    return y * torch.sigmoid(y)


# ----------------------------------------------------------------- single pass

# the cluster bodies' sizing (csrc/gn_silu.cu): CTAs a backward grid should
# reach (the H100's SMs) and a forward grid (two an SM), the forward's least
# slice worth a CTA of a cluster, the largest cluster, and the shared memory
# of a CTA's slice that lets three CTAs share an SM and that one CTA may hold
_CLUSTER_MIN_CTAS = 132
_FWD_MIN_CTAS = 264
_FWD_MIN_SLICE = 16 * 1024
_CLUSTER_MAX = 16
_SLICE_TARGET = 72 * 1024
_SLICE_MAX = 226 * 1024


def cluster_slice_len(esize: int, n: int, r: int) -> int:
    """Elements of a CTA's slice of an n-element group cut r ways: a whole
    number of 16-byte packets (`slice_len` in csrc/gn_silu.cu)."""
    pack = 16 // esize
    return (-(-n // r) + pack - 1) // pack * pack


def _fwd_smem(esize: int, n: int, cg: int, r: int) -> int:
    return cluster_slice_len(esize, n, r) * esize + 8 * _CLUSTER_MAX + 8 + 8 * cg


@functools.lru_cache(maxsize=None)
def gn_fwd_cluster_size(dtype: torch.dtype, b: int, c: int, hw: int, num_groups: int) -> int:
    """The cluster size R gn_silu_fwd's cluster body takes for x (B, C, HW) in
    `dtype`, 0 for the streaming body: the least power of two up to 16 whose
    CTA slice (1/R of a group's x, plus 8 bytes a channel and 136 of the
    exchange) fits 72 KB, and whose grid has at least 264 CTAs or whose
    slices would fall below 16 KB at 2R; else the largest R (16, or less
    where 16 would pass 2^31 - 1 CTAs) where its slice fits 226 KB; else 0.
    HW must be a whole number of 16-byte packets. The C entry point applies
    the same rule (`gn_fwd_cluster_size` in csrc/gn_silu.cu), together with
    16-byte aligned x and y. Cached: the wrapper asks at every launch."""
    esize = torch.empty((), dtype=dtype).element_size()
    if hw % (16 // esize):
        return 0
    cg = c // num_groups
    n, groups = cg * hw, b * num_groups
    r = 1
    while r <= _CLUSTER_MAX and groups * r < _INT32:
        last = r == _CLUSTER_MAX or 2 * groups * r >= _INT32
        if _fwd_smem(esize, n, cg, r) <= (_SLICE_MAX if last else _SLICE_TARGET) and (
                last or groups * r >= _FWD_MIN_CTAS
                or cluster_slice_len(esize, n, 2 * r) * esize < _FWD_MIN_SLICE):
            return r
        r *= 2
    return 0


def gn_silu_fwd_plain(x, gamma, beta, num_groups: int, eps: float, act: str | None):
    """Plain version of gn_silu_fwd: same statistics, same affine, in f32."""
    b, c = x.shape[0], x.shape[1]
    xf = x.float().reshape(b, num_groups, -1)
    n = xf.shape[-1]
    mean = xf.sum(-1) / n
    var = (xf * xf).sum(-1) / n - mean * mean
    inv = 1.0 / torch.sqrt(var + eps)
    cg = c // num_groups
    a = inv.repeat_interleave(cg, 1) * gamma.float()[None]          # (B, C)
    bb = beta.float()[None] - mean.repeat_interleave(cg, 1) * a
    shape = (b, c) + (1,) * (x.dim() - 2)
    y = x.float() * a.reshape(shape) + bb.reshape(shape)
    if act == "silu":
        y = _silu(y)
    return y.to(x.dtype)


@kernel_wrapper(_SRC, "tango_tpu/ops/gn_silu_pallas.py:27")
def gn_silu_fwd(x, gamma, beta, num_groups: int, eps: float = 1e-6, act: str | None = None):
    """Single-pass GroupNorm(+SiLU) of x (B, C, *spatial): one thread-block
    cluster per group (`gn_fwd_cluster_size`), else one block per group."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown fused act {act}")
    b, c, hw = _check(x, num_groups, "gn_silu_fwd")
    if not _route(x, "gn_silu_fwd"):
        return gn_silu_fwd_plain(x, gamma, beta, num_groups, eps, act)
    # the C entry point takes the cluster body where gn_fwd_cluster_size
    # gives R > 0 and x, y are 16-byte aligned; count_cluster holds its
    # report to that
    lib = _build.load()
    g32 = _param_f32(gamma, c, x.device)
    b32 = _param_f32(beta, c, x.device)
    y = torch.empty_like(x)
    xp, yp = x.data_ptr(), y.data_ptr()
    cluster = gn_fwd_cluster_size(x.dtype, b, c, hw, num_groups) > 0 and not (xp | yp) % 16
    code = lib.tt_gn_silu_fwd(
        xp, g32.data_ptr(), b32.data_ptr(), yp, b, c, hw, num_groups, float(eps),
        int(act == "silu"), _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    ran = code == CLUSTER_LAUNCHED
    _build.check(lib, 0 if ran else code, "gn_silu_fwd")
    count_cluster(gn_silu_fwd, cluster, ran)
    gn_silu_fwd.launches += 1
    gn_silu_fwd.shapes.add((tuple(x.shape), num_groups, act))
    return y


gn_silu_fwd.cluster_launches = 0


# ------------------------------------------------------------------- two stage

def n_chunks(hw: int) -> int:
    """Chunks per group, the JAX `_chunks` rule (gn_silu_pallas.py:264)."""
    for cs in (512, 256, 128, 64):
        if hw % cs == 0 and hw // cs >= 2:
            return hw // cs
    return 1


def gn_stats_plain(x, num_groups: int, chunks: int):
    """Plain version of gn_stats: (B, G, chunks, 2) partial sums, f32."""
    b = x.shape[0]
    xf = x.float().reshape(b, num_groups, chunks, -1)
    return torch.stack([xf.sum(-1), (xf * xf).sum(-1)], dim=-1)


@kernel_wrapper(_SRC, "tango_tpu/ops/gn_silu_pallas.py:234")
def gn_stats(x, num_groups: int, chunks: int):
    """Per-(batch, group, chunk) sums of x and x^2: (B, G, chunks, 2) f32."""
    b, c, hw = _check(x, num_groups, "gn_stats")
    if hw % chunks:
        raise ValueError(f"gn_stats: {chunks} chunks do not divide HW={hw}")
    if not _route(x, "gn_stats"):
        return gn_stats_plain(x, num_groups, chunks)
    lib = _build.load()
    parts = torch.empty((b, num_groups, chunks, 2), device=x.device, dtype=torch.float32)
    code = lib.tt_gn_stats(
        x.data_ptr(), parts.data_ptr(), b, c, hw, num_groups, chunks, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "gn_stats")
    gn_stats.launches += 1
    gn_stats.shapes.add((tuple(x.shape), num_groups, chunks))
    return parts


def gn_apply_plain(x, a, b, act: str | None):
    """Plain version of gn_apply: y = act(x * a + b) with a, b (B, C) f32."""
    shape = a.shape + (1,) * (x.dim() - 2)
    y = x.float() * a.reshape(shape) + b.reshape(shape)
    if act == "silu":
        y = _silu(y)
    return y.to(x.dtype)


@kernel_wrapper(_SRC, "tango_tpu/ops/gn_silu_pallas.py:257")
def gn_apply(x, a, b, act: str | None = None):
    """y = act(x * a[b, c] + b[b, c]) over x (B, C, *spatial); a, b (B, C) f32."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown fused act {act}")
    bs, c, hw = _check(x, 1, "gn_apply")
    for t in (a, b):
        if t.shape != (bs, c) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("gn_apply: a and b must be contiguous (B, C) float32")
    if not _route(x, "gn_apply"):
        return gn_apply_plain(x, a, b, act)
    if a.device != x.device or b.device != x.device:
        raise ValueError("gn_apply: a and b must be on x's device")
    lib = _build.load()
    y = torch.empty_like(x)
    code = lib.tt_gn_apply(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), bs, c, hw,
        int(act == "silu"), _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "gn_apply")
    gn_apply.launches += 1
    gn_apply.shapes.add((tuple(x.shape), act))
    return y


def group_sums(x, num_groups: int):
    """The first stage: gn_stats over JAX's chunks, its chunks summed: each
    (batch, group)'s sums of x and x^2, (B, G, 2) f32."""
    return gn_stats(x, num_groups, n_chunks(math.prod(x.shape[2:]))).sum(dim=2)


def group_stats(sums, count: int, eps: float):
    """Each group's mean and 1/sqrt(var + eps), (B, G) f32, from its (B, G, 2)
    sums of x and x^2 over `count` elements."""
    mean = sums[..., 0] / float(count)
    var = sums[..., 1] / float(count) - mean * mean
    return mean, torch.rsqrt(var + eps)


def group_norm_from_stats(x, mean, inv, gamma, beta, act: str | None):
    """The per-channel combine (torch) of the (B, G) statistics, then
    gn_apply over x."""
    cg = x.shape[1] // mean.shape[1]
    a = inv.repeat_interleave(cg, 1) * gamma.float()[None]
    bb = beta.float()[None] - mean.repeat_interleave(cg, 1) * a
    return gn_apply(x, a.contiguous(), bb.contiguous(), act)


def group_norm_two_stage(x, gamma, beta, num_groups: int, eps: float = 1e-6,
                         act: str | None = None):
    """gn_stats -> per-channel combine (torch) -> gn_apply, as group_norm_pallas2."""
    count = math.prod(x.shape[2:]) * (x.shape[1] // num_groups)
    return group_norm_from_stats(x, *group_stats(group_sums(x, num_groups), count, eps), gamma,
                                 beta, act)


# -------------------------------------------------------------------- backward

# the kernel keeps a group's per-channel sums in shared memory: 2 * C/G f32
# within the 48 KB a block gets without opting in
_BWD_MAX_GROUP_CHANNELS = 4096


def gn_bwd_supported(x: torch.Tensor, num_groups: int) -> bool:
    """Shapes gn_silu_bwd takes. The kernel streams a group from device memory,
    so unlike gn_bwd_supported in JAX (8 MB of VMEM per sample) it has no
    size limit beyond C/G and the 32-bit dimensions of `kernel_shape_ok`."""
    c = x.shape[1]
    return (c % num_groups == 0 and c // num_groups <= _BWD_MAX_GROUP_CHANNELS
            and kernel_shape_ok(x, num_groups))


def _cluster_smem(esize: int, n: int, cg: int, r: int) -> int:
    return 2 * cluster_slice_len(esize, n, r) * esize + 8 * cg + 8


def gn_bwd_cluster_size(dtype: torch.dtype, b: int, c: int, hw: int, num_groups: int) -> int:
    """The cluster size R gn_silu_bwd's cluster body takes for x (B, C, HW) in
    `dtype`, 0 for the streaming body: the least power of two up to 16 whose
    CTA slice (x and g, 1/R of a group each, plus 8 bytes a channel) fits 72
    KB with at least 132 CTAs in the grid; else 8 where the slice fits 226
    KB; else 0. HW must be a whole number of 16-byte packets. The C entry
    point applies the same rule (`gn_bwd_cluster_size` in csrc/gn_silu.cu),
    together with 16-byte aligned x, g and dx."""
    esize = torch.empty((), dtype=dtype).element_size()
    if hw % (16 // esize):
        return 0
    cg = c // num_groups
    n, groups = cg * hw, b * num_groups
    r = 1
    while r <= _CLUSTER_MAX and groups * r < _INT32:
        if _cluster_smem(esize, n, cg, r) <= _SLICE_TARGET and (
                groups * r >= _CLUSTER_MIN_CTAS or r == _CLUSTER_MAX):
            return r
        r *= 2
    return 8 if _cluster_smem(esize, n, cg, 8) <= _SLICE_MAX and groups * 8 < _INT32 else 0


def gn_bwd_cluster_samples(b: int, r: int) -> int:
    """Samples one cluster of the cluster body holds: the whole batch where
    its b * r CTAs make one cluster (at most 16; its rank 0 then writes the
    batch's sums of dgamma and dbeta), else one (`gn_bwd_cluster_samples` in
    csrc/gn_silu.cu)."""
    return b if b * r <= _CLUSTER_MAX else 1


def gn_silu_bwd_plain(x, g, gamma, beta, num_groups: int, eps: float, act: str | None):
    """Plain version of gn_silu_bwd, the arithmetic of _gn_bwd_kernel in f32."""
    b, c = x.shape[0], x.shape[1]
    cg = c // num_groups
    xf = x.float().reshape(b, num_groups, cg, -1)
    n = xf.shape[2] * xf.shape[3]
    mean = xf.sum((2, 3), keepdim=True) / n
    var = (xf * xf).sum((2, 3), keepdim=True) / n - mean * mean
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    gam = gamma.float().reshape(1, num_groups, cg, 1)
    gf = g.float().reshape(xf.shape)
    if act == "silu":
        y = xhat * gam + beta.float().reshape(1, num_groups, cg, 1)
        sig = torch.sigmoid(y)
        dpre = gf * (sig * (1.0 + y * (1.0 - sig)))
    else:
        dpre = gf
    dgamma = (dpre * xhat).sum(3).reshape(b, c).sum(0)
    dbeta = dpre.sum(3).reshape(b, c).sum(0)
    dxhat = dpre * gam
    m1 = dxhat.sum((2, 3), keepdim=True) / n
    m2 = (dxhat * xhat).sum((2, 3), keepdim=True) / n
    dx = inv * (dxhat - m1 - xhat * m2)
    return dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


@kernel_wrapper(_SRC, "tango_tpu/ops/gn_silu_pallas.py:119", backward=True)
def gn_silu_bwd(x, g, gamma, beta, num_groups: int, eps: float = 1e-6, act: str | None = None):
    """Backward of GroupNorm(+SiLU) over x (B, C, *spatial) for the incoming
    gradient g (x's shape and dtype): (dx, dgamma, dbeta), dgamma and dbeta in
    the parameters' dtype."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown fused act {act}")
    b, c, hw = _check(x, num_groups, "gn_silu_bwd")
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError("gn_silu_bwd: g must be contiguous with x's shape and dtype")
    if not _route(x, "gn_silu_bwd"):
        return gn_silu_bwd_plain(x, g, gamma, beta, num_groups, eps, act)
    if c // num_groups > _BWD_MAX_GROUP_CHANNELS:
        raise ValueError(f"gn_silu_bwd: {c // num_groups} channels a group exceed "
                         f"{_BWD_MAX_GROUP_CHANNELS}")
    if g.device != x.device:
        raise ValueError("gn_silu_bwd: g must be on x's device")
    return _launch_bwd(x, g, gamma, beta, num_groups, eps, act)


def _launch_bwd(x, g, gamma, beta, num_groups: int, eps: float, act: str | None):
    """Launch gn_silu_bwd into new outputs; the C entry point takes the
    cluster body by `gn_bwd_cluster_size` and 16-byte alignment, and
    gn_silu_bwd.cluster_launches counts the cluster launches it reports.
    dparam has a row of (dgamma, dbeta) for each sample, or one for the
    whole batch where a cluster holds it (`gn_bwd_cluster_samples`)."""
    b, c, hw = x.shape[0], x.shape[1], math.prod(x.shape[2:])
    lib = _build.load()
    g32 = _param_f32(gamma, c, x.device)
    b32 = _param_f32(beta, c, x.device)
    dx = torch.empty_like(x)
    dparam = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    r = gn_bwd_cluster_size(x.dtype, b, c, hw, num_groups)
    cluster = r > 0 and not any(t.data_ptr() % 16 for t in (x, g, dx))
    code = lib.tt_gn_silu_bwd(
        x.data_ptr(), g.data_ptr(), g32.data_ptr(), b32.data_ptr(), dx.data_ptr(),
        dparam.data_ptr(), b, c, hw, num_groups, float(eps), int(act == "silu"),
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    ran = code == CLUSTER_LAUNCHED
    _build.check(lib, 0 if ran else code, "gn_silu_bwd")
    count_cluster(gn_silu_bwd, cluster, ran)
    gn_silu_bwd.launches += 1
    gn_silu_bwd.shapes.add((tuple(x.shape), num_groups, act))
    rows = b // gn_bwd_cluster_samples(b, r) if ran else b
    dsum = dparam[0] if rows == 1 else dparam.sum(0)
    return dx, dsum[0].to(gamma.dtype), dsum[1].to(beta.dtype)


gn_silu_bwd.cluster_launches = 0


# ------------------------------------------------------------- split backward

# the new bodies' sizing (csrc/gn_silu.cu): the CTAs a gn_bwd_stats grid
# reaches where its slices stay at least _STATS_MIN_SLICE bytes of x and g;
# the flat gn_bwd_apply's threads a CTA, most packets a thread and the CTAs
# its grid aims at
_STATS_MIN_CTAS = 264
_STATS_MIN_SLICE = 16 * 1024
_FLAT_THREADS = 256
_FLAT_MAX_PACKETS = 4
_FLAT_CTAS = 264


def _stats_smem(cg: int, r: int) -> int:
    return 8 * cg * (r + 1) + 8


@functools.lru_cache(maxsize=None)
def gn_bwd_stats_cluster_size(dtype: torch.dtype, b: int, c: int, hw: int,
                              num_groups: int) -> int:
    """The cluster size R gn_bwd_stats' cluster body takes for x (B, C, HW) in
    `dtype`, 0 for the streaming fallback: the least power of two up to 16
    whose grid has at least 264 CTAs, or at least 132 where the slices of x
    and g at 2R would fall below 16 KB; 0 where that R's shared memory (8
    bytes a channel, and 8 a channel and rank of the exchange) passes 226 KB,
    where HW is no whole number of 16-byte packets, and for groups of 2^30
    elements or more. The C entry point applies the same rule
    (`gn_bwd_stats_cluster_size` in csrc/gn_silu.cu), together with 16-byte
    aligned x and g. Cached: the wrapper asks at every launch."""
    esize = torch.empty((), dtype=dtype).element_size()
    cg = c // num_groups
    n, groups = cg * hw, b * num_groups
    if hw % (16 // esize) or n >= 2**30 or groups >= _INT32:
        return 0
    r = 1
    while r < _CLUSTER_MAX and not (
            groups * r >= _STATS_MIN_CTAS
            or (groups * r >= _CLUSTER_MIN_CTAS
                and 2 * cluster_slice_len(esize, n, 2 * r) * esize < _STATS_MIN_SLICE)):
        r *= 2
    return r if _stats_smem(cg, r) <= _SLICE_MAX else 0


def gn_bwd_apply_flat_grid(dtype: torch.dtype, numel: int) -> tuple[int, int]:
    """(packets of x a thread K, CTAs) of gn_bwd_apply's flat body over
    `numel` elements: CTAs of 256 threads hold 256*K packets, K the least up
    to 4 whose grid has at most 264 CTAs (`gn_bwd_apply_flat_grid` in
    csrc/gn_silu.cu)."""
    packets = numel // (16 // torch.empty((), dtype=dtype).element_size())
    for k in range(1, _FLAT_MAX_PACKETS + 1):
        ctas = -(-packets // (_FLAT_THREADS * k))
        if ctas <= _FLAT_CTAS:
            break
    return k, ctas


def _dpre_xhat(x, g, mean, inv, gamma, beta, act):
    """(dpre, xhat, gamma) of x (B, C, *spatial) as (B, G, C/G, HW) f32 from
    the (B, G) statistics: dpre = g * silu'(y) on the SiLU route."""
    b, c = x.shape[0], x.shape[1]
    groups = mean.shape[1]
    cg = c // groups
    xf = x.float().reshape(b, groups, cg, -1)
    xhat = (xf - mean[..., None, None]) * inv[..., None, None]
    gam = gamma.float().reshape(1, groups, cg, 1)
    gf = g.float().reshape(xf.shape)
    if act == "silu":
        y = xhat * gam + beta.float().reshape(1, groups, cg, 1)
        sig = torch.sigmoid(y)
        gf = gf * (sig * (1.0 + y * (1.0 - sig)))
    return gf, xhat, gam


def gn_bwd_stats_plain(x, g, mean, inv, gamma, beta, act: str | None):
    """Plain version of gn_bwd_stats: (sums (B, G, 2), dparam (B, 2, C)), f32."""
    dpre, xhat, gam = _dpre_xhat(x, g, mean, inv, gamma, beta, act)
    dgamma, dbeta = (dpre * xhat).sum(3), dpre.sum(3)          # (B, G, C/G)
    sums = torch.stack([(gam[..., 0] * dbeta).sum(-1), (gam[..., 0] * dgamma).sum(-1)], -1)
    dparam = torch.stack([dgamma.reshape(x.shape[0], -1), dbeta.reshape(x.shape[0], -1)], 1)
    return sums, dparam


def _check_split(name, x, g, mean, inv, sums=None) -> tuple[int, int, int, int]:
    """Validate the split backward's operands; return (B, C, HW, G)."""
    if mean.dim() != 2 or mean.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: mean must be (B, G), got {tuple(mean.shape)}")
    groups = mean.shape[1]
    b, c, hw = _check(x, groups, name)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"{name}: g must be contiguous with x's shape and dtype")
    stats = [(mean, (b, groups)), (inv, (b, groups))]
    if sums is not None:
        stats.append((sums, (b, groups, 2)))
    for t, shape in stats:
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: statistics must be contiguous float32 {shape}")
        if t.device != x.device or g.device != x.device:
            raise ValueError(f"{name}: every operand must be on x's device")
    return b, c, hw, groups


@kernel_wrapper(_SRC, "tango_tpu/ops/gn_silu_pallas.py:119", backward=True)
def gn_bwd_stats(x, g, mean, inv, gamma, beta, act: str | None = None):
    """The first half of GroupNorm(+SiLU)'s backward over a slab x (B, C,
    *spatial) for the incoming gradient g, with the forward's statistics
    mean, inv (B, G) f32: (sums (B, G, 2): sum gamma*dpre and sum
    gamma*dpre*xhat over the slab's part of each group; dparam (B, 2, C): the
    slab's dgamma and dbeta of each sample), all f32."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown fused act {act}")
    _check_split("gn_bwd_stats", x, g, mean, inv)
    if not _route(x, "gn_bwd_stats"):
        return gn_bwd_stats_plain(x, g, mean, inv, gamma, beta, act)
    return _launch_bwd_stats(x, g, mean, inv, gamma, beta, act)


def _launch_bwd_stats(x, g, mean, inv, gamma, beta, act: str | None):
    """Launch gn_bwd_stats into new outputs. The C entry point takes the
    cluster body where gn_bwd_stats_cluster_size gives R > 0 and x, g are
    16-byte aligned: one launch, nothing to zero; count_cluster holds its
    report to that. The streaming fallback takes B*G zeroed group tickets."""
    b, c, hw, groups = x.shape[0], x.shape[1], math.prod(x.shape[2:]), mean.shape[1]
    lib = _build.load()
    g32, b32 = _param_f32(gamma, c, x.device), _param_f32(beta, c, x.device)
    dparam = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    sums = torch.empty((b, groups, 2), device=x.device, dtype=torch.float32)
    cluster = (gn_bwd_stats_cluster_size(x.dtype, b, c, hw, groups) > 0
               and not (x.data_ptr() | g.data_ptr()) % 16)
    done = None if cluster else torch.zeros(b * groups, device=x.device, dtype=torch.int32)
    code = lib.tt_gn_bwd_stats(
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), inv.data_ptr(), g32.data_ptr(),
        b32.data_ptr(), dparam.data_ptr(), sums.data_ptr(), None if done is None else
        done.data_ptr(), b, c, hw, groups, int(act == "silu"), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    ran = code == CLUSTER_LAUNCHED
    _build.check(lib, 0 if ran else code, "gn_bwd_stats")
    count_cluster(gn_bwd_stats, cluster, ran)
    gn_bwd_stats.launches += 1
    gn_bwd_stats.shapes.add((tuple(x.shape), groups, act))
    return sums, dparam


gn_bwd_stats.cluster_launches = 0


def gn_bwd_apply_plain(x, g, mean, inv, gamma, beta, act: str | None, sums, count: int):
    """Plain version of gn_bwd_apply: dx in x's dtype."""
    dpre, xhat, gam = _dpre_xhat(x, g, mean, inv, gamma, beta, act)
    m1 = (sums[..., 0] / float(count))[..., None, None]
    m2 = (sums[..., 1] / float(count))[..., None, None]
    dx = inv[..., None, None] * (gam * dpre - m1 - xhat * m2)
    return dx.reshape(x.shape).to(x.dtype)


@kernel_wrapper(_SRC, "tango_tpu/ops/gn_silu_pallas.py:119", backward=True)
def gn_bwd_apply(x, g, mean, inv, gamma, beta, act: str | None, sums, count: int):
    """The second half: dx = inv * (gamma*dpre - m1 - xhat*m2) over the slab x,
    m1 and m2 the group means of gamma*dpre and gamma*dpre*xhat, `sums`
    (gn_bwd_stats' (B, G, 2), summed over every slab) over `count` elements
    a group."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown fused act {act}")
    _check_split("gn_bwd_apply", x, g, mean, inv, sums)
    if not _route(x, "gn_bwd_apply"):
        return gn_bwd_apply_plain(x, g, mean, inv, gamma, beta, act, sums, count)
    return _launch_bwd_apply(x, g, mean, inv, gamma, beta, act, sums, count)


def _launch_bwd_apply(x, g, mean, inv, gamma, beta, act: str | None, sums, count: int):
    """Launch gn_bwd_apply into a new dx. The C entry point takes the flat
    body where HW is a whole number of 16-byte packets and x, g, dx are
    16-byte aligned; count_cluster holds its report to that."""
    b, c, hw, groups = x.shape[0], x.shape[1], math.prod(x.shape[2:]), mean.shape[1]
    lib = _build.load()
    g32, b32 = _param_f32(gamma, c, x.device), _param_f32(beta, c, x.device)
    dx = torch.empty_like(x)
    flat = (not hw % (16 // x.element_size())
            and not any(t.data_ptr() % 16 for t in (x, g, dx)))
    code = lib.tt_gn_bwd_apply(
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), inv.data_ptr(), g32.data_ptr(),
        b32.data_ptr(), sums.data_ptr(), dx.data_ptr(), b, c, hw, groups, float(count),
        int(act == "silu"), _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    ran = code == FLAT_LAUNCHED
    _build.check(lib, 0 if ran else code, "gn_bwd_apply")
    count_cluster(gn_bwd_apply, flat, ran, body="flat")
    gn_bwd_apply.launches += 1
    gn_bwd_apply.shapes.add((tuple(x.shape), groups, act))
    return dx


gn_bwd_apply.flat_launches = 0
