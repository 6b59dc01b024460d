"""Normalization and activation building blocks (port of tango_tpu/ops/basic.py).

`group_norm` takes channels-FIRST activations (B, C, *spatial), the layout the
port's convolutions run in; it matches torch.nn.GroupNorm(num_groups, C, eps)
with f32 statistics. Dispatch follows the JAX rule (tango_tpu/ops/basic.py:52-63):
the single-pass kernel when one sample's f32 copy is at most 8 MB, else the
two-stage kernel for at most 64 groups, else the plain reference. Under
sequence parallelism (`sp=`) every call takes the two-stage kernels, split
at their combine by an all-reduce of the partial sums: the single pass
would see one slab's statistics. Its backward is split the same way
(`_SeqGroupNorm`): gn_bwd_stats on the slab, its group sums all-reduced
over 'model', gn_bwd_apply; dgamma and dbeta stay the slab's (partial:
the trainer sums the replicated parameters' gradients over 'model').

The kernel routes are one autograd Function (`_gn_pallas_vjp` of
tango_tpu/ops/basic.py:87-130): its forward is the single-pass or two-stage
kernel, it saves x, scale and bias, and its backward is the `gn_silu_bwd`
kernel. JAX sends the backward of a GroupNorm whose f32 sample exceeds 8 MB
to the XLA VJP: that limit is VMEM's. The CUDA kernel streams a group from
device memory, so here it serves the backward of every GroupNorm whose
forward took a kernel, the two-stage sites included; only a shape it cannot
take (more than 4096 channels a group, `gn_bwd_supported`) differentiates
through the plain reference, as JAX does beyond its limit. The plain route
is plain torch autograd, as it is XLA autodiff in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tango_tpu_torch.ops.gn_silu import (
    gn_bwd_apply,
    gn_bwd_stats,
    gn_bwd_supported,
    gn_silu_bwd,
    gn_silu_fwd,
    group_norm_from_stats,
    group_norm_two_stage,
    group_stats,
    group_sums,
    kernel_shape_ok,
    n_chunks,
)
from tango_tpu_torch.parallel.mesh import all_reduce_over_model_

_SINGLE_PASS_BYTES = 8 * 1024 * 1024


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gn_single_pass_supported(x: torch.Tensor, num_groups: int) -> bool:
    """gn_pallas_supported (gn_silu_pallas.py:107-113): f32 sample <= 8 MB;
    and the kernels' 32-bit dimensions (`kernel_shape_ok`)."""
    c, s = x.shape[1], math.prod(x.shape[2:])
    return (c % num_groups == 0 and s * c * 4 <= _SINGLE_PASS_BYTES
            and kernel_shape_ok(x, num_groups))


def gn_two_stage_supported(x: torch.Tensor, num_groups: int) -> bool:
    """gn_pallas2_supported (gn_silu_pallas.py:334-341): G <= 64, chunk <= 8 MB;
    and the kernels' 32-bit dimensions (`kernel_shape_ok`)."""
    c, s = x.shape[1], math.prod(x.shape[2:])
    if c % num_groups != 0 or 2 * num_groups > 128:
        return False
    return (s // n_chunks(s)) * c * 4 <= _SINGLE_PASS_BYTES and kernel_shape_ok(x, num_groups)


def _gn_reference(x, scale, bias, num_groups, eps, act):
    """Two-pass f32 GroupNorm (the XLA path of tango_tpu/ops/basic.py:64-80)."""
    b, c = x.shape[0], x.shape[1]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    out = xf * scale.float().reshape(shape) + bias.float().reshape(shape)
    if act == "silu":
        out = silu(out)
    return out.to(x.dtype)


class _GroupNormKernel(torch.autograd.Function):
    """GroupNorm(+SiLU) through the forward kernels, with gn_silu_bwd as backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act, two_stage):
        fwd = group_norm_two_stage if two_stage else gn_silu_fwd
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, act)
        return fwd(x, scale, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        num_groups, eps, act = ctx.cfg
        g = g.to(x.dtype).contiguous()
        if gn_bwd_supported(x, num_groups):
            dx, dscale, dbias = gn_silu_bwd(x, g, scale, bias, num_groups, eps, act)
        else:
            with torch.enable_grad():
                xx, ss, bb = (t.detach().requires_grad_() for t in (x, scale, bias))
                out = _gn_reference(xx, ss, bb, num_groups, eps, act)
                dx, dscale, dbias = torch.autograd.grad(out, (xx, ss, bb), g)
        return dx, dscale, dbias, None, None, None, None


class _SeqGroupNorm(torch.autograd.Function):
    """GroupNorm(+SiLU) of a slab under sequence parallelism: gn_stats, the
    sums all-reduced over 'model', gn_apply; backward gn_bwd_stats, its sums
    all-reduced over 'model', gn_bwd_apply. Saves x, scale, bias and the
    group statistics (B, G) f32."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act, sp):
        count = math.prod(x.shape[2:]) * sp.shape["model"] * (x.shape[1] // num_groups)
        mean, inv = group_stats(all_reduce_over_model_(group_sums(x, num_groups), sp), count,
                                eps)
        ctx.save_for_backward(x, scale, bias, mean, inv)
        ctx.cfg = (act, sp, count)
        return group_norm_from_stats(x, mean, inv, scale, bias, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, mean, inv = ctx.saved_tensors
        act, sp, count = ctx.cfg
        g = g.to(x.dtype).contiguous()
        sums, dparam = gn_bwd_stats(x, g, mean, inv, scale, bias, act)
        all_reduce_over_model_(sums, sp, "group_norm_grad")
        dx = gn_bwd_apply(x, g, mean, inv, scale, bias, act, sums, count)
        dscale, dbias = dparam[0] if dparam.shape[0] == 1 else dparam.sum(0)  # no launch at B = 1
        return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None, None, None


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
    act: str | None = None,
    sp=None,
) -> torch.Tensor:
    """GroupNorm(+SiLU) over x (B, C, *spatial); scale, bias (C,).

    `sp`: the mesh over whose 'model' ranks x is a slab of the first spatial
    axis (sequence parallelism), whose groups span every slab. Then the
    two-stage kernels run split at their combine: gn_stats on the slab, its
    (B, G, 2) sums all-reduced over 'model', the combine over the whole
    group's count, gn_apply on the slab; the backward is split alike
    (`_SeqGroupNorm`)."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown fused act {act}")
    if x.shape[1] % num_groups:
        raise ValueError(f"channels {x.shape[1]} not divisible by groups {num_groups}")
    x = x.contiguous()
    if sp is not None:
        return _SeqGroupNorm.apply(x, scale, bias, num_groups, eps, act, sp)
    if gn_single_pass_supported(x, num_groups):
        return _GroupNormKernel.apply(x, scale, bias, num_groups, eps, act, False)
    if gn_two_stage_supported(x, num_groups):
        return _GroupNormKernel.apply(x, scale, bias, num_groups, eps, act, True)
    return _gn_reference(x, scale, bias, num_groups, eps, act)


def geglu(x: torch.Tensor) -> torch.Tensor:
    """GEGLU gate with exact (erf) GELU on the gate half (tango_tpu/ops/basic.py:133-140)."""
    h, gate = x.chunk(2, dim=-1)
    return h * F.gelu(gate, approximate="none")
