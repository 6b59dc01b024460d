"""Normalization and activation building blocks (port of tango_tpu/ops/basic.py).

`group_norm` takes channels-FIRST activations (B, C, *spatial), the layout the
port's convolutions run in; it matches torch.nn.GroupNorm(num_groups, C, eps)
with f32 statistics. Dispatch follows the JAX rule (tango_tpu/ops/basic.py:52-63):
the single-pass kernel when one sample's f32 copy is at most 8 MB, else the
two-stage kernel for at most 64 groups, else the plain reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tango_tpu_torch.ops.gn_silu import gn_silu_fwd, group_norm_two_stage, n_chunks

_SINGLE_PASS_BYTES = 8 * 1024 * 1024


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gn_single_pass_supported(x: torch.Tensor, num_groups: int) -> bool:
    """gn_pallas_supported (gn_silu_pallas.py:107-113): f32 sample <= 8 MB."""
    c, s = x.shape[1], math.prod(x.shape[2:])
    return c % num_groups == 0 and s * c * 4 <= _SINGLE_PASS_BYTES


def gn_two_stage_supported(x: torch.Tensor, num_groups: int) -> bool:
    """gn_pallas2_supported (gn_silu_pallas.py:334-341): G <= 64, chunk <= 8 MB."""
    c, s = x.shape[1], math.prod(x.shape[2:])
    if c % num_groups != 0 or 2 * num_groups > 128:
        return False
    return (s // n_chunks(s)) * c * 4 <= _SINGLE_PASS_BYTES


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


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
    act: str | None = None,
) -> torch.Tensor:
    """GroupNorm(+SiLU) over x (B, C, *spatial); scale, bias (C,)."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown fused act {act}")
    if x.shape[1] % num_groups:
        raise ValueError(f"channels {x.shape[1]} not divisible by groups {num_groups}")
    x = x.contiguous()
    if gn_single_pass_supported(x, num_groups):
        return gn_silu_fwd(x, scale, bias, num_groups, eps, act)
    if gn_two_stage_supported(x, num_groups):
        return group_norm_two_stage(x, scale, bias, num_groups, eps, act)
    return _gn_reference(x, scale, bias, num_groups, eps, act)


def geglu(x: torch.Tensor) -> torch.Tensor:
    """GEGLU gate with exact (erf) GELU on the gate half (tango_tpu/ops/basic.py:133-140)."""
    h, gate = x.chunk(2, dim=-1)
    return h * F.gelu(gate, approximate="none")
