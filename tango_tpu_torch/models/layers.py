"""Layers shared by the port's models."""

from __future__ import annotations

import torch
from torch import nn

from tango_tpu_torch.ops.basic import group_norm


class GroupNorm(nn.Module):
    """GroupNorm(+SiLU) over channels-first (B, C, *spatial), through ops.basic.group_norm."""

    def __init__(self, channels: int, groups: int, eps: float, act: str | None = None):
        super().__init__()
        self.groups, self.eps, self.act = groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        """`sp`: the mesh whose 'model' ranks hold x's slabs (ops.basic.group_norm)."""
        return group_norm(x, self.weight, self.bias, self.groups, self.eps, self.act, sp)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def frozen(make, params, device) -> nn.Module:
    """Build module `make()` on `device` in f32 from state dict `params`
    (strict), for inference: eval mode, no gradients."""
    with torch.device("meta"):
        m = make()
    m = m.to_empty(device=device).to(torch.float32)
    m.load_state_dict(params)
    return m.eval().requires_grad_(False)
