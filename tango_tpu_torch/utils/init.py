"""Seeded random weights in the scales of Flax's default initializers.

There are no released weights in the repository, so a full-width run uses
random ones: kernels normal with variance 1/fan_in (Flax's `lecun_normal`
has that variance), biases zero, norm scales one, embedding tables standard
normal; BatchNormEval's running statistics mean 0, variance 1, and the Swin
blocks' relative-position bias tables normal with std 0.02 (the JAX
modules' initializers). Weights are drawn in place on the module's device from an explicit
`torch.Generator`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tango_tpu_torch.eval.panns import BatchNormEval
from tango_tpu_torch.models.htsat import WindowAttention
from tango_tpu_torch.models.layers import GroupNorm
from tango_tpu_torch.models.t5 import T5LayerNorm


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fan_in = m.in_features
        elif isinstance(m, nn.ConvTranspose1d):
            fan_in = m.in_channels * math.prod(m.kernel_size)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
            continue
        elif isinstance(m, (nn.LayerNorm, GroupNorm, T5LayerNorm, BatchNormEval)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
            if isinstance(m, BatchNormEval):
                m.mean.zero_()
                m.var.fill_(1.0)
            continue
        elif isinstance(m, WindowAttention):  # its qkv and proj come as Linears
            m.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)
            continue
        else:
            continue
        m.weight.normal_(0.0, fan_in**-0.5, generator=generator)
        if m.bias is not None:
            m.bias.zero_()
    return module
