"""int8 W8A8 serving mode of the UNet (port of tango_tpu/ops/quant.py).

Scheme, as JAX's: symmetric, zero-point-free int8.
  * weights: per-output-channel scales, quantized once at load time
    (`quantize_weight`, `quantize_unet_`): an int8 weight and an f32
    `weight_scale` buffer;
  * activations: dynamic scales, per token for the dense layers and per
    sample for the convolutions;
  * exact integer accumulation, dequantized in f32 and cast back to the
    compute dtype, then the float bias.

Routes. A quantized `Linear` (`QLinear`) runs `int8_dot`, which is the
`w8a8_matmul` kernel on the card (JAX keeps this on the XLA int8 dot; the
function is the same, tests/test_quant.py:54-65, up to the scale formula
noted in ops/int8_gemm.py). A quantized `Conv2d` (`QConv2d`) runs `int8_conv`:
the activation quantized per sample, an int8 im2col, and an exact integer
GEMM, `torch._int_mm` on the card where its shape rules hold (`int_mm_ok`)
and a float64 product otherwise, which is exact for every K the UNet has.
JAX computes that convolution in XLA, outside any Pallas kernel, and so the
port leaves it to a library GEMM.

The final conv_out, conv_in, the time embedding, the norms and the softmax
stay in the compute dtype.

Under sequence parallelism (models/unet.py) a QConv2d runs on a T-slab
with its halo rows: `int8_conv` then takes the whole tensor's per-sample
amax (the largest of every slab's `act_amax`, all-reduced over the mesh's
'model' ranks) and pads only F, so each slab's int8 values are the ones the
meshless quantize gives.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tango_tpu_torch.ops.int8_gemm import w8a8_matmul

# names of the Linear / Conv2d modules quantized inside the UNet; the
# modules under `time_embedding` never are (tango_tpu/ops/quant.py:157-163)
QUANT_DENSE = {
    "to_q", "to_k", "to_v", "to_qkv", "to_kv", "to_out_0",
    "net_0_proj", "net_2", "proj_in", "proj_out",
    "proj_in_conv", "proj_out_conv",
}
QUANT_CONV = {"conv1", "conv2", "conv_shortcut", "conv"}  # "conv" = up/downsamplers
_SKIP_PARENTS = {"time_embedding"}
SCOPES = ("all", "dense", "conv")


def quant_names(scope: str) -> set:
    """The module names a scope quantizes."""
    if scope not in SCOPES:
        raise ValueError(f"quant scope must be one of {SCOPES}, got {scope!r}")
    return (QUANT_DENSE if scope in ("all", "dense") else set()) | (
        QUANT_CONV if scope in ("all", "conv") else set())


def quantize_weight(w: Union[np.ndarray, torch.Tensor], out_axis: int = -1):
    """Per-output-channel symmetric int8 quantization (tango_tpu/ops/quant.py:32-44):
    (int8 weight, f32 scale over the `out_axis` channels), computed in f32 as
    JAX's numpy function does, bit for bit. A numpy array gives numpy
    arrays; a tensor gives tensors on its device."""
    as_numpy = isinstance(w, np.ndarray)
    t = torch.from_numpy(np.asarray(w, np.float32)) if as_numpy else w.float()
    axis = out_axis % t.dim()
    amax = t.abs().amax(dim=[i for i in range(t.dim()) if i != axis])
    scale = amax.clamp(min=1e-8) / 127.0
    shape = [1] * t.dim()
    shape[axis] = -1
    q = torch.round(t / scale.reshape(shape)).clamp_(-127, 127).to(torch.int8)
    return (q.numpy(), scale.numpy()) if as_numpy else (q, scale)


def _quantize_act(x: torch.Tensor, dims, amax=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 activation quantization over `dims`, JAX's
    `amax / 127` formula; `amax` given (keepdim-shaped) in place of x's own."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=dims, keepdim=True)
    scale = amax.clamp(min=1e-8) / 127.0
    return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8), scale


def int8_dot(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ int8 w_q (N, K) with per-token activation scales, through
    the w8a8_matmul kernel; the result in x.dtype (JAX's f32 result cast to
    the compute dtype, as its QDense does)."""
    return w8a8_matmul(x, w_q, w_scale)


def int_mm_ok(m: int, k: int, n: int) -> bool:
    """`torch._int_mm`'s shape rules on CUDA: M > 16, K and N multiples of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def _int_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact a (M, K) int8 @ w (N, K)^T int8 -> (M, N) f32 of the integer sums.

    On the card `torch._int_mm` where `int_mm_ok` holds; elsewhere a float64
    product, exact because every partial sum is an integer below K * 127^2 <
    2^53. The f32 result is the int32 sum rounded to nearest, as JAX's
    `astype(float32)`."""
    (m, k), n = a.shape, w.shape[0]
    if a.is_cuda and int_mm_ok(m, k, n):
        return torch._int_mm(a, w.t()).float()
    return (a.double() @ w.double().t()).float()


def act_amax(x: torch.Tensor) -> torch.Tensor:
    """x's (B, C, H, W) per-sample amax over C, H, W in f32, (B, 1, 1, 1):
    what `int8_conv` scales by."""
    return x.detach().float().abs().amax(dim=(1, 2, 3), keepdim=True)


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, stride: int = 1,
              padding=1, amax=None) -> torch.Tensor:
    """NCHW conv with int8 inputs (tango_tpu/ops/quant.py:73-82): x (B, C, H, W)
    quantized with one scale a sample (amax over C, H, W), w_q (N, C, kh, kw)
    int8, w_scale (N,) f32, `stride`; f32 (B, N, Ho, Wo). `padding` is
    symmetric, one int for both axes or an (H, W) pair. Sequence parallelism
    passes (0, p) for a T-slab that carries its halo rows, and `amax`, the
    (B, 1, 1, 1) amax of the whole tensor (`act_amax` of every slab, the
    largest taken over them), so that the slab quantizes as the whole does."""
    xq, xs = _quantize_act(x, dims=(1, 2, 3), amax=amax)
    b, c, h, w = x.shape
    n, _, kh, kw = w_q.shape
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    if ph or pw:
        xq = F.pad(xq, (pw, pw, ph, ph))
    ho = (h + 2 * ph - kh) // stride + 1
    wo = (w + 2 * pw - kw) // stride + 1
    # int8 im2col: cols[b, ho, wo, (c, i, j)] = xq[b, c, stride*ho + i, stride*wo + j],
    # the (c, i, j) order of w_q's flattened rows
    cols = torch.stack([xq[:, :, i:i + stride * (ho - 1) + 1:stride,
                           j:j + stride * (wo - 1) + 1:stride]
                        for i in range(kh) for j in range(kw)], dim=2)
    cols = cols.permute(0, 3, 4, 1, 2).reshape(b * ho * wo, c * kh * kw)
    acc = _int_gemm(cols, w_q.reshape(n, -1))
    y = acc.reshape(b, ho, wo, n) * xs.reshape(b, 1, 1, 1) * w_scale.float()
    return y.permute(0, 3, 1, 2)


class QLinear(nn.Module):
    """`nn.Linear` in the int8 mode (QDense, tango_tpu/ops/quant.py:85-117): an
    int8 `weight` (out, in) and an f32 `weight_scale` (out,) as buffers, a
    float `bias`. `from_float` quantizes a Linear."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    @classmethod
    def from_float(cls, m: nn.Linear) -> "QLinear":
        with torch.device(m.weight.device):
            q = cls(m.in_features, m.out_features, m.bias is not None)
        return _fill(q, m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_dot(x, self.weight, self.weight_scale)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class QConv2d(nn.Module):
    """`nn.Conv2d` in the int8 mode (QConv, tango_tpu/ops/quant.py:120-154): an
    int8 `weight` (out, in, kh, kw) and an f32 `weight_scale` (out,) as
    buffers, a float `bias`; symmetric padding and one stride for both axes."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.register_buffer("weight", torch.zeros(out_channels, in_channels, kernel_size,
                                                   kernel_size, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    @classmethod
    def from_float(cls, m: nn.Conv2d) -> "QConv2d":
        (kh, kw), (sh, sw), pad = m.kernel_size, m.stride, m.padding
        if kh != kw or sh != sw or not isinstance(pad, tuple) or pad[0] != pad[1] \
                or m.groups != 1 or m.dilation != (1, 1):
            raise ValueError(f"QConv2d: unsupported conv {m}")
        with torch.device(m.weight.device):
            q = cls(m.in_channels, m.out_channels, kh, sh, pad[0], m.bias is not None)
        return _fill(q, m)

    def forward(self, x: torch.Tensor, padding=None, amax=None) -> torch.Tensor:
        """`padding` (an (H, W) pair) and `amax` as `int8_conv` takes them, in
        place of the module's own padding and x's own amax (a T-slab under
        sequence parallelism)."""
        pad = self.padding if padding is None else padding
        y = int8_conv(x, self.weight, self.weight_scale, self.stride, pad, amax).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y.contiguous()  # int8_conv's result is laid out channels-last


def _fill(q: nn.Module, m: nn.Module) -> nn.Module:
    """Give q the quantized weight of m, and m's bias."""
    q.weight, q.weight_scale = quantize_weight(m.weight.detach(), out_axis=0)
    if m.bias is not None:
        q.bias = nn.Parameter(m.bias.detach().clone(), requires_grad=m.bias.requires_grad)
    return q


def quantize_unet_(unet: nn.Module, scope: str = "all") -> nn.Module:
    """Quantize a float UNet in place (the module form of `quantize_tree`,
    tango_tpu/ops/quant.py:166-192): every Linear / Conv2d whose own name is
    in the scope's set, outside `time_embedding`, becomes a QLinear / QConv2d
    holding its quantized weight. Scopes: "all" | "dense" | "conv"."""
    names = quant_names(scope)

    def swap(module: nn.Module) -> None:
        for name, child in list(module.named_children()):
            if name in _SKIP_PARENTS:
                continue
            if name in names and isinstance(child, nn.Linear):
                setattr(module, name, QLinear.from_float(child))
            elif name in names and isinstance(child, nn.Conv2d):
                setattr(module, name, QConv2d.from_float(child))
            else:
                swap(child)

    swap(unet)
    return unet
