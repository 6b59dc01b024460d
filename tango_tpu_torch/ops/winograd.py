"""Winograd F(2x2, 3x3) convolution: the kernel, its plain version, its VJP.

`winograd_conv3x3` (kernel `tt_wino_conv3x3`, `csrc/winograd.cu`) replaces
`_wino_kernel` (tango_tpu/ops/winograd.py:100): a 3x3 stride-1 SAME conv
computed per 2x2 output tile from a 4x4 input tile,

    Y = A^T [ (G g G^T) . (B^T d B) ] A

with the 16 channel contractions M[pq] = V[pq] @ U[pq] accumulated in f32.
V = B^T d B is computed in f32 and rounded to x.dtype, U = G g G^T likewise
(tango_tpu/ops/winograd.py:74, 198): in bf16 both packages round there.

The port's layout is NCHW for x and y and OIHW for the weight, PyTorch's;
`winograd_weight_transform` keeps JAX's (4, 4, Ci, Co) result. As in JAX,
nothing dispatches a convolution here: the UNet's 3x3 convolutions stay on
cuDNN, and `winograd_conv3x3_vjp` (forward the kernel, backward the direct
convolution's gradient) is there for a caller that wants it.

The wrapper launches the kernel for a CUDA tensor and runs the plain version
for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from tango_tpu_torch.ops import _build, kernel_wrapper

_SRC = "tango_tpu_torch/csrc/winograd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32 = 2**31
_TILES, _CO_BLOCK = 32, 32  # the kernel's 2x2 tiles and output channels a block

# F(2x2, 3x3) transform matrices (Lavin & Gray, arXiv:1509.09308)
_MATRICES = {
    "BT": ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1)),
    "G": ((1, 0, 0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0, 0, 1)),
    "AT": ((1, 1, 1, 0), (0, 1, -1, -1)),
}


@functools.lru_cache(maxsize=None)
def _matrix(name: str, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A transform matrix on `device`, made once: a copy from the host inside
    a CUDA graph capture would fail."""
    return torch.tensor(_MATRICES[name], dtype=dtype, device=device)


def winograd_weight_transform(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Co, Ci, 3, 3) -> U (4, 4, Ci, Co) = G w G^T per channel pair."""
    g = _matrix("G", w.device, w.dtype)
    return torch.einsum("pi,qj,dcij->pqcd", g, g, w)


def wino_supported(x_shape, k_shape, strides) -> bool:
    """3x3 stride-1 conv of an NCHW input with even H and W, OIHW weight."""
    return (
        len(k_shape) == 4
        and tuple(k_shape[2:]) == (3, 3)
        and tuple(strides) == (1, 1)
        and len(x_shape) == 4
        and x_shape[2] % 2 == 0
        and x_shape[3] % 2 == 0
    )


def kernel_shape_ok(x_shape, co: int) -> bool:
    """Whether the kernel takes x (B, Ci, H, W) to Co channels: the block
    counts fit grid.x (2^31 - 1) and grid.y (65535), the dimensions 32 bits."""
    b, ci, h, w = x_shape
    tiles = (h // 2) * (w // 2)
    return (b * math.ceil(tiles / _TILES) < _INT32 and math.ceil(co / _CO_BLOCK) <= 65535
            and max(ci, h * w, co) < _INT32)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"winograd_conv3x3: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] != x.shape[1]:
        raise ValueError(f"winograd_conv3x3: x {tuple(x.shape)} (B, Ci, H, W) and w "
                         f"{tuple(w.shape)} (Co, Ci, 3, 3) do not match")
    if not wino_supported(x.shape, w.shape, (1, 1)):
        raise ValueError(f"winograd_conv3x3: needs a 3x3 kernel and even H, W; got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if not kernel_shape_ok(x.shape, w.shape[0]):
        raise ValueError(f"winograd_conv3x3: x {tuple(x.shape)} exceeds the kernel's limits")


def winograd_conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of winograd_conv3x3: the XLA formulation
    (tango_tpu/ops/winograd.py:47-81) on NCHW, with its roundings of V and U
    to x.dtype and f32 products."""
    b, ci, h, ww = x.shape
    co = w.shape[0]
    th, tw = h // 2, ww // 2
    xp = F.pad(x, (1, 1, 1, 1))
    # overlapping 4x4 tiles at stride 2: d[i, j, b, c, t, s] = xp[b, c, 2t+i, 2s+j]
    d = torch.stack([torch.stack([xp[:, :, i:i + h:2, j:j + ww:2] for j in range(4)])
                     for i in range(4)]).float()
    bt = _matrix("BT", x.device, torch.float32)
    at = _matrix("AT", x.device, torch.float32)
    v = torch.einsum("pi,qj,ijbcts->pqbtsc", bt, bt, d).to(x.dtype)
    u = winograd_weight_transform(w.float()).to(x.dtype)
    m = torch.bmm(v.reshape(16, b * th * tw, ci).float(), u.reshape(16, ci, co).float())
    y = torch.einsum("ap,dq,pqbtsc->bctasd", at, at, m.reshape(4, 4, b, th, tw, co))
    return y.reshape(b, co, h, ww).to(x.dtype)


@kernel_wrapper(_SRC, "tango_tpu/ops/winograd.py:100")
def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv of x (B, Ci, H, W), H and W even, with w
    (Co, Ci, 3, 3), no bias -> (B, Co, H, W) in x.dtype."""
    _check(x, w)
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"winograd_conv3x3: no kernel for device {x.device}")
    if w.device != x.device:
        raise ValueError("winograd_conv3x3: w must be on x's device")
    b, ci, h, ww = x.shape
    co = w.shape[0]
    lib = _build.load()
    xc = x.contiguous()
    u = winograd_weight_transform(w.float()).to(x.dtype).reshape(16, ci, co).contiguous()
    y = torch.empty((b, co, h, ww), device=x.device, dtype=x.dtype)
    code = lib.tt_wino_conv3x3(
        xc.data_ptr(), u.data_ptr(), y.data_ptr(), b, ci, h, ww, co, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "winograd_conv3x3")
    winograd_conv3x3.launches += 1
    winograd_conv3x3.shapes.add((tuple(x.shape), tuple(w.shape)))
    return y


class _WinogradConv(torch.autograd.Function):
    """The kernel forward; the backward is the direct convolution's gradient
    (`_wino_bwd`, tango_tpu/ops/winograd.py:258-262), with g cast to x.dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return winograd_conv3x3(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xx, wv = x.detach().requires_grad_(), w.detach().requires_grad_()
            out = F.conv2d(xx, wv, padding=1)
            return torch.autograd.grad(out, (xx, wv), g.to(x.dtype))


def winograd_conv3x3_vjp(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """winograd_conv3x3 with the direct convolution's gradient."""
    return _WinogradConv.apply(x, w)
