"""Winograd F(2x2, 3x3) convolution: the kernel, its plain version, its VJP.

`winograd_conv3x3` (C entry point `tt_wino_conv3x3`) replaces `_wino_kernel`
(tango_tpu/ops/winograd.py:100): a 3x3 stride-1 SAME conv computed per 2x2
output tile from a 4x4 input tile,

    Y = A^T [ (G g G^T) . (B^T d B) ] A

with the 16 channel contractions M[pq] = V[pq] @ U[pq] accumulated in f32.
V = B^T d B is computed in f32 and rounded to x.dtype, U = G g G^T likewise
(tango_tpu/ops/winograd.py:74, 198): in bf16 both packages round there.

Both types run the tensor-core body of `csrc/winograd_tc.cu`
(`wino_tc_body`): V for all 16 points into scratch, then the 16
contractions on `wgmma` with the output transform in registers, bf16
products in bf16 and 3xTF32 products in f32 (one-product TF32 would miss
JAX's f32 limit). It takes U as (16, Co, Cs), K-major, Cs = Ci rounded up to
16 with zeros. The C entry point (`csrc/winograd.cu`) reports the body it
launched; `winograd_conv3x3.tc_launches` counts the tensor-core launches.

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

from tango_tpu_torch.ops import _build, count_tc, kernel_wrapper, reported_tc

_TC_SRC = "tango_tpu_torch/csrc/winograd_tc.cu"  # the bodies; the entry point is winograd.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32 = 2**31
_TC_TILES, _TC_CO = 128, 64  # the GEMM's 2x2 tiles and output channels a block
_IN_TILES, _IN_F32_CHANNELS = 32, 16  # the input transform's tiles and f32 channels a block

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


def wino_tc_body(dtype: torch.dtype) -> bool:
    """Whether winograd_conv3x3 runs on the tensor-core body
    (csrc/winograd_tc.cu): f32 (3xTF32 products) and bf16, every type it
    takes, at any Ci (V and U are zero-padded to Cs = Ci rounded up to 16
    channels). The C entry point applies the same rule (`wino_tc_body` in
    csrc/winograd.cu); the counter checks its report against this one."""
    return dtype in _DTYPES


def kernel_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """U = G w G^T of an OIHW weight, computed in f32 and rounded to `dtype`,
    in the body's layout: (16, Co, Cs) with Cs = Ci rounded up to 16 (zeros
    past Ci)."""
    co, ci = w.shape[:2]
    u = winograd_weight_transform(w.float()).to(dtype).reshape(16, ci, co)
    return F.pad(u.transpose(1, 2), (0, -ci % 16)).contiguous()


def weight_tc(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """U of the tensor-core body in `dtype` from an OIHW weight on the card,
    by its own kernel (`tt_wino_weight`): the same values and layout as
    `kernel_weight(w, dtype)` (the f32 sums of halves in another order at
    most)."""
    co, ci = w.shape[:2]
    wf = w.float().contiguous()
    u = torch.empty((16, co, ci + -ci % 16), device=w.device, dtype=dtype)
    lib = _build.load()
    _build.check(lib, lib.tt_wino_weight(wf.data_ptr(), u.data_ptr(), co, ci, _DTYPES[dtype],
                                         torch.cuda.current_stream(w.device).cuda_stream),
                 "winograd_conv3x3")
    return u


def wino_splits(tiles: int, co: int, sms: int) -> int:
    """Over how many blocks the tensor-core body splits the 16 points of a
    (128-tile, 64-channel) output block: 1 where those blocks number at
    least half of the card's `sms` SMs, else the smallest power of two up to
    16 that gives every SM a block (the UNet's deep levels: 20 to 40
    blocks). The splits' f32 partial sums are added in order."""
    blocks = math.ceil(tiles / _TC_TILES) * math.ceil(co / _TC_CO)
    splits = 1
    if 2 * blocks < sms:
        while splits < 16 and blocks * splits < sms:
            splits *= 2
    return splits


def kernel_shape_ok(x_shape, co: int) -> bool:
    """Whether the kernel takes x (B, Ci, H, W) to Co channels: the block
    counts of its GEMM and input transform (in f32, the type with fewer
    channels a block) fit grid.x (2^31 - 1), the dimensions 32 bits."""
    b, ci, h, w = x_shape
    tiles = b * (h // 2) * (w // 2)
    return (math.ceil(tiles / _TC_TILES) * 16 * math.ceil(co / _TC_CO) < _INT32
            and math.ceil(tiles / _IN_TILES) * math.ceil((ci + -ci % 16) / _IN_F32_CHANNELS)
            < _INT32 and max(ci, h * w, co) < _INT32)


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


@kernel_wrapper(_TC_SRC, "tango_tpu/ops/winograd.py:100")
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
    return launch(x.contiguous(), weight_tc(w, x.dtype), w.shape[0])


def launch(x: torch.Tensor, u: torch.Tensor, co: int) -> torch.Tensor:
    """The kernel alone: launch winograd_conv3x3 on a contiguous CUDA x
    (B, Ci, H, W) with U from `kernel_weight(w, x.dtype)` (or `weight_tc`)
    into a new (B, Co, H, W) output; winograd_conv3x3.tc_launches counts the
    tensor-core launches the C entry point reports."""
    b, ci, h, ww = x.shape
    y = torch.empty((b, co, h, ww), device=x.device, dtype=x.dtype)
    # the scratch: V (16, tiles, Cs), and the splits' partial sums
    tiles = b * (h // 2) * (ww // 2)
    v = torch.empty((16, tiles, ci + -ci % 16), device=x.device, dtype=x.dtype)
    splits = wino_splits(tiles, co, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    part = None
    if splits > 1:
        part = torch.empty((splits, b, co, h, ww), device=x.device, dtype=torch.float32)
    lib = _build.load()
    code = lib.tt_wino_conv3x3(
        x.data_ptr(), u.data_ptr(), y.data_ptr(), v.data_ptr(),
        part.data_ptr() if splits > 1 else None, splits, b, ci, h, ww, co, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    ran = reported_tc(lib, code, "winograd_conv3x3")
    winograd_conv3x3.launches += 1
    winograd_conv3x3.shapes.add((tuple(x.shape), (co, ci, 3, 3)))
    count_tc(winograd_conv3x3, wino_tc_body(x.dtype), ran)
    return y


winograd_conv3x3.tc_launches = 0


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
