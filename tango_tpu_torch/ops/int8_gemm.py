"""W8A8 GEMM with dynamic per-row activation quantization, and its plain version.

One kernel from `csrc/int8_gemm.cu`, `w8a8_matmul`, replaces `_w8a8_kernel`
(tango_tpu/ops/int8_gemm.py:30). It computes, for x (..., K) f32 or bf16 and
an int8 weight w_q (N, K) with f32 per-output-channel scales w_scale (N,):

    scale = max(rowmax |x|, 1e-8) * (1/127)          (f32, per row)
    xq    = clip(round_half_even(x / scale), -127, 127)   (int8)
    acc   = xq @ w_q^T                                (exact, int32)
    out   = acc * scale * w_scale                     (f32, cast to x.dtype)

The weight is in `F.linear`'s layout (out, in), the transpose of JAX's
(K, N) kernel: a row of w_q is K contiguous bytes, what `__dp4a` reads four
at a time. The scale formula is the Pallas kernel's `amax * (1/127)`; JAX's
XLA route (`int8_dot`) divides by 127 instead, which can differ in the last
bit and flip one int8 value sitting on a .5 boundary.

The wrapper launches the kernel for a CUDA tensor and runs the plain version
for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import math

import torch

from tango_tpu_torch.ops import _build, kernel_wrapper

_SRC = "tango_tpu_torch/csrc/int8_gemm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32 = 2**31
_TILE = 64  # the kernel's rows and columns a block


def kernel_shape_ok(m: int, k: int, n: int) -> bool:
    """Whether the kernel takes an (M, K) x (N, K) product: M, K, N and the
    (M-tile) block count are 32-bit, the N-tiles fit grid.y's 65535, and the
    int32 accumulator holds K * 127^2."""
    return (0 < m < _INT32 and 0 < n and 0 < k and k * 127 * 127 < _INT32
            and math.ceil(n / _TILE) <= 65535)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's activation quantization of x (M, K): (int8 xq, f32 scale (M, 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-8) * (1.0 / 127.0)
    return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8), scale


def w8a8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor):
    """Plain version of w8a8_matmul. The integer product runs in float64,
    which is exact: every partial sum is an integer below K * 127^2 < 2^31 <
    2^53."""
    xq, scale = quantize_rows(x.reshape(-1, x.shape[-1]))
    acc = xq.double() @ w_q.double().t()
    out = acc.float() * scale * w_scale.float()
    return out.to(x.dtype).reshape(*x.shape[:-1], w_q.shape[0])


@kernel_wrapper(_SRC, "tango_tpu/ops/int8_gemm.py:30")
def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) f32/bf16 @ w_q (N, K) int8 with w_scale (N,) f32 -> (..., N) in x.dtype."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"w8a8_matmul: dtype {x.dtype} not supported (float32, bfloat16)")
    if w_q.dtype != torch.int8 or w_q.dim() != 2:
        raise ValueError(f"w8a8_matmul: w_q must be a 2-D int8 tensor, got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    n, k = w_q.shape
    if x.shape[-1] != k or w_scale.shape != (n,):
        raise ValueError(f"w8a8_matmul: x {tuple(x.shape)}, w_q {tuple(w_q.shape)} and "
                         f"w_scale {tuple(w_scale.shape)} do not match")
    m = math.prod(x.shape[:-1])
    if not kernel_shape_ok(m, k, n):
        raise ValueError(f"w8a8_matmul: ({m}, {k}) x ({n}, {k}) exceeds the kernel's limits")
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, w_q, w_scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"w8a8_matmul: no kernel for device {x.device}")
    if w_q.device != x.device or w_scale.device != x.device:
        raise ValueError("w8a8_matmul: w_q and w_scale must be on x's device")
    lib = _build.load()
    x2 = x.reshape(m, k).contiguous()
    wq = w_q.contiguous()
    ws = w_scale.to(torch.float32).contiguous()
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    code = lib.tt_w8a8_gemm(
        x2.data_ptr(), wq.data_ptr(), ws.data_ptr(), y.data_ptr(), m, n, k,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "w8a8_matmul")
    w8a8_matmul.launches += 1
    w8a8_matmul.shapes.add(((m, k), (n, k)))
    return y.reshape(*x.shape[:-1], n)
