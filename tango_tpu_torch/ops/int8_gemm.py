"""W8A8 GEMM with dynamic per-row activation quantization, and its plain version.

One kernel, `w8a8_matmul`, replaces `_w8a8_kernel`
(tango_tpu/ops/int8_gemm.py:30). It computes, for x (..., K) f32 or bf16 and
an int8 weight w_q (N, K) with f32 per-output-channel scales w_scale (N,):

    scale = max(rowmax |x|, 1e-8) * (1/127)          (f32, per row)
    xq    = clip(round_half_even(x / scale), -127, 127)   (int8)
    acc   = xq @ w_q^T                                (exact, int32)
    out   = acc * scale * w_scale                     (f32, cast to x.dtype)

The weight is in `F.linear`'s layout (out, in), the transpose of JAX's
(K, N) kernel: a row of w_q is K contiguous bytes, the K-major B operand an
8-bit `wgmma` takes. The scale formula is the Pallas kernel's
`amax * (1/127)`; JAX's XLA route (`int8_dot`) divides by 127 instead, which
can differ in the last bit and flip one int8 value sitting on a .5 boundary.

Two bodies, chosen by `w8a8_tc_body(K)` (K % 16 == 0, every dense layer of
the int8 UNet): the tensor-core body of `csrc/int8_gemm_tc.cu` quantizes x
once into scratch (xq (M, K) int8, scale (M,) f32) and multiplies on the
int8 tensor cores (`wgmma` s8); the CUDA-core body of `csrc/int8_gemm.cu`
(`__dp4a`) takes every other K. Both are bit-equal to the plain version. The
C entry point applies the same rule and reports the body it launched;
`w8a8_matmul.tc_launches` counts the tensor-core ones.

The wrapper launches the kernel for a CUDA tensor and runs the plain version
for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import math

import torch

from tango_tpu_torch.ops import _build, check_tc_aligned, count_tc, kernel_wrapper, reported_tc

_SRC = "tango_tpu_torch/csrc/int8_gemm.cu"  # the entry point and the __dp4a body
_TC_SRC = "tango_tpu_torch/csrc/int8_gemm_tc.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32 = 2**31
_TILE = 64  # the __dp4a body's rows and columns a block
_TC_TILE = 128  # the tensor-core body's rows and columns a block, and K bytes a stage


def kernel_shape_ok(m: int, k: int, n: int) -> bool:
    """Whether the kernel takes an (M, K) x (N, K) product: M, K, N and the
    (M-tile) block count are 32-bit, the N-tiles fit grid.y's 65535, and the
    int32 accumulator holds K * 127^2."""
    return (0 < m < _INT32 and 0 < n and 0 < k and k * 127 * 127 < _INT32
            and math.ceil(n / _TILE) <= 65535)


def w8a8_tc_body(k: int) -> bool:
    """Whether w8a8_matmul runs on the tensor-core body (csrc/int8_gemm_tc.cu)
    rather than the __dp4a one: K % 16 == 0, so that every row of x, of its
    int8 copy and of w_q is whole 16-byte copies; ragged M and N are masked.
    The C entry point applies the same rule (`w8a8_tc_body` in
    csrc/int8_gemm.cu); here it decides the scratch and the alignment check."""
    return k % 16 == 0


def w8a8_splits(m: int, k: int, n: int, sms: int) -> int:
    """Over how many blocks the tensor-core body splits K for each 128 x 128
    tile of y: the largest power of two, up to 16, that keeps at least 8 of
    the 128-byte K chunks in each split and the blocks within one wave on the
    card's `sms` SMs. Only a long K with few tiles splits (on the int8 path
    the feed-forward output projection, K = 5120, at M = 128 and 512);
    shorter K lose more to the partial sums than they gain on the H100
    (PERF.md). The splits' int32 partial sums add up exactly."""
    tiles = math.ceil(m / _TC_TILE) * math.ceil(n / _TC_TILE)
    chunks = math.ceil(k / _TC_TILE)
    splits = 1
    while 2 * splits <= 16 and chunks >= 8 * 2 * splits and tiles * 2 * splits <= sms:
        splits *= 2
    return splits


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


@kernel_wrapper(_TC_SRC, "tango_tpu/ops/int8_gemm.py:30")
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
    y = _launch(x.reshape(m, k).contiguous(), w_q.contiguous(),
                w_scale.to(torch.float32).contiguous())
    return y.reshape(*x.shape[:-1], n)


def _launch(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Launch w8a8_matmul on contiguous x (M, K), w_q (N, K) and f32 w_scale
    into a new (M, N) output; the C entry point picks the body by
    `w8a8_tc_body`, and w8a8_matmul.tc_launches counts the tensor-core ones
    it reports."""
    (m, k), n = x.shape, w_q.shape[0]
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    tc = w8a8_tc_body(k)
    xq = scale = part = None
    splits = 1
    if tc:  # the tensor-core body's scratch: xq, the row scales, the splits' partial sums
        check_tc_aligned("w8a8_matmul", x, w_q, y)
        xq = torch.empty((m, k), device=x.device, dtype=torch.int8)
        scale = torch.empty(m, device=x.device, dtype=torch.float32)
        splits = w8a8_splits(m, k, n, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        if splits > 1:
            part = torch.empty((splits, m, n), device=x.device, dtype=torch.int32)
    lib = _build.load()
    code = lib.tt_w8a8_gemm(
        x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), y.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in (xq, scale, part)), splits, m, n, k,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    ran = reported_tc(lib, code, "w8a8_matmul")
    w8a8_matmul.launches += 1
    w8a8_matmul.shapes.add(((m, k), (n, k)))
    count_tc(w8a8_matmul, tc, ran)
    return y


w8a8_matmul.tc_launches = 0
w8a8_matmul.core_source = _SRC  # the __dp4a body, K % 16 != 0
