"""Bias-free attention kernels and their plain versions.

`attn_fwd` (csrc/attention.cu) is the forward; `attn_bwd_dq` and
`attn_bwd_dkv` (csrc/attention_bwd.cu) are the backward, replacing
`_bwd_dq_kernel` and `_bwd_dkv_kernel` (tango_tpu/ops/flash_attention.py:231,
259): the gradient of the exact max-subtracted softmax, recomputed from q, k
and v, with JAX's roundings (ds to the storage type before both products
that take it, p to dO's type before dV = p^T dO). dq also writes the per-row
lse and delta that dkv reads, as (BH, Sq) f32. Bound on the H100:
operations (see the CUDA files' notes).

The forward replaces `_attn_kernel` (tango_tpu/ops/flash_attention.py:56), the
static-shift exp2 softmax with deferred division: q is prescaled by scale*log2(e) and
rounded to the storage type, p = exp2(min(l - 20, 96)), the PV product takes
p rounded to the storage type, and a row whose denominator underflows to 0 is
a zero row, never NaN. The exactness window and its edges are documented in
the JAX file.

Layout: q and do (BH, Sq, D), k and v (BH, Skv, D), contiguous, f32 or bf16;
D in {16, 32, 64, 128}. Each wrapper launches its kernel for CUDA tensors and
runs its plain version for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from tango_tpu_torch.ops import _build, kernel_wrapper

LOG2_E = 1.4426950408889634
SOFTMAX_SHIFT = 20.0
SOFTMAX_CLAMP = 96.0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Plain version of attn_fwd: the same static-shift softmax, in f32."""
    qs = (q.float() * torch.tensor(scale * LOG2_E, dtype=torch.float32)).to(q.dtype)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp2(torch.clamp(logits - SOFTMAX_SHIFT, max=SOFTMAX_CLAMP))
    denom = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / torch.where(denom == 0.0, torch.ones_like(denom), denom)).to(q.dtype)


@kernel_wrapper("tango_tpu_torch/csrc/attention.cu", "tango_tpu/ops/flash_attention.py:56")
def attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """softmax(q k^T * scale) v over (BH, S, D) heads, static-shift form."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("attn_fwd: q, k, v must be (BH, S, D)")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if k.shape != (bh, skv, d) or v.shape != (bh, skv, d):
        raise ValueError(f"attn_fwd: shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"attn_fwd: dtypes {q.dtype} {k.dtype} {v.dtype} (float32 or bfloat16)")
    if not (q.device == k.device == v.device):
        raise ValueError("attn_fwd: q, k, v on different devices")
    if q.device.type == "cpu":
        return attn_fwd_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"attn_fwd: no kernel for device {q.device}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"attn_fwd: head dim {d} not in {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attn_fwd: q, k, v must be contiguous")
    if bh > 65535 or max(sq, skv) * d * bh >= 2**31:
        raise ValueError(f"attn_fwd: BH={bh}, S={max(sq, skv)} exceed the kernel's indexing")
    lib = _build.load()
    o = torch.empty_like(q)
    qscale = float(torch.tensor(scale * LOG2_E, dtype=torch.float32))
    code = lib.tt_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq, skv, d, qscale,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "attn_fwd")
    attn_fwd.launches += 1
    attn_fwd.shapes.add((tuple(q.shape), tuple(k.shape)))
    return o




def _check_bwd(name, q, k, v, do):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name}: q, k, v must be (BH, S, D)")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if k.shape != (bh, skv, d) or v.shape != (bh, skv, d) or do.shape != q.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} {tuple(do.shape)}")
    if not (q.dtype == k.dtype == v.dtype == do.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtypes {q.dtype} {k.dtype} {v.dtype} {do.dtype} "
                        "(float32 or bfloat16)")
    if not (q.device == k.device == v.device == do.device):
        raise ValueError(f"{name}: inputs on different devices")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k, v, do)):
        raise ValueError(f"{name}: q, k, v, do must be contiguous")
    if bh > 65535 or max(sq, skv) * d * bh >= 2**31:
        raise ValueError(f"{name}: BH={bh}, S={max(sq, skv)} exceed the kernel's indexing")
    return True


def attn_bwd_dq_plain(q, k, v, do, scale: float):
    """Plain version of attn_bwd_dq: (dq, lse, delta), the arithmetic of
    _bwd_dq_kernel in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    p = p / denom
    lse = m + torch.log(denom)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype)
    dq = torch.matmul(ds.float(), k.float())
    return dq.to(q.dtype), lse[..., 0], delta[..., 0]


@kernel_wrapper("tango_tpu_torch/csrc/attention_bwd.cu", "tango_tpu/ops/flash_attention.py:231",
                backward=True)
def attn_bwd_dq(q, k, v, do, scale: float):
    """dq of softmax(q k^T * scale) v for the output gradient do, all
    (BH, S, D); also the per-row lse and delta, (BH, Sq) f32."""
    if not _check_bwd("attn_bwd_dq", q, k, v, do):
        return attn_bwd_dq_plain(q, k, v, do, scale)
    bh, sq, d = q.shape
    lib = _build.load()
    dq = torch.empty_like(q)
    lse = torch.empty((bh, sq), device=q.device, dtype=torch.float32)
    delta = torch.empty_like(lse)
    code = lib.tt_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), bh, sq, k.shape[1], d, float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "attn_bwd_dq")
    attn_bwd_dq.launches += 1
    attn_bwd_dq.shapes.add((tuple(q.shape), tuple(k.shape)))
    return dq, lse, delta


def attn_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float):
    """Plain version of attn_bwd_dkv: (dk, dv), the arithmetic of
    _bwd_dkv_kernel in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale      # (BH, Sq, Skv)
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


@kernel_wrapper("tango_tpu_torch/csrc/attention_bwd.cu", "tango_tpu/ops/flash_attention.py:259",
                backward=True)
def attn_bwd_dkv(q, k, v, do, lse, delta, scale: float):
    """dk, dv of softmax(q k^T * scale) v from the lse and delta of attn_bwd_dq."""
    use_kernel = _check_bwd("attn_bwd_dkv", q, k, v, do)
    bh, sq, _ = q.shape
    for t in (lse, delta):
        if t.shape != (bh, sq) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError("attn_bwd_dkv: lse and delta must be (BH, Sq) float32 on q's device")
    if not use_kernel:
        return attn_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("attn_bwd_dkv: lse and delta must be contiguous")
    lib = _build.load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    code = lib.tt_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, k.shape[1], q.shape[2],
        float(scale), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "attn_bwd_dkv")
    attn_bwd_dkv.launches += 1
    attn_bwd_dkv.shapes.add((tuple(q.shape), tuple(k.shape)))
    return dk, dv


def flash_bwd_supported(sq: int, skv: int, d: int) -> bool:
    """flash_bwd_supported of the JAX package (flash_attention.py:286-293),
    kept as the dispatch rule so that both packages take the kernels for the
    same shapes: both sequence axes tile by 128, D % 8 == 0, S*D*2 <= 2 MB."""
    return (sq % 128 == 0 and skv % 128 == 0 and d % 8 == 0
            and skv * d * 2 <= 2 * 1024 * 1024 and sq * d * 2 <= 2 * 1024 * 1024)


def flash_attention_bwd(q, k, v, do, scale: float):
    """(dq, dk, dv) over (BH, S, D) heads: attn_bwd_dq, then attn_bwd_dkv on the
    same stream, reading the lse and delta that dq wrote."""
    dq, lse, delta = attn_bwd_dq(q, k, v, do, scale)
    dk, dv = attn_bwd_dkv(q, k, v, do, lse, delta, scale)
    return dq, dk, dv
