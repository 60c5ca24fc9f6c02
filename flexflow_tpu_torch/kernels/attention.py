"""Flash attention: the CUDA kernels, their plain versions and the
autograd join.

The PyTorch counterpart of flexflow_tpu/kernels/attention.py without
dropout (the dropout hash `_mix32`/`_keep_bits`/`_keep_tile` is not
ported yet).

Operands are folded (batch*heads, seq, head_dim), as the MHA op's fast
path projects them. `_flash_fwd_folded` returns O and the per-row
log-sum-exp `lse` laid out (bh, 1, sq) in f32, the residual the backward
consumes; `_flash_bwd_folded` returns dq, dk, dv from q, k, v, O, lse and
dO. On CUDA tensors each launches its kernel (csrc/flash_fwd.cu,
csrc/flash_bwd.cu: f32, bf16 or fp16; head dims up to 256) and raises on
anything that kernel does not take; on CPU tensors it runs
`flash_fwd_plain` / `flash_bwd_plain`, the same arithmetic in plain
PyTorch. There is no fallback between the two.
`flash_attention_folded` joins them through `FlashAttentionFolded`, the
counterpart of the JAX package's custom VJP `_flash_folded_core`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30

# head-dim limit of csrc/flash_fwd.cu (8 head dims per lane of a warp)
_MAX_HEAD_DIM = 256
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_FWD_SIGNATURE = {
    "ff_flash_fwd": [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
}
_BWD_SIGNATURE = {
    "ff_flash_bwd": [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
}


def _bhsd_to_fold(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _fold_to_bhsd(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


def flash_supported(seq_q: int, seq_k: int, head_dim: int = 64,
                    v_head_dim: int = 64) -> bool:
    """Whether the flash kernel takes these shapes. It streams K/V through
    shared memory with an online softmax, so no sequence length is too long
    (the TPU kernel's whole-row VMEM cap does not apply); the head dims must
    be at most 256."""
    return (seq_q >= 1 and seq_k >= 1
            and all(1 <= d <= _MAX_HEAD_DIM for d in (head_dim, v_head_dim)))


def flash_fwd_plain(qf, kf, vf, *, causal: bool):
    """The JAX kernel's arithmetic, whole rows at once: S = Q K^T / sqrt(d)
    in f32, causal mask with NEG_INF (key <= query, top-left aligned), row
    softmax with l clamped at 1e-30, P rounded to the input dtype before
    P V. Returns (O in the input dtype, lse (bh, 1, sq) f32)."""
    d = qf.shape[-1]
    s = torch.matmul(qf.float(), kf.float().transpose(1, 2)) \
        * (1.0 / math.sqrt(d))
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(qf.dtype).float(), vf.float()) / l
    lse = (m + torch.log(l)).transpose(1, 2)
    return o.to(qf.dtype), lse.contiguous()


def _flash_fwd_cuda(qf, kf, vf, *, causal: bool):
    what = "flash_fwd"
    build.require_cuda_operands(what, (qf, kf, vf), _KERNEL_DTYPES)
    if not (qf.dtype == kf.dtype == vf.dtype):
        raise TypeError(f"{what}: q/k/v dtypes differ "
                        f"({qf.dtype}, {kf.dtype}, {vf.dtype})")
    if qf.dim() != 3 or kf.dim() != 3 or vf.dim() != 3:
        raise ValueError(f"{what}: operands must be folded (bh, seq, dim)")
    if not (qf.is_contiguous() and kf.is_contiguous() and vf.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")
    bh, sq, d = qf.shape
    _, sk, dv = vf.shape
    if kf.shape != (bh, sk, d) or vf.shape[0] != bh:
        raise ValueError(f"{what}: shapes q {tuple(qf.shape)} k "
                         f"{tuple(kf.shape)} v {tuple(vf.shape)} disagree")
    if not flash_supported(sq, sk, d, dv) or bh > 65535:
        raise ValueError(f"{what}: unsupported shape bh={bh} sq={sq} sk={sk} "
                         f"d={d} dv={dv} (head dims <= {_MAX_HEAD_DIM}; "
                         f"bh <= 65535)")
    o = torch.empty((bh, sq, dv), dtype=qf.dtype, device=qf.device)
    lse = torch.empty((bh, 1, sq), dtype=torch.float32, device=qf.device)
    lib = build.load(what, _FWD_SIGNATURE)
    rc = lib.ff_flash_fwd(
        qf.device.index or 0, build.DTYPE_CODES[str(qf.dtype)[6:]],
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, sq, sk, d, dv, int(causal),
        1.0 / math.sqrt(d), build.stream_ptr(qf))
    build.check_launch(rc, what)
    return o, lse


def _flash_fwd_folded(qf, kf, vf, *, causal: bool):
    """Core forward on (b*h, s, d) folded operands -> (O, lse)."""
    if qf.device.type == "cpu":
        return flash_fwd_plain(qf, kf, vf, causal=causal)
    return _flash_fwd_cuda(qf, kf, vf, causal=causal)


def flash_bwd_plain(qf, kf, vf, of, lse, dof, *, causal: bool):
    """The JAX backward kernel's arithmetic, whole rows at once: delta =
    rowsum(dO * O), S = Q K^T / sqrt(d) and dP = dO V^T in f32 (causal mask
    with NEG_INF, so a masked P is exactly 0), P = exp(S - lse), dS = P *
    (dP - delta); dS and P are rounded to the input dtype before dq = dS K
    * scale, dk = dS^T Q * scale and dv = P^T dO, which accumulate in f32
    and are returned in the input dtype."""
    dt = qf.dtype
    scale = 1.0 / math.sqrt(qf.shape[-1])
    q32, k32, v32, do32 = (x.float() for x in (qf, kf, vf, dof))
    delta = (do32 * of.float()).sum(-1, keepdim=True)
    s = torch.matmul(q32, k32.transpose(1, 2)) * scale
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse.transpose(1, 2))
    dp = torch.matmul(do32, v32.transpose(1, 2))
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(1, 2), q32) * scale
    dv = torch.matmul(p.to(dt).float().transpose(1, 2), do32)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _flash_bwd_cuda(qf, kf, vf, of, lse, dof, *, causal: bool):
    what = "flash_bwd"
    ops = (qf, kf, vf, of, dof)
    build.require_cuda_operands(what, ops + (lse,), _KERNEL_DTYPES)
    if len({x.dtype for x in ops}) != 1 or lse.dtype != torch.float32:
        raise TypeError(f"{what}: q/k/v/o/dO must share one dtype and lse "
                        f"be float32 (got {[x.dtype for x in ops]}, "
                        f"{lse.dtype})")
    if any(x.dim() != 3 for x in ops + (lse,)):
        raise ValueError(f"{what}: operands must be folded (bh, seq, dim)")
    if not all(x.is_contiguous() for x in ops + (lse,)):
        raise ValueError(f"{what}: operands must be contiguous")
    bh, sq, d = qf.shape
    _, sk, dv = vf.shape
    if (kf.shape != (bh, sk, d) or vf.shape[0] != bh
            or of.shape != (bh, sq, dv) or dof.shape != (bh, sq, dv)
            or lse.shape != (bh, 1, sq)):
        raise ValueError(f"{what}: shapes q {tuple(qf.shape)} k "
                         f"{tuple(kf.shape)} v {tuple(vf.shape)} o "
                         f"{tuple(of.shape)} dO {tuple(dof.shape)} lse "
                         f"{tuple(lse.shape)} disagree")
    if not flash_supported(sq, sk, d, dv) or bh > 65535:
        raise ValueError(f"{what}: unsupported shape bh={bh} sq={sq} sk={sk} "
                         f"d={d} dv={dv} (head dims <= {_MAX_HEAD_DIM}; "
                         f"bh <= 65535)")
    dq, dk, dvo = (torch.empty_like(x) for x in (qf, kf, vf))
    delta = torch.empty((bh, sq), dtype=torch.float32, device=qf.device)
    lib = build.load(what, _BWD_SIGNATURE)
    rc = lib.ff_flash_bwd(
        qf.device.index or 0, build.DTYPE_CODES[str(qf.dtype)[6:]],
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), of.data_ptr(),
        dof.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dvo.data_ptr(), bh, sq, sk, d, dv, int(causal),
        1.0 / math.sqrt(d), build.stream_ptr(qf))
    build.check_launch(rc, what)
    return dq, dk, dvo


def _flash_bwd_folded(qf, kf, vf, of, lse, dof, *, causal: bool):
    """Core backward on (b*h, s, d) folded operands -> (dq, dk, dv)."""
    if qf.device.type == "cpu":
        return flash_bwd_plain(qf, kf, vf, of, lse, dof, causal=causal)
    return _flash_bwd_cuda(qf, kf, vf, of, lse, dof, causal=causal)


class FlashAttentionFolded(torch.autograd.Function):
    """The counterpart of the JAX package's `_flash_folded_core` custom
    VJP: the forward kernel saves q, k, v, O and lse; the backward kernel
    consumes them with dO."""

    @staticmethod
    def forward(ctx, qf, kf, vf, causal):
        o, lse = _flash_fwd_folded(qf, kf, vf, causal=causal)
        ctx.causal = causal
        ctx.save_for_backward(qf, kf, vf, o, lse)
        return o

    @staticmethod
    def backward(ctx, dof):
        qf, kf, vf, o, lse = ctx.saved_tensors
        # the output projection's backward need not hand dO over contiguous
        dq, dk, dv = _flash_bwd_folded(qf, kf, vf, o, lse, dof.contiguous(),
                                       causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_folded(qf, kf, vf, causal: bool = False):
    """Exact attention on PRE-FOLDED (batch*heads, seq, head_dim) operands;
    returns O. Where a gradient is wanted it goes through
    `FlashAttentionFolded`; under no_grad (serving) the forward runs alone
    and nothing is saved."""
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (qf, kf, vf)):
        return FlashAttentionFolded.apply(qf, kf, vf, causal)
    return _flash_fwd_folded(qf, kf, vf, causal=causal)[0]
