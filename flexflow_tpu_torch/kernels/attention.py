"""Flash-attention forward: the CUDA kernel and its plain version.

The PyTorch counterpart of flexflow_tpu/kernels/attention.py, forward only
and without dropout (the backward `_flash_bwd_kernel` and the dropout
hash `_mix32`/`_keep_bits`/`_keep_tile` come with the training slice).

Operands are folded (batch*heads, seq, head_dim), as the MHA op's fast
path projects them. `_flash_fwd_folded` returns O and the per-row
log-sum-exp `lse` laid out (bh, 1, sq) in f32, the residual a backward
consumes. On CUDA tensors it launches csrc/flash_fwd.cu (f32, bf16 or
fp16; head dims up to 256) and raises on anything that kernel does not
take; on CPU tensors it runs
`flash_fwd_plain`, the same arithmetic in plain PyTorch. There is no
fallback between the two.
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

_SIGNATURE = {
    "ff_flash_fwd": [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
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
    lib = build.load(what, _SIGNATURE)
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


def flash_attention_folded(qf, kf, vf, causal: bool = False):
    """Exact attention on PRE-FOLDED (batch*heads, seq, head_dim) operands;
    returns O (the lse of `_flash_fwd_folded` is what training keeps)."""
    return _flash_fwd_folded(qf, kf, vf, causal=causal)[0]
