"""Flash attention: the CUDA kernels, their plain versions and the
autograd join.

The PyTorch counterpart of flexflow_tpu/kernels/attention.py, with its
attention dropout: the counter-based keep-mask (`_mix32`, `_keep_bits`,
`_drop_threshold`, `dropout_seeds`, `attention_dropout_mask`), rebuilt
per tile inside both CUDA kernels (csrc/common.cuh) and whole in the
plain versions.

Operands are folded (batch*heads, seq, head_dim), as the MHA op's fast
path projects them. `_flash_fwd_folded` returns O and the per-row
log-sum-exp `lse` laid out (bh, 1, sq) in f32, the residual the backward
consumes; `_flash_bwd_folded` returns dq, dk, dv from q, k, v, O, lse and
dO. On CUDA tensors each launches its kernel (csrc/flash_fwd.cu,
csrc/flash_bwd.cu: f32, bf16 or fp16; head dims up to 256; the path
`flash_path` picks by shape) and raises on anything that kernel does not
take; on CPU tensors it runs
`flash_fwd_plain` / `flash_bwd_plain`, the same arithmetic in plain
PyTorch. There is no fallback between the two.
`flash_attention_folded` joins them through `FlashAttentionFolded`, the
counterpart of the JAX package's custom VJP `_flash_folded_core`, and
`flash_attention` runs it on (batch, seq, heads, head_dim) operands.

`chunked_attention` (over `_chunk_scan`) is the JAX package's
memory-efficient exact attention in plain PyTorch: an online softmax over
K/V chunks, differentiable through autograd, on any device.
`local_attention` is the single-device streaming dispatch: the flash
kernels on a CUDA tensor (they stream K/V through shared memory, so any
length fits), `chunked_attention` elsewhere.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.seeds import mix64
from . import build

NEG_INF = -1e30

# head-dim limit of csrc/flash_fwd.cu (8 head dims per lane of a warp)
_MAX_HEAD_DIM = 256
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_FWD_SIGNATURE = {
    "ff_flash_fwd": [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_uint32]
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "ff_flash_fwd_wgmma_smem": [ctypes.c_int],
}
_BWD_SIGNATURE = {
    "ff_flash_bwd": [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_uint32]
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "ff_flash_bwd_wgmma_smem": [ctypes.c_int, ctypes.c_int],
}
# the kernels' path codes (csrc/flash_fwd.cu, csrc/flash_bwd.cu `Path`)
FLASH_PATHS = ("rows", "wmma", "wgmma")
_WGMMA_HEAD_DIMS = (64, 128)


def _bhsd_to_fold(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _fold_to_bhsd(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# Chunked (online-softmax) attention
# ---------------------------------------------------------------------------

def _chunk_scan(q, k, v, *, causal: bool, chunk_size: int, q_offset=0,
                kv_offset=0):
    """Online-softmax accumulation over K/V chunks of `chunk_size` keys,
    the JAX package's `_chunk_scan`. q: (b, sq, h, d), k: (b, sk, h, d),
    v: (b, sk, h, dv). Scores and the running (max m, sum l, accumulator)
    are f32; keys past sk (the last chunk's padding) and, when causal,
    keys after their query (positions offset by q_offset / kv_offset) are
    masked with NEG_INF; m starts at NEG_INF and l is clamped at 1e-30.
    Returns (out (b, sq, h, dv) in q's dtype, m, l (b, h, sq) f32)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dv = v.shape[-1]
    n_chunks = max(1, -(-sk // chunk_size))
    pad = n_chunks * chunk_size - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    q32 = q.float()
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        blk = slice(ci * chunk_size, (ci + 1) * chunk_size)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k[:, blk].float()) * scale
        kv_pos = (kv_offset + ci * chunk_size
                  + torch.arange(chunk_size, device=dev))
        mask = (kv_pos <= sk + kv_offset - 1)[None, :]     # padding
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v[:, blk].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype), m, l


def chunked_attention(q, k, v, *, causal: bool = False,
                      chunk_size: int = 256):
    """Memory-efficient exact attention: (b, s, h, d) -> (b, s, h, dv).
    O(s * chunk) scores at a time, differentiable through autograd."""
    out, _, _ = _chunk_scan(q, k, v, causal=causal,
                            chunk_size=min(chunk_size, k.shape[1]))
    return out


def local_attention(q, k, v, *, causal: bool = False):
    """The JAX package's single-device streaming policy on (b, s, h, d)
    operands: the flash kernels on a CUDA tensor (`flash_attention`; they
    stream K/V and take any length), `chunked_attention` elsewhere. The
    MHA op does not come here: it projects into the folded layout and
    calls the kernels itself on the card, and `chunked_attention` off
    it."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal)
    return chunked_attention(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# Counter-based dropout bits
# ---------------------------------------------------------------------------
# The mask is a pure function of (seeds, element index): score element
# (row, q, k) hashes its flat index (row*sq + q)*sk + k, taken mod 2^32,
# under two uint32 seeds, and is kept iff the hash clears the drop
# threshold. The kernels rebuild it per tile from the tile's offsets
# (csrc/common.cuh, native uint32); the plain versions and the dense path
# build it whole here. The seeds are a pair of host ints or a (2,) int32
# tensor holding their bits (an entry of the executor's seed table,
# core/seeds.py): the kernels read the tensor by pointer, and the plain
# versions build the mask from it on its device without a host sync. torch has no uint32 arithmetic, so the hash runs in
# int64 with every value kept in [0, 2^32): products go through `_mul32`,
# and a masked value is non-negative, so `>>` is the logical shift.

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """a * c mod 2^32 for int64 `a` in [0, 2^32) and a constant c < 2^32.
    A c of 2^31 or more is taken as c - 2^32, which is the same mod 2^32:
    either way |c| < 2^31, so the product stays inside int64, and its low
    32 bits (two's complement for a negative product) are the answer."""
    return (a * (c - (1 << 32) if c >= 1 << 31 else c)) & _M32


_MIX_MULS = (0x7FEB352D, 0x846CA68B)   # _mix32's two multipliers
_IDX_MUL = 0x9E3779B1                  # _keep_bits' index multiplier


def _mix32(h):
    """murmur3-style 32-bit finalizer (the JAX package's `_mix32`)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX_MULS[0])
    h = h ^ (h >> 15)
    h = _mul32(h, _MIX_MULS[1])
    return h ^ (h >> 16)


def _keep_bits(idx, s0: int, s1: int):
    """uint32 hash of flat element indices (int64, in [0, 2^32)) under two
    uint32 seeds."""
    h = _mix32(_mul32(idx, _IDX_MUL) ^ s0)
    return _mix32(h ^ s1)


# The same hash on int32 bit patterns, for the standalone Dropout, which
# hashes every element of an activation (ops/dropout.py): int32 products
# wrap mod 2^32, so no masking passes are needed, and every pass moves
# half the bytes of int64. torch's `>>` on int32 is arithmetic, so the
# logical shift masks off the copies of the sign bit.

def _i32(c: int) -> int:
    """The int32 whose bits are those of the uint32 `c`."""
    c &= _M32
    return c - (1 << 32) if c >= 1 << 31 else c


def _lsr32(h, k: int):
    return (h >> k) & ((1 << (32 - k)) - 1)


def _mix32_i32(h):
    """`_mix32` of an int32 tensor, computed in its storage."""
    h ^= _lsr32(h, 16)
    h *= _i32(_MIX_MULS[0])
    h ^= _lsr32(h, 15)
    h *= _i32(_MIX_MULS[1])
    h ^= _lsr32(h, 16)
    return h


def _keep_bits_i32(idx, s0, s1):
    """`_keep_bits` on int32 bit patterns, computed in the storage of the
    int32 `idx` (consumed). The seeds are int32 host ints or 0-d int32
    tensors on idx's device."""
    idx *= _i32(_IDX_MUL)
    idx ^= s0
    _mix32_i32(idx)
    idx ^= s1
    return _mix32_i32(idx)


def _at_least_u32(h, threshold: int):
    """`h >= threshold` with both read as uint32: flipping the sign bit of
    each puts unsigned order onto signed order."""
    return (h ^ _i32(1 << 31)) >= _i32(threshold ^ (1 << 31))


def _drop_threshold(rate: float) -> int:
    """Keep an element iff hash >= threshold: P(drop) == rate."""
    return min(0xFFFFFFFF, int(round(float(rate) * 4294967296.0)))


def dropout_seeds(rng: int):
    """Two uint32 seeds for the counter-based mask from an op's seed
    material (an int, core/seeds.py): deterministic per seed. The
    executor's seed table holds these (core/seeds.py `seed_table`)."""
    h = mix64(int(rng))
    return h & _M32, h >> 32


def attention_dropout_mask(seeds, rate: float, bh: int, sq: int, sk: int, *,
                           device=None, _row0: int = 0):
    """The FULL (bh, sq, sk) bool keep-mask the flash kernels apply
    blockwise, on `device` (the CPU by default). Rows follow the folded
    (batch*heads, b-major) layout; `_row0` offsets them, so rows
    [r0, r0 + bh) of a larger launch can be rebuilt alone."""
    if rate <= 0.0:
        return torch.ones((bh, sq, sk), dtype=torch.bool, device=device)
    s0, s1 = _mask_seeds(seeds, device)
    row = torch.arange(_row0, _row0 + bh, device=device)
    qp = torch.arange(sq, device=device)
    kp = torch.arange(sk, device=device)
    base = (_mul32(row, sq)[:, None] + qp[None, :]) & _M32     # (bh, sq)
    idx = (_mul32(base, sk)[:, :, None] + kp) & _M32           # (bh, sq, sk)
    return _keep_bits(idx, s0, s1) >= _drop_threshold(rate)


def _mask_seeds(seeds, device):
    """(s0, s1) for the int64 hash: host ints from a pair, 0-d int64
    tensors on `device` from a table entry (no host sync)."""
    if isinstance(seeds, torch.Tensor):
        s = seeds.to(device=device, dtype=torch.int64) & _M32
        return s[0], s[1]
    return int(seeds[0]) & _M32, int(seeds[1]) & _M32


def seed_buffer(seeds, device) -> torch.Tensor:
    """The two seeds as the contiguous (2,) int32 tensor on `device` that
    the kernels read: a table entry as it is, a pair of host ints copied
    over (outside a captured graph only: the copy cannot be captured)."""
    if isinstance(seeds, torch.Tensor):
        if (seeds.dtype != torch.int32 or seeds.shape != (2,)
                or seeds.device != device or not seeds.is_contiguous()):
            raise ValueError(f"dropout seeds must be a contiguous (2,) int32 "
                             f"tensor on {device} (got {seeds.dtype} "
                             f"{tuple(seeds.shape)} on {seeds.device})")
        return seeds
    from ..core.seeds import as_int32

    return torch.tensor([as_int32(int(x)) for x in seeds[:2]],
                        dtype=torch.int32, device=device)


def _dropout_args(dropout: float, seeds, device):
    """(seed buffer, threshold, inv_keep) as the kernels take them, the
    buffer None and threshold 0 (the dropout-free variant) without
    dropout. The caller keeps the buffer alive until the launch."""
    if dropout <= 0.0:
        return None, 0, 1.0
    return (seed_buffer(seeds, device), _drop_threshold(dropout),
            1.0 / (1.0 - dropout))


def flash_supported(seq_q: int, seq_k: int, head_dim: int = 64,
                    v_head_dim: int = 64) -> bool:
    """Whether the flash kernel takes these shapes. It streams K/V through
    shared memory with an online softmax, so no sequence length is too long
    (the TPU kernel's whole-row VMEM cap does not apply); the head dims must
    be at most 256."""
    return (seq_q >= 1 and seq_k >= 1
            and all(1 <= d <= _MAX_HEAD_DIM for d in (head_dim, v_head_dim)))


def flash_path(dtype, d: int, dv: int) -> str:
    """Which kernel of csrc/flash_{fwd,bwd}.cu takes this shape: "wgmma"
    (Hopper's warpgroup products and TMA) for bf16/fp16 with d == dv in
    (64, 128), "wmma" for other 16-bit head dims that are multiples of 16,
    "rows" (the CUDA cores) for f32 and any other head dim. The forward and
    the backward take the same path for the same operands."""
    if dtype in (torch.bfloat16, torch.float16):
        if d == dv and d in _WGMMA_HEAD_DIMS:
            return "wgmma"
        if d % 16 == 0 and dv % 16 == 0:
            return "wmma"
    return "rows"


def _path_code(what: str, dtype, d: int, dv: int, path) -> int:
    """The path code for a launch: `flash_path`'s choice, or the one asked
    for (chip_smoke.py times the earlier kernels at the main shapes), which
    must take this shape: the kernel refuses what it does not take."""
    path = flash_path(dtype, d, dv) if path is None else path
    if path not in FLASH_PATHS:
        raise ValueError(f"{what}: unknown path {path!r}")
    return FLASH_PATHS.index(path)


def _scores(qf, kf, causal: bool):
    """S = Q K^T / sqrt(d) in f32, causal mask with NEG_INF (key <= query,
    top-left aligned)."""
    s = torch.matmul(qf.float(), kf.float().transpose(1, 2)) \
        * (1.0 / math.sqrt(qf.shape[-1]))
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_fwd_plain(qf, kf, vf, *, causal: bool, dropout: float = 0.0,
                    seeds=None, _row0: int = 0):
    """The JAX kernel's arithmetic, whole rows at once: S, row softmax with
    l clamped at 1e-30, P rounded to the input dtype before P V. Dropout
    (rate `dropout` > 0, mask `attention_dropout_mask(seeds, ...)` from row
    `_row0` on) scales the kept P by 1/(1 - rate) and zeroes the rest
    after l is taken and before P is rounded; l and lse stay undropped.
    Returns (O in the input dtype, lse (bh, 1, sq) f32)."""
    s = _scores(qf, kf, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout > 0.0:
        keep = attention_dropout_mask(seeds, dropout, *s.shape,
                                      device=s.device, _row0=_row0)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout)), 0.0)
    o = torch.matmul(p.to(qf.dtype).float(), vf.float()) / l
    lse = (m + torch.log(l)).transpose(1, 2)
    return o.to(qf.dtype), lse.contiguous()


def _flash_fwd_cuda(qf, kf, vf, *, causal: bool, dropout: float = 0.0,
                    seeds=None, _path=None):
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
    code = _path_code(what, qf.dtype, d, dv, _path)
    o = torch.empty((bh, sq, dv), dtype=qf.dtype, device=qf.device)
    lse = torch.empty((bh, 1, sq), dtype=torch.float32, device=qf.device)
    sbuf, threshold, inv_keep = _dropout_args(dropout, seeds, qf.device)
    lib = build.load(what, _FWD_SIGNATURE)
    rc = lib.ff_flash_fwd(
        qf.device.index or 0, build.DTYPE_CODES[str(qf.dtype)[6:]],
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, sq, sk, d, dv, int(causal),
        1.0 / math.sqrt(d), None if sbuf is None else sbuf.data_ptr(),
        threshold, inv_keep, code, build.stream_ptr(qf))
    build.check_launch(rc, f"{what}_dropout" if threshold else what,
                       f"{what}_{FLASH_PATHS[code]}")
    return o, lse


def wgmma_smem_bytes() -> dict:
    """The dynamic shared memory of each wgmma kernel launch (bytes), by
    kernel and head dim, as the C sources lay it out (for the build
    report; builds the libraries if needed)."""
    fwd = build.load("flash_fwd", _FWD_SIGNATURE)
    bwd = build.load("flash_bwd", _BWD_SIGNATURE)
    return {f"{name}_d{d}": fn(d) for d in _WGMMA_HEAD_DIMS
            for name, fn in (
                ("flash_fwd_wgmma_kernel", fwd.ff_flash_fwd_wgmma_smem),
                ("flash_bwd_dkdv_wgmma_kernel",
                 lambda d: bwd.ff_flash_bwd_wgmma_smem(1, d)),
                ("flash_bwd_dq_wgmma_kernel",
                 lambda d: bwd.ff_flash_bwd_wgmma_smem(2, d)))}


def _flash_fwd_folded(qf, kf, vf, *, causal: bool, dropout: float = 0.0,
                      seeds=None):
    """Core forward on (b*h, s, d) folded operands -> (O, lse)."""
    if qf.device.type == "cpu":
        return flash_fwd_plain(qf, kf, vf, causal=causal, dropout=dropout,
                               seeds=seeds)
    return _flash_fwd_cuda(qf, kf, vf, causal=causal, dropout=dropout,
                           seeds=seeds)


def flash_bwd_plain(qf, kf, vf, of, lse, dof, *, causal: bool,
                    dropout: float = 0.0, seeds=None, _row0: int = 0):
    """The JAX backward kernel's arithmetic, whole rows at once: delta =
    rowsum(dO * O), S and dP = dO V^T in f32 (a masked P is exactly 0),
    P = exp(S - lse). Dropout zeroes dP and P where the forward's mask
    dropped and scales the rest by 1/(1 - rate); dS = P * (dP - delta)
    takes the undropped P. dS and the (dropped) P are rounded to the input
    dtype before dq = dS K * scale, dk = dS^T Q * scale and dv = P^T dO,
    which accumulate in f32 and are returned in the input dtype."""
    dt = qf.dtype
    scale = 1.0 / math.sqrt(qf.shape[-1])
    k32, v32, do32 = (x.float() for x in (kf, vf, dof))
    delta = (do32 * of.float()).sum(-1, keepdim=True)
    p = torch.exp(_scores(qf, kf, causal) - lse.transpose(1, 2))
    dp = torch.matmul(do32, v32.transpose(1, 2))
    pb = p
    if dropout > 0.0:
        keep = attention_dropout_mask(seeds, dropout, *p.shape,
                                      device=p.device, _row0=_row0)
        inv_keep = 1.0 / (1.0 - dropout)
        dp = torch.where(keep, dp * inv_keep, 0.0)
        pb = torch.where(keep, p * inv_keep, 0.0)
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(1, 2), qf.float()) * scale
    dv = torch.matmul(pb.to(dt).float().transpose(1, 2), do32)
    return dq.to(dt), dk.to(dt), dv.to(dt)


_MANTISSA_BITS = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}
# The (atol, rtol) of a 16-bit backward kernel against `flash_bwd_plain`,
# to which a check adds `flash_bwd_slack`: the output may round one step
# of its dtype apart (rtol), and atol covers one step at the bf16 / fp16
# gradients of order 1 these checks see. The slack carries what depends
# on the data: where the kernel's f32 S and dP (summed in another order)
# round dS or P to the other side of a boundary.
FLASH_BWD_TOL = {torch.bfloat16: (3e-3, 2.0 ** -7),
                 torch.float16: (5e-4, 2.0 ** -10)}
# The norm of a 16-bit kernel's error over the norm of the output it is
# held to (O, dq, dk or dv, each whole), which unlike the per-element
# limits above does not depend on the outputs' scale. Each output comes
# from one product whose 16-bit operand (P, or dS) was rounded once, and
# is rounded once itself: on random operands each rounding, spread evenly
# over +-u (the unit roundoff, half a step), adds u / sqrt(3) of the
# output's norm, and two add 0.82 u. The limit is 2u, one step of the
# dtype at 1.
FLASH_NORM_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def rel_norm_err(got, ref) -> float:
    """||got - ref|| / ||ref|| over every element, in f32."""
    ref = ref.float()
    return (torch.linalg.vector_norm(got.float() - ref)
            / torch.linalg.vector_norm(ref)).item()


def _ulp(x, dtype):
    """The step of `dtype` at |x| (f32 tensor), 0 where x is 0; fp16's
    steps stop shrinking at its smallest subnormal."""
    _, e = torch.frexp(x.abs())
    step = torch.ldexp(torch.ones_like(x), e - 1 - _MANTISSA_BITS[dtype])
    if dtype == torch.float16:
        step = step.clamp_min(2.0 ** -24)
    return torch.where(x != 0, step, torch.zeros_like(x))


def flash_bwd_slack(qf, kf, vf, of, lse, dof, *, causal: bool,
                    dropout: float = 0.0, seeds=None, _row0: int = 0):
    """Per-element slack (dq, dk, dv) of a 16-bit backward kernel against
    `flash_bwd_plain`, from the plain version's own intermediates.

    Both round dS and the P of dV to the input dtype before their
    products. A kernel sums S and dP in another order, so its f32 values
    differ in the last bits, and where one lies at a rounding boundary it
    rounds one step the other way. Two such flips per row of the product
    are allowed, each at the largest step in that row: dq[i, c] may move
    by 2 ulp(max_j |dS_ij|) max_j |k_jc| / sqrt(d), dk[j, c] by
    2 ulp(max_i |dS_ij|) max_i |q_ic| / sqrt(d), dv[j, c] by
    2 ulp(max_i |P_ij|) max_i |dO_ic| (P dropped and scaled, as dV takes
    it). A check adds this to its (atol, rtol) limit."""
    dt = qf.dtype
    scale = 1.0 / math.sqrt(qf.shape[-1])
    k32, v32, do32 = (x.float() for x in (kf, vf, dof))
    delta = (do32 * of.float()).sum(-1, keepdim=True)
    p = torch.exp(_scores(qf, kf, causal) - lse.transpose(1, 2))
    dp = torch.matmul(do32, v32.transpose(1, 2))
    pb = p
    if dropout > 0.0:
        keep = attention_dropout_mask(seeds, dropout, *p.shape,
                                      device=p.device, _row0=_row0)
        inv_keep = 1.0 / (1.0 - dropout)
        dp = torch.where(keep, dp * inv_keep, 0.0)
        pb = torch.where(keep, p * inv_keep, 0.0)
    ds = (p * (dp - delta)).abs()
    del p, dp
    step_row = _ulp(ds.amax(-1, keepdim=True), dt)        # (bh, sq, 1)
    step_col = _ulp(ds.amax(-2), dt).unsqueeze(-1)        # (bh, sk, 1)
    step_pv = _ulp(pb.abs().amax(-2), dt).unsqueeze(-1)   # (bh, sk, 1)
    k_max, q_max, do_max = (x.float().abs().amax(1, keepdim=True)
                            for x in (kf, qf, dof))       # (bh, 1, c)
    return (2.0 * step_row * k_max * scale, 2.0 * step_col * q_max * scale,
            2.0 * step_pv * do_max)


def _flash_bwd_cuda(qf, kf, vf, of, lse, dof, *, causal: bool,
                    dropout: float = 0.0, seeds=None, _path=None):
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
    code = _path_code(what, qf.dtype, d, dv, _path)
    dq, dk, dvo = (torch.empty_like(x) for x in (qf, kf, vf))
    delta = torch.empty((bh, sq), dtype=torch.float32, device=qf.device)
    sbuf, threshold, inv_keep = _dropout_args(dropout, seeds, qf.device)
    lib = build.load(what, _BWD_SIGNATURE)
    rc = lib.ff_flash_bwd(
        qf.device.index or 0, build.DTYPE_CODES[str(qf.dtype)[6:]],
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), of.data_ptr(),
        dof.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dvo.data_ptr(), bh, sq, sk, d, dv, int(causal),
        1.0 / math.sqrt(d), None if sbuf is None else sbuf.data_ptr(),
        threshold, inv_keep, code, build.stream_ptr(qf))
    build.check_launch(rc, f"{what}_dropout" if threshold else what,
                       f"{what}_{FLASH_PATHS[code]}")
    return dq, dk, dvo


def _flash_bwd_folded(qf, kf, vf, of, lse, dof, *, causal: bool,
                      dropout: float = 0.0, seeds=None):
    """Core backward on (b*h, s, d) folded operands -> (dq, dk, dv)."""
    if qf.device.type == "cpu":
        return flash_bwd_plain(qf, kf, vf, of, lse, dof, causal=causal,
                               dropout=dropout, seeds=seeds)
    return _flash_bwd_cuda(qf, kf, vf, of, lse, dof, causal=causal,
                           dropout=dropout, seeds=seeds)


class FlashAttentionFolded(torch.autograd.Function):
    """The counterpart of the JAX package's `_flash_folded_core` custom
    VJP: the forward kernel saves q, k, v, O and lse, and keeps the
    dropout rate and seeds, so the backward kernel rebuilds the same mask
    as it consumes them with dO."""

    @staticmethod
    def forward(ctx, qf, kf, vf, causal, dropout, seeds):
        o, lse = _flash_fwd_folded(qf, kf, vf, causal=causal,
                                   dropout=dropout, seeds=seeds)
        ctx.causal, ctx.dropout, ctx.seeds = causal, dropout, seeds
        ctx.save_for_backward(qf, kf, vf, o, lse)
        return o

    @staticmethod
    def backward(ctx, dof):
        qf, kf, vf, o, lse = ctx.saved_tensors
        # the output projection's backward need not hand dO over contiguous
        dq, dk, dv = _flash_bwd_folded(qf, kf, vf, o, lse, dof.contiguous(),
                                       causal=ctx.causal, dropout=ctx.dropout,
                                       seeds=ctx.seeds)
        return dq, dk, dv, None, None, None


def flash_attention_folded(qf, kf, vf, causal: bool = False, *,
                           dropout: float = 0.0, seeds=None):
    """Exact attention on PRE-FOLDED (batch*heads, seq, head_dim) operands;
    returns O. `dropout` > 0 applies the counter-based keep-mask of
    `seeds` (two uint32s, `dropout_seeds(rng)`, or a seed-table entry
    holding them on the operands' device) inside the kernels. Where a
    gradient is wanted it goes through `FlashAttentionFolded`; under
    no_grad (serving) the forward runs alone and nothing is saved."""
    dropout = float(dropout)
    if dropout > 0.0 and seeds is None:
        raise ValueError("flash dropout needs seeds (dropout_seeds(rng))")
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (qf, kf, vf)):
        return FlashAttentionFolded.apply(qf, kf, vf, causal, dropout, seeds)
    return _flash_fwd_folded(qf, kf, vf, causal=causal, dropout=dropout,
                             seeds=seeds)[0]


def flash_attention(q, k, v, causal: bool = False, *, dropout: float = 0.0,
                    seeds=None):
    """`flash_attention_folded` on (batch, seq, heads, head_dim) operands:
    folded to (batch*heads, seq, head_dim), run through the kernels (the
    plain versions on CPU tensors) and unfolded; returns (b, sq, h, dv)."""
    b, _, h, _ = q.shape
    out = flash_attention_folded(
        *(_bhsd_to_fold(x).contiguous() for x in (q, k, v)), causal,
        dropout=dropout, seeds=seeds)
    return _fold_to_bhsd(out, b, h)
