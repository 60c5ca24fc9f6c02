"""Paged flash-decode attention: the CUDA kernel and its plain version.

The PyTorch counterpart of flexflow_tpu/kernels/decode.py. One query token
per slot attends over a PAGED K/V pool: K/V live in fixed-size physical
pages, each slot's logical sequence is a row of page ids, and the kernel
walks only a slot's live pages with an online softmax.

Layouts (as in the JAX package):
  q          (slots, heads, head_dim)           one token per slot
  k/v pages  (heads, num_pages, page_size, d)   head-major pool; any
             strides as long as the last axis is contiguous
  page_table (slots, pages_per_slot) int32      physical page ids; entries
             past a slot's live pages are never read
  lengths    (slots,) int32                     tokens live per slot

`paged_view_of_cache` views the batcher's dense per-slot caches (slots,
max_len, heads, d) as such a pool without copying: the kernel takes the
pool's strides, so the permuted view is passed as it is.

On CUDA tensors `paged_flash_decode` launches csrc/paged_decode.cu and
raises on anything that kernel does not take; on CPU tensors it runs
`paged_decode_plain`. There is no fallback between the two. The source
has two kernels, picked by shape (`paged_path`): "cluster" splits each
(head, slot) row's live pages over the blocks of a thread block cluster
(`paged_ranks` of them) and merges their partial softmax states in rank
0's shared memory (16-bit operands, head dims multiples of 8, 16-byte
aligned rows); "block" is one block per (head, slot) and takes every
other shape, f32 included.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .attention import NEG_INF

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_HEAD_DIM = 256  # csrc/paged_decode.cu: 8 values per lane
PAGED_PATHS = ("block", "cluster")   # the C entry point's path codes
_CLUSTER_MAX_RANKS = 8               # csrc/paged_decode.cu kMaxRanks
_CLUSTER_MAX_RUN_PAGES = 4096        # csrc/paged_decode.cu kMaxRunPages
_CLUSTER_TILE = 64                   # positions a block reads in one round

_SIGNATURE = {
    "ff_paged_decode": [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def paged_ranks(pages_per_slot: int, page_size: int) -> int:
    """Blocks a cluster of the cluster kernel: one per 64 positions of the
    table (a block's one round of loads at d = 64), 1 to 8 (the portable
    cluster size): 8 from 449 positions on, the serving shape's 512
    included."""
    positions = pages_per_slot * page_size
    return max(1, min(_CLUSTER_MAX_RANKS, -(-positions // _CLUSTER_TILE)))


def paged_path(dtype, d: int, dv: int, strides, pages_per_slot: int,
               page_size: int) -> str:
    """Which kernel of csrc/paged_decode.cu takes this shape: "cluster" for
    bf16/fp16 with d and dv multiples of 8 whose pool strides (the six
    element strides of k and v over heads, pages, positions) keep every
    row 16-byte aligned and whose table splits into runs of at most
    4096 pages a block; "block" for every other shape (f32 included)."""
    ranks = paged_ranks(pages_per_slot, page_size)
    if (dtype in (torch.bfloat16, torch.float16) and d % 8 == 0
            and dv % 8 == 0 and all(s % 8 == 0 for s in strides)
            and -(-pages_per_slot // ranks) <= _CLUSTER_MAX_RUN_PAGES):
        return "cluster"
    return "block"


def paged_decode_plain(q, k_pages, v_pages, page_table, lengths):
    """The JAX kernel's arithmetic in plain PyTorch: page by page over each
    slot's live pages, an online softmax in f32 with positions >= length
    masked by NEG_INF, written once with l clamped at 1e-30. Reads no table
    entry past a slot's live pages."""
    slots, heads, d = q.shape
    page_size = k_pages.shape[2]
    dv = v_pages.shape[-1]
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros((slots, heads, dv), dtype=torch.float32,
                      device=q.device)
    n_pages = page_table.shape[1]
    for b in range(slots):
        length = int(lengths[b])
        qb = q[b].float()                                   # (h, d)
        m = torch.full((heads, 1), NEG_INF, device=q.device)
        l = torch.zeros((heads, 1), device=q.device)
        acc = torch.zeros((heads, dv), device=q.device)
        for i in range(min(n_pages, -(-length // page_size))):
            phys = int(page_table[b, i])
            k = k_pages[:, phys].float()                    # (h, page, d)
            v = v_pages[:, phys].float()
            s = torch.einsum("hd,htd->ht", qb, k) * scale
            pos = i * page_size + torch.arange(page_size, device=q.device)
            s = torch.where(pos[None, :] < length, s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("ht,htd->hd", p, v)
            m = m_new
        out[b] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype)


def _paged_decode_cuda(q, k_pages, v_pages, page_table, lengths, *,
                       _path=None, _ranks=None):
    """Launch csrc/paged_decode.cu on `paged_path`'s kernel, or on `_path`
    (chip_smoke.py times the "block" kernel at the serving shape), which
    must take the shape: the kernel refuses what it does not take. The
    cluster kernel runs `paged_ranks` blocks a cluster, or `_ranks` (the
    card tests split rows over 1 to 8)."""
    what = "paged_decode"
    build.require_cuda_operands(what, (q, k_pages, v_pages), _KERNEL_DTYPES)
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"{what}: q/k/v dtypes differ "
                        f"({q.dtype}, {k_pages.dtype}, {v_pages.dtype})")
    for t, name in ((page_table, "page_table"), (lengths, "lengths")):
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous int32 "
                             f"tensor on {q.device}")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError(f"{what}: q (slots, h, d) and pools "
                         "(h, pages, page_size, d) expected")
    slots, heads, d = q.shape
    _, num_pages, page_size, dv = v_pages.shape
    if (k_pages.shape[:3] != v_pages.shape[:3] or k_pages.shape[0] != heads
            or k_pages.shape[3] != d):
        raise ValueError(f"{what}: pool shapes k {tuple(k_pages.shape)} v "
                         f"{tuple(v_pages.shape)} disagree with q "
                         f"{tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != slots \
            or lengths.shape != (slots,):
        raise ValueError(f"{what}: page_table (slots, pages_per_slot) and "
                         "lengths (slots,) expected")
    if not q.is_contiguous() or k_pages.stride(3) != 1 \
            or v_pages.stride(3) != 1:
        raise ValueError(f"{what}: q must be contiguous and the pools' last "
                         "axis contiguous")
    if d > _MAX_HEAD_DIM or dv > _MAX_HEAD_DIM or slots > 65535:
        raise ValueError(f"{what}: head dims <= {_MAX_HEAD_DIM}, slots <= "
                         f"65535 (got d={d} dv={dv} slots={slots})")
    strides = k_pages.stride()[:3] + v_pages.stride()[:3]
    path = (paged_path(q.dtype, d, dv, strides, page_table.shape[1],
                       page_size) if _path is None else _path)
    ranks = paged_ranks(page_table.shape[1], page_size) if _ranks is None \
        else _ranks
    if path not in PAGED_PATHS:
        raise ValueError(f"{what}: unknown path {path!r}")
    out = torch.empty((slots, heads, dv), dtype=q.dtype, device=q.device)
    lib = build.load(what, _SIGNATURE)
    rc = lib.ff_paged_decode(
        q.device.index or 0, build.DTYPE_CODES[str(q.dtype)[6:]],
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        slots, heads, d, dv, page_size, page_table.shape[1], *strides,
        1.0 / math.sqrt(d), PAGED_PATHS.index(path), ranks,
        build.stream_ptr(q))
    build.check_launch(rc, what, f"{what}_{path}")
    return out


def paged_flash_decode(q, k_pages, v_pages, page_table, lengths):
    """Single-token attention over the paged K/V pool -> (slots, heads, dv)
    in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, page_table, lengths)
    return _paged_decode_cuda(q, k_pages, v_pages, page_table, lengths)


def paged_decode_reference(q, k_pages, v_pages, page_table, lengths):
    """Dense parity oracle: gather every slot's pages, mask positions past
    its length, one softmax. Reads every table entry, so all must be in
    range; test-sized only."""
    slots, h, d = q.shape
    page_size = k_pages.shape[2]
    n_pages = page_table.shape[1]
    idx = page_table.long()
    k = k_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(
        slots, h, n_pages * page_size, d)
    v = v_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(
        slots, h, n_pages * page_size, v_pages.shape[-1])
    s = torch.einsum("bhd,bhtd->bht", q.float(), k.float()) / math.sqrt(d)
    pos = torch.arange(n_pages * page_size, device=q.device)[None, None, :]
    s = torch.where(pos < lengths.long()[:, None, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhtd->bhd", p, v.float()).to(q.dtype)


def paged_view_of_cache(k_cache, v_cache, page_size: int):
    """View dense per-slot caches (slots, max_len, heads, d) as a paged pool:
    slot b's logical page i is physical page ``b * pages_per_slot + i``.
    Returns strided views (no copy) and the int32 table. Requires
    page_size | max_len."""
    b, max_len, h, _ = k_cache.shape
    if page_size <= 0 or max_len % page_size:
        raise ValueError(
            f"page_size {page_size} must divide the cache length {max_len}")
    pp = max_len // page_size

    def to_pool(c):
        # (b, max_len, h, d) -> (h, b*pp, page_size, d): b and pp merge
        # without a copy because pp's stride times pp is b's stride (view
        # raises rather than copy if that ever stops holding)
        return c.view(b, pp, page_size, h, c.shape[-1]) \
                .permute(3, 0, 1, 2, 4) \
                .view(h, b * pp, page_size, c.shape[-1])

    table = (torch.arange(b, device=k_cache.device)[:, None] * pp
             + torch.arange(pp, device=k_cache.device)[None, :]
             ).to(torch.int32)
    return to_pool(k_cache), to_pool(v_cache), table


def decode_page_size(max_len: int, preferred: int = 16) -> int:
    """Largest page size <= preferred dividing max_len (>= 1 always)."""
    p = max(1, min(int(preferred), int(max_len)))
    while max_len % p:
        p -= 1
    return p
