"""The split-and-merge arithmetic of the cluster paged-decode kernel,
emulated in plain torch and held against the JAX package's Pallas kernel.

csrc/paged_decode.cu's "cluster" kernel runs on the card only. It splits
each (head, slot) row's LIVE pages into `ranks` contiguous runs of
ceil(live / ranks) pages, one block each; each block keeps an online
softmax (m, l, acc) over its run, and rank 0 merges the busy ranks'
partials in rank order, then divides by l clamped at 1e-30. The emulation
below does the same in f32 and is compared with
`flexflow_tpu.kernels.decode.paged_flash_decode(..., interpret=True)` and
the JAX dense reference (on the slots with live positions) on
numpy-seeded inputs. The emulation reads the
table with its dead entries set out of range (it must never read them);
JAX, whose DMA reads every entry, gets them in range. Tolerance: atol and
rtol 1e-5 (f32 throughout; only the summation order differs).
"""
import functools

import jax  # noqa: F401  (the JAX package's kernel runs on the CPU here)
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import decode as jdec
from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.kernels import decode as tdec

NEG_INF = -1e30
TOL = dict(atol=1e-5, rtol=1e-5)
SLOTS, HEADS, D, POSITIONS = 5, 2, 8, 48
DEAD = 2 ** 30


def rank_runs(length: int, page_size: int, pages_per_slot: int, ranks: int):
    """The kernel's split: the clamped length, and the busy ranks' page
    runs [p0, p1) in rank order."""
    length = max(0, min(length, pages_per_slot * page_size))
    live = -(-length // page_size)
    per = -(-live // ranks)
    busy = -(-live // per) if per else 0
    return length, [(r * per, min(live, r * per + per)) for r in range(busy)]


def merge(state, other):
    """The merge of two online-softmax states (m, l, acc)."""
    (m, l, acc), (m2, l2, acc2) = state, other
    mm = torch.maximum(m, m2)
    s1, s2 = torch.exp(m - mm), torch.exp(m2 - mm)
    return mm, l * s1 + l2 * s2, acc * s1 + acc2 * s2


def cluster_decode(q, k_pages, v_pages, table, lengths, ranks):
    """Each rank's online softmax over its run of pages, then the
    rank-ordered merge, for every (slot, head)."""
    slots, heads, d = q.shape
    page_size, dv = k_pages.shape[2], v_pages.shape[-1]
    scale = 1.0 / np.sqrt(d)
    out = torch.zeros(slots, heads, dv)
    empty = (torch.tensor(NEG_INF), torch.tensor(0.0), torch.zeros(dv))
    for b in range(slots):
        length, runs = rank_runs(int(lengths[b]), page_size, table.shape[1],
                                 ranks)
        for h in range(heads):
            total = empty
            for p0, p1 in runs:
                part = empty
                for page in range(p0, p1):
                    phys = int(table[b, page])
                    pos = page * page_size + torch.arange(page_size)
                    live = pos < length
                    s = (k_pages[h, phys] @ q[b, h]) * scale
                    m_new = torch.maximum(part[0], s[live].max())
                    p = torch.where(live, torch.exp(s - m_new), 0.0)
                    alpha = torch.exp(part[0] - m_new)
                    part = (m_new, part[1] * alpha + p.sum(),
                            part[2] * alpha + p @ v_pages[h, phys])
                total = merge(total, part)
            out[b, h] = total[2] / total[1].clamp_min(1e-30)
    return out


def inputs(page_size: int, dv: int, seed: int = 0):
    """q, pools, the table in range and with its dead entries out of
    range, and lengths 0, 1, a non-multiple of the page, past the table,
    and a full slot."""
    rng = np.random.RandomState(seed + page_size + dv)
    pp = POSITIONS // page_size
    q = rng.randn(SLOTS, HEADS, D).astype(np.float32)
    k = rng.randn(HEADS, SLOTS * pp, page_size, D).astype(np.float32)
    v = rng.randn(HEADS, SLOTS * pp, page_size, dv).astype(np.float32)
    table = rng.permutation(SLOTS * pp).reshape(SLOTS, pp).astype(np.int32)
    lengths = np.array([0, 1, 29, POSITIONS + 9, POSITIONS], np.int32)
    dead = table.copy()
    for b, n in enumerate(lengths):
        dead[b, -(-min(int(n), POSITIONS) // page_size):] = DEAD
    return q, k, v, table, dead, lengths


@functools.lru_cache(maxsize=None)
def jax_outputs(page_size: int, dv: int):
    """The Pallas kernel in interpret mode and the dense reference."""
    q, k, v, table, _, lengths = inputs(page_size, dv)
    return (np.asarray(jdec.paged_flash_decode(q, k, v, table, lengths,
                                               interpret=True)),
            np.asarray(jdec.paged_decode_reference(q, k, v, table, lengths)))


@pytest.mark.parametrize("dv", [D, 12])
@pytest.mark.parametrize("page_size", [1, 4, 16])
@pytest.mark.parametrize("ranks", [1, 2, 3, 5, 8])
def test_split_and_merge_matches_the_jax_kernel(ranks, page_size, dv):
    q, k, v, _, dead, lengths = inputs(page_size, dv)
    ours = cluster_decode(*map(torch.from_numpy, (q, k, v, dead, lengths)),
                          ranks)
    kernel, reference = jax_outputs(page_size, dv)
    np.testing.assert_allclose(ours.numpy(), kernel, **TOL)
    # the dense reference averages V uniformly where every score is
    # masked; the kernel gives 0 for a length-0 slot (slot 0), as here
    np.testing.assert_allclose(ours.numpy()[1:], reference[1:], **TOL)
    assert not ours[0].any()


@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_split_and_merge_matches_the_plain_version(page_size):
    """The port's plain version (the CPU path of paged_flash_decode) and
    the emulated split agree on the same junk-filled table."""
    q, k, v, _, dead, lengths = inputs(page_size, 12, seed=1)
    args = tuple(map(torch.from_numpy, (q, k, v, dead, lengths)))
    np.testing.assert_allclose(cluster_decode(*args, 8).numpy(),
                               tdec.paged_flash_decode(*args).numpy(), **TOL)


@pytest.mark.parametrize("length,page_size,pages,ranks,want", [
    (0, 16, 32, 8, []),
    (1, 16, 32, 8, [(0, 1)]),
    (17, 16, 32, 8, [(0, 1), (1, 2)]),
    (100, 16, 32, 8, [(i, i + 1) for i in range(7)]),
    (300, 16, 32, 8, [(0, 3), (3, 6), (6, 9), (9, 12), (12, 15), (15, 18),
                      (18, 19)]),
    (512, 16, 32, 8, [(4 * i, 4 * i + 4) for i in range(8)]),
    (9999, 16, 32, 8, [(4 * i, 4 * i + 4) for i in range(8)]),   # clamped
    (29, 4, 12, 3, [(0, 3), (3, 6), (6, 8)]),
    (-3, 4, 12, 8, []),
])
def test_rank_runs_cover_the_live_pages_once(length, page_size, pages, ranks,
                                             want):
    """Busy ranks hold contiguous runs, in order, covering exactly the
    live pages; a short slot leaves the later ranks empty."""
    clamped, runs = rank_runs(length, page_size, pages, ranks)
    assert runs == want
    assert clamped == max(0, min(length, pages * page_size))
    assert len(runs) <= ranks


@pytest.mark.parametrize("dtype,d,dv,strides,pages,page,path", [
    (torch.bfloat16, 64, 64, (64, 16384, 1024) * 2, 32, 16, "cluster"),
    (torch.float16, 128, 64, (8192, 2048, 128, 4096, 1024, 64), 4, 16,
     "cluster"),
    (torch.bfloat16, 8, 24, (8, 8, 8, 24, 24, 24), 1, 1, "cluster"),
    (torch.float32, 64, 64, (64, 16384, 1024) * 2, 32, 16, "block"),
    (torch.bfloat16, 20, 36, (20, 80, 20, 36, 144, 36), 4, 4, "block"),
    (torch.bfloat16, 64, 64, (64, 340, 68) * 2, 12, 5, "block"),
    # a block stages at most 4096 table entries: 8 ranks of 4096 pages
    (torch.bfloat16, 64, 64, (64, 64, 64) * 2, 8 * 4096, 1, "cluster"),
    (torch.bfloat16, 64, 64, (64, 64, 64) * 2, 8 * 4096 + 1, 1, "block"),
])
def test_paged_path_picks_the_cluster_kernel_where_it_takes_the_shape(
        dtype, d, dv, strides, pages, page, path):
    assert tdec.paged_path(dtype, d, dv, strides, pages, page) == path


@pytest.mark.parametrize("pages,page,ranks", [
    (1, 1, 1), (4, 16, 1), (5, 16, 2), (27, 16, 7), (28, 16, 7),
    (29, 16, 8), (32, 16, 8), (256, 16, 8), (10 ** 6, 1, 8)])
def test_paged_ranks_give_a_block_64_positions_up_to_8_blocks(pages, page,
                                                              ranks):
    assert tdec.paged_ranks(pages, page) == ranks


def test_the_serving_pool_takes_the_cluster_path():
    """The strided view of the serving LM's bf16 caches (8 slots, 512
    positions, 16 heads of 64, 16-token pages) is cluster-shaped."""
    kc = torch.zeros(8, 512, 16, 64, dtype=torch.bfloat16)
    kp, vp, table = tdec.paged_view_of_cache(kc, kc, 16)
    assert tdec.paged_path(torch.bfloat16, 64, 64,
                           kp.stride()[:3] + vp.stride()[:3],
                           table.shape[1], 16) == "cluster"
    assert tdec.paged_ranks(table.shape[1], 16) == 8
    assert {"paged_decode_cluster", "paged_decode_block"} <= \
        set(build.PATH_KERNELS)
    assert tdec.PAGED_PATHS == ("block", "cluster")
