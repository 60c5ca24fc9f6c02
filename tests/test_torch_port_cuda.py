"""flexflow_tpu_torch's CUDA kernels against their plain versions, on the
card. Marked `cuda`: without a CUDA device they skip (the CPU suite
covers the plain versions against the JAX package instead). On a GPU
machine with nvcc:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(`--noconftest` skips the suite's JAX set-up, which these tests do not
need.)

Tolerances, |kernel - plain| <= atol + rtol * |plain|:
  * paged decode: both versions keep every step in f32 and round only the
    output, so they differ by at most one step of it (rtol 2^-7) plus f32
    summation order (atol 1e-5);
  * flash, 16-bit: the kernel rounds P at the running row maximum, the
    plain version at the final one, so O may move by a few 2^-9 relative
    steps of P, averaged over the row (atol 4e-3, one bf16 step at |O| ~
    1), plus one output step (rtol 2^-7);
  * flash, f32: nothing is rounded but the summation order (1e-5);
  * lse is f32 in both: 1e-5;
  * flash backward, 16-bit: the derived limit, `FLASH_BWD_TOL` plus
    `flash_bwd_slack` per element (kernels/attention.py): both versions
    round P and dS to the input dtype before their products, and where
    the kernel's f32 scores (summed in another order) put an element on
    the other side of a rounding boundary, two such flips per row at the
    row's largest step are allowed;
  * flash backward, f32: summation order only (atol 2e-6, rtol 1e-5).
The dropout variants keep those limits: kernel and plain version scale
the kept P (and dP) by 1/(1 - rate) before they round, and the mask is
exact (with V = I the forward's O is exactly 0 where an element was
dropped, which checks it bit for bit).

The CUDA graphs (the train scan, the captured decode step) replay the
eager steps' kernels on the same data and seeds, so they are held to the
eager steps bit for bit (weights) and token for token (decode).
"""
import numpy as np
import pytest
import torch

from flexflow_tpu_torch.kernels import attention as ka
from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.kernels import decode as kd

pytestmark = pytest.mark.cuda

BF16_STEP = 2.0 ** -7
TOL = {"paged": (1e-5, BF16_STEP), "flash": (4e-3, BF16_STEP),
       "flash_f32": (1e-5, 1e-5), "flash_bwd_f32": (2e-6, 1e-5)}
LSE_ATOL = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _assert_close(out, ref, which, slack=0.0):
    atol, rtol = TOL[which] if isinstance(which, str) else which
    err = (out.float() - ref.float()).abs()
    lim = atol + rtol * ref.float().abs() + slack
    assert bool((err <= lim).all()), \
        f"{which}: max err {err.max().item()}, worst err/limit " \
        f"{(err / lim).max().item()}"


def _assert_bwd_close(got, ref, ins, **kw):
    """(dq, dk, dv) against the plain backward's: f32 under its TOL,
    16-bit under the derived limit."""
    dtype = got[0].dtype
    if dtype == torch.float32:
        for g, r in zip(got, ref):
            _assert_close(g, r, "flash_bwd_f32")
        return
    slack = ka.flash_bwd_slack(*ins, **kw)
    for g, r, sl in zip(got, ref, slack):
        assert g.dtype == dtype and g.shape == r.shape
        _assert_close(g, r, ka.FLASH_BWD_TOL[dtype], sl)


@pytest.mark.parametrize("sq,sk,d,dv,causal,dtype", [
    (128, 128, 64, 64, True, torch.bfloat16),
    (100, 300, 64, 32, False, torch.bfloat16),
    (300, 100, 128, 64, True, torch.bfloat16),
    (200, 200, 40, 24, True, torch.bfloat16),   # head dims not 16k
    (200, 200, 64, 64, True, torch.float32),
    (90, 130, 20, 36, False, torch.float32)])
def test_flash_kernel_matches_plain(gen, sq, sk, d, dv, causal, dtype):
    q, k, v = _randn(gen, 4, sq, d, dtype=dtype), \
        _randn(gen, 4, sk, d, dtype=dtype), _randn(gen, 4, sk, dv, dtype=dtype)
    before = build.launch_counts["flash_fwd"]
    o, lse = ka._flash_fwd_folded(q, k, v, causal=causal)
    po, plse = ka.flash_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_fwd"] == before + 1
    _assert_close(o, po, "flash_f32" if dtype == torch.float32 else "flash")
    assert (lse - plse).abs().max().item() <= LSE_ATOL


@pytest.mark.parametrize("sq,sk,d,dv,causal,dtype", [
    (128, 128, 64, 64, False, torch.bfloat16),
    (128, 128, 64, 64, True, torch.bfloat16),
    (100, 300, 64, 32, False, torch.bfloat16),
    (300, 100, 128, 64, True, torch.bfloat16),
    (64, 160, 64, 64, True, torch.bfloat16),    # keys no query sees
    (96, 96, 256, 256, True, torch.bfloat16),   # 2 warps a block
    (128, 128, 64, 64, True, torch.float16),
    (200, 200, 40, 24, True, torch.bfloat16),   # head dims not 16k
    (200, 200, 64, 64, True, torch.float32),
    (90, 130, 20, 36, False, torch.float32)])
def test_flash_bwd_kernel_matches_plain(gen, sq, sk, d, dv, causal, dtype):
    q, k, v = _randn(gen, 4, sq, d, dtype=dtype), \
        _randn(gen, 4, sk, d, dtype=dtype), _randn(gen, 4, sk, dv, dtype=dtype)
    do = _randn(gen, 4, sq, dv, dtype=dtype)
    o, lse = ka._flash_fwd_folded(q, k, v, causal=causal)
    before = build.launch_counts["flash_bwd"]
    got = ka._flash_bwd_folded(q, k, v, o, lse, do, causal=causal)
    ref = ka.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_bwd"] == before + 1
    _assert_bwd_close(got, ref, (q, k, v, o, lse, do), causal=causal)
    if causal and sk > sq:
        assert not got[1][:, sq:].any() and not got[2][:, sq:].any()
    # two passes, no atomics: the same inputs give the same bits
    again = ka._flash_bwd_folded(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "cluster"),
                                        (torch.float16, "cluster"),
                                        (torch.float32, "block")])
def test_paged_kernel_matches_plain_on_a_strided_cache_view(gen, dtype, path):
    kc = _randn(gen, 3, 64, 4, 64, dtype=dtype)
    vc = _randn(gen, 3, 64, 4, 64, dtype=dtype)
    kp, vp, table = kd.paged_view_of_cache(kc, vc, 16)
    q = _randn(gen, 3, 4, 64, dtype=dtype)
    lengths = torch.tensor([1, 30, 64], dtype=torch.int32, device="cuda")
    before = build.path_counts[f"paged_decode_{path}"]
    out = kd.paged_flash_decode(q, kp, vp, table, lengths)
    ref = kd.paged_decode_plain(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert build.path_counts[f"paged_decode_{path}"] == before + 1
    _assert_close(out, ref, "paged")


DEAD = 2 ** 30   # a table entry past a slot's live pages: never read


def _paged_case(gen, d, dv, page, dtype, slots=6, heads=4, pp=12):
    """A scattered table over a contiguous pool. Lengths: 0, 1, past the
    table, a non-multiple of the page, the whole table, two pages. Entries
    past each slot's live pages are DEAD in `table`, in range in
    `in_range` (for the dense reference, which reads every entry)."""
    q = _randn(gen, slots, heads, d, dtype=dtype)
    kp = _randn(gen, heads, slots * pp, page, d, dtype=dtype)
    vp = _randn(gen, heads, slots * pp, page, dv, dtype=dtype)
    in_range = torch.randperm(slots * pp, generator=gen, device="cuda") \
        .view(slots, pp).to(torch.int32)
    lens = [0, 1, pp * page + 5, 3 * page + 1, pp * page, 2 * page][:slots]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    table = in_range.clone()
    for b, n in enumerate(lens):
        table[b, -(-min(n, pp * page) // page):] = DEAD
    return q, kp, vp, table, in_range, lengths


# (d, dv, page, dtype): the cluster kernel at each lane count (4, 8, 16,
# 32 lanes a row), dv != d both ways, pages of 1, 4, 8 and 16 positions,
# fp16; then shapes only the block kernel takes
_PAGED_CASES = [
    (64, 64, 16, torch.bfloat16, "cluster"),
    (128, 128, 16, torch.bfloat16, "cluster"),
    (64, 128, 4, torch.bfloat16, "cluster"),
    (128, 64, 1, torch.float16, "cluster"),
    (64, 64, 16, torch.float16, "cluster"),
    (256, 256, 8, torch.bfloat16, "cluster"),
    (8, 24, 4, torch.bfloat16, "cluster"),
    (40, 40, 16, torch.bfloat16, "cluster"),
    (64, 64, 16, torch.float32, "block"),
    (20, 36, 4, torch.bfloat16, "block"),
]


@pytest.mark.parametrize("d,dv,page,dtype,path", _PAGED_CASES)
def test_paged_kernels_match_plain_on_a_scattered_table(gen, d, dv, page,
                                                        dtype, path):
    """Each path `paged_path` names, and the block kernel at every shape
    too: against the plain version (given the DEAD entries) and the dense
    reference (given entries in range, on the live slots); a length-0
    slot gives 0; each
    launch counts once under its path; repeats are bit-equal."""
    q, kp, vp, table, in_range, lengths = _paged_case(gen, d, dv, page, dtype)
    assert kd.paged_path(dtype, d, dv, kp.stride()[:3] + vp.stride()[:3],
                         table.shape[1], page) == path
    plain = kd.paged_decode_plain(q, kp, vp, table, lengths)
    ref = kd.paged_decode_reference(q, kp, vp, in_range, lengths)
    for p in sorted({path, "block"}):
        before = dict(build.path_counts)
        out = kd._paged_decode_cuda(q, kp, vp, table, lengths, _path=p)
        again = kd._paged_decode_cuda(q, kp, vp, table, lengths, _path=p)
        torch.cuda.synchronize()
        assert {k_: build.path_counts[k_] - before[k_]
                for k_ in build.path_counts} == {
            k_: 2 * int(k_ == f"paged_decode_{p}") for k_ in build.path_counts}
        assert out.dtype == dtype and out.shape == (6, 4, dv)
        _assert_close(out, plain, "paged")
        # the dense reference averages V where no position is live (slot
        # 0); the kernels give 0 there, as the TPU kernel does
        _assert_close(out[1:], ref[1:], "paged")
        assert not out[0].any()
        assert torch.equal(out, again)


@pytest.mark.parametrize("ranks", [1, 3, 5, 8])
def test_the_cluster_kernel_at_every_cluster_size(gen, ranks):
    """Rows split over 1 to 8 blocks a cluster agree with the plain
    version, bit-equal run to run."""
    q, kp, vp, table, in_range, lengths = _paged_case(gen, 64, 64, 4,
                                                      torch.bfloat16)
    plain = kd.paged_decode_plain(q, kp, vp, table, lengths)
    out = kd._paged_decode_cuda(q, kp, vp, table, lengths, _ranks=ranks)
    again = kd._paged_decode_cuda(q, kp, vp, table, lengths, _ranks=ranks)
    torch.cuda.synchronize()
    _assert_close(out, plain, "paged")
    assert torch.equal(out, again)


def test_paged_launches_count_by_path(gen):
    q, kp, vp, table, _, lengths = _paged_case(gen, 64, 64, 16,
                                               torch.bfloat16)
    before, paths = build.launch_counts["paged_decode"], dict(build.path_counts)
    kd.paged_flash_decode(q, kp, vp, table, lengths)
    kd._paged_decode_cuda(q, kp, vp, table, lengths, _path="block")
    torch.cuda.synchronize()
    assert build.launch_counts["paged_decode"] == before + 2
    assert build.path_counts["paged_decode_cluster"] == \
        paths["paged_decode_cluster"] + 1
    assert build.path_counts["paged_decode_block"] == \
        paths["paged_decode_block"] + 1


def test_the_cluster_kernel_refuses_what_it_does_not_take(gen):
    """f32, head dims not multiples of 8, and rows that are not 16-byte
    aligned: the cluster kernel refuses, the wrapper raises and counts
    nothing; an unknown path is a ValueError."""
    before = dict(build.path_counts)
    for d, dtype in ((64, torch.float32), (20, torch.bfloat16)):
        q, kp, vp, table, _, lengths = _paged_case(gen, d, d, 4, dtype)
        with pytest.raises(RuntimeError):
            kd._paged_decode_cuda(q, kp, vp, table, lengths, _path="cluster")
    q, kp, vp, table, _, lengths = _paged_case(gen, 64, 64, 4, torch.bfloat16)
    odd = _randn(gen, 4, 72 * 5, 68)[:, :, :64].reshape(4, 72, 5, 64)[:, :, :4]
    assert odd.stride()[:3] == (72 * 5 * 68, 5 * 68, 68)
    assert kd.paged_path(torch.bfloat16, 64, 64, odd.stride()[:3] * 2,
                         12, 4) == "block"
    with pytest.raises(RuntimeError):
        kd._paged_decode_cuda(q, odd, odd, table, lengths, _path="cluster")
    with pytest.raises(ValueError, match="unknown path"):
        kd._paged_decode_cuda(q, kp, vp, table, lengths, _path="tiles")
    for ranks in (0, 9):     # 1 to 8 blocks a cluster
        with pytest.raises(RuntimeError):
            kd._paged_decode_cuda(q, kp, vp, table, lengths, _ranks=ranks)
    torch.cuda.synchronize()
    assert build.path_counts == before


def test_a_bf16_decode_step_takes_the_cluster_kernel(gen):
    """The serving decode step of a bf16 LM sends every paged launch to
    the cluster kernel. The step replays its captured graph: the first
    step warms up (one launch a layer) and replays (one more), a later
    step only replays."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.ff_types import DataType

    m = FFModel(FFConfig(batch_size=2, allow_mixed_precision=True))
    x = m.create_tensor((2, 32), DataType.DT_INT32)
    t = m.embedding(x, 50, 64)
    t = m.multihead_attention(t, t, t, 64, 4, causal=True)
    m.dense(m.multihead_attention(t, t, t, 64, 4, causal=True), 50)
    m.compile()
    init, step = m.executor.build_decode(2, 32)
    caches = init(m.params)
    before = dict(build.path_counts)
    step(m.params, caches, np.array([3, 17], np.int32),
         [np.array([[1], [2]], np.int32)])
    torch.cuda.synchronize()
    assert build.path_counts["paged_decode_cluster"] == \
        before["paged_decode_cluster"] + 2 * 2
    step(m.params, caches, np.array([4, 18], np.int32),
         [np.array([[3], [4]], np.int32)])
    torch.cuda.synchronize()
    assert build.path_counts["paged_decode_cluster"] == \
        before["paged_decode_cluster"] + 2 * 3
    assert build.path_counts["paged_decode_block"] == \
        before["paged_decode_block"]


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 2, 16, 64)
    with pytest.raises(TypeError):
        ka._flash_fwd_folded(q.double(), q.double(), q.double(), causal=True)
    with pytest.raises(TypeError):
        ka._flash_fwd_folded(q, q.float(), q, causal=True)
    wide = _randn(gen, 2, 16, 264)
    with pytest.raises(ValueError):
        ka._flash_fwd_folded(wide, wide, wide, causal=True)
    with pytest.raises(ValueError):
        ka._flash_fwd_folded(q.transpose(1, 2), q.transpose(1, 2),
                             q.transpose(1, 2), causal=False)
    o, lse = ka._flash_fwd_folded(q, q, q, causal=True)
    with pytest.raises(TypeError):   # lse must be f32
        ka._flash_bwd_folded(q, q, q, o, lse.to(q.dtype), o, causal=True)
    with pytest.raises(TypeError):   # one dtype for q/k/v/o/dO
        ka._flash_bwd_folded(q, q, q, o, lse, o.float(), causal=True)
    with pytest.raises(ValueError):  # lse of another length
        ka._flash_bwd_folded(q, q, q, o, lse[:, :, :8].contiguous(), o,
                             causal=True)
    with pytest.raises(ValueError):
        ka._flash_bwd_folded(q, q, q, o, lse, o.transpose(1, 2).contiguous()
                             .transpose(1, 2), causal=True)
    with pytest.raises(ValueError):
        ka._flash_bwd_folded(wide, wide, wide, wide, torch.zeros(
            2, 1, 16, device="cuda"), wide, causal=True)


def test_f32_mha_on_the_card_runs_the_flash_kernel(gen):
    """A model without mixed precision computes in f32: its causal MHA
    still launches the flash kernel (never the dense path on the card),
    and agrees with the same weights' dense path on the CPU."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.ff_types import DataType

    def build_lm(device):
        m = FFModel(FFConfig(batch_size=2, device=device))
        x = m.create_tensor((2, 24), DataType.DT_INT32)
        t = m.embedding(x, 50, 40)
        m.dense(m.multihead_attention(t, t, t, 40, 4, causal=True), 50)
        m.compile()
        return m

    gm, cm = build_lm("cuda"), build_lm("cpu")
    for op, ws in gm.params.items():
        for n, w in ws.items():
            cm.params[op][n].copy_(w.cpu())
    ids = np.random.RandomState(0).randint(0, 50, (2, 24)).astype(np.int32)
    before = build.launch_counts["flash_fwd"]
    out = gm.executor.build_forward()(gm.params, [ids])
    torch.cuda.synchronize()
    assert build.launch_counts["flash_fwd"] == before + 1
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.cpu().numpy(),
                               cm.executor.build_forward()(cm.params,
                                                           [ids]).numpy(),
                               atol=1e-5)


def _mha_pair(seed=0):
    """The same f32 MHA model on the card and on the CPU (same weights)."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType

    def make(device):
        m = FFModel(FFConfig(batch_size=2, device=device, seed=seed))
        x = m.create_tensor((2, 24, 40))
        t = m.multihead_attention(x, x, x, 40, 4, causal=True)
        m.dense(t, 40)
        m.compile(SGDOptimizer(lr=0.01),
                  LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
        return m

    gm, cm = make("cuda"), make("cpu")
    for op, ws in gm.params.items():
        for n, w in ws.items():
            cm.params[op][n].copy_(w.cpu())
    return gm, cm


def test_f32_mha_training_step_runs_both_flash_kernels(gen, monkeypatch):
    """An f32 training step on the card launches the flash forward and
    backward kernels once each (head dim 10: the CUDA-core kernels) and
    matches the CPU dense path's loss and updated weights within 1e-5
    (f32 summation order); FF_ATTENTION_IMPL=dense on the card launches
    neither."""
    monkeypatch.delenv("FF_ATTENTION_IMPL", raising=False)
    gm, cm = _mha_pair()
    rng = np.random.RandomState(1)
    x = rng.randn(2, 24, 40).astype(np.float32)
    y = rng.randn(2, 24, 40).astype(np.float32)
    before = dict(build.launch_counts)
    gm.state, gp = gm.executor.build_train_step()(gm.state, [x], y)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_fwd"] == before["flash_fwd"] + 1
    assert build.launch_counts["flash_bwd"] == before["flash_bwd"] + 1
    cm.state, cp = cm.executor.build_train_step()(cm.state, [x], y)
    np.testing.assert_allclose(gp["loss"].item(), cp["loss"].item(),
                               rtol=1e-5)
    for op, ws in gm.params.items():
        for n, w in ws.items():
            np.testing.assert_allclose(w.cpu().numpy(),
                                       cm.params[op][n].numpy(), atol=1e-5)
    monkeypatch.setenv("FF_ATTENTION_IMPL", "dense")
    before = dict(build.launch_counts)
    gm.executor.build_grad_step()(gm.params, [x], y)
    torch.cuda.synchronize()
    assert build.launch_counts == before


def test_bogus_attention_impl_raises_on_the_card(gen, monkeypatch):
    gm, _ = _mha_pair()
    x = np.zeros((2, 24, 40), np.float32)
    monkeypatch.setenv("FF_ATTENTION_IMPL", "bogus")
    with pytest.raises(ValueError, match="FF_ATTENTION_IMPL"):
        gm.executor.build_forward()(gm.params, [x])
    monkeypatch.setenv("FF_ATTENTION_IMPL", "ring")
    with pytest.raises(NotImplementedError):
        gm.executor.build_grad_step()(gm.params, [x], x)


SEEDS = (0x9E3779B9, 0x01234567)


@pytest.mark.parametrize("sq,sk,d,dv,causal,rate,dtype", [
    (128, 128, 64, 64, False, 0.1, torch.bfloat16),
    (100, 300, 64, 32, True, 0.5, torch.bfloat16),
    (96, 96, 256, 256, True, 0.1, torch.bfloat16),  # 2 warps a block (bwd)
    (128, 128, 64, 64, True, 0.1, torch.float16),
    (200, 200, 40, 24, True, 0.3, torch.bfloat16),  # head dims not 16k
    (90, 130, 16, 16, False, 0.5, torch.float32)])
def test_flash_dropout_kernels_match_plain(gen, sq, sk, d, dv, causal, rate,
                                           dtype):
    q, k, v = _randn(gen, 4, sq, d, dtype=dtype), \
        _randn(gen, 4, sk, d, dtype=dtype), _randn(gen, 4, sk, dv, dtype=dtype)
    do = _randn(gen, 4, sq, dv, dtype=dtype)
    kw = dict(causal=causal, dropout=rate, seeds=SEEDS)
    before = dict(build.launch_counts)
    o, lse = ka._flash_fwd_folded(q, k, v, **kw)
    po, plse = ka.flash_fwd_plain(q, k, v, **kw)
    got = ka._flash_bwd_folded(q, k, v, o, lse, do, **kw)
    ref = ka.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_fwd_dropout"] == \
        before["flash_fwd_dropout"] + 1
    assert build.launch_counts["flash_bwd_dropout"] == \
        before["flash_bwd_dropout"] + 1
    assert build.launch_counts["flash_fwd"] == before["flash_fwd"]
    f32 = dtype == torch.float32
    _assert_close(o, po, "flash_f32" if f32 else "flash")
    assert (lse - plse).abs().max().item() <= LSE_ATOL
    _assert_bwd_close(got, ref, (q, k, v, o, lse, do), **kw)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 40)])
def test_flash_forward_mask_is_the_hash_bit_for_bit(gen, dtype, d):
    """With V = I (dv = sk) each output column is one key's probability:
    exactly 0 where the kernel dropped it. The zeros must be the plain
    mask's drops, in the WMMA kernel and the CUDA-core one."""
    bh, sq, sk = 6, 96, 128
    q, k = _randn(gen, bh, sq, d, dtype=dtype), _randn(gen, bh, sk, d,
                                                        dtype=dtype)
    v = torch.eye(sk, dtype=dtype, device="cuda").expand(bh, sk, sk)
    o, _ = ka._flash_fwd_folded(q, k, v.contiguous(), causal=False,
                                dropout=0.3, seeds=SEEDS)
    keep = ka.attention_dropout_mask(SEEDS, 0.3, bh, sq, sk, device="cuda")
    torch.cuda.synchronize()
    assert torch.equal(o != 0, keep)


def test_equal_seeds_give_equal_bits_and_other_seeds_other_bits(gen):
    q, k, v, do = (_randn(gen, 8, 128, 64) for _ in range(4))
    kw = dict(causal=False, dropout=0.1, seeds=SEEDS)
    o1, lse1 = ka._flash_fwd_folded(q, k, v, **kw)
    o2, _ = ka._flash_fwd_folded(q, k, v, **kw)
    g1 = ka._flash_bwd_folded(q, k, v, o1, lse1, do, **kw)
    g2 = ka._flash_bwd_folded(q, k, v, o1, lse1, do, **kw)
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    kw["seeds"] = (SEEDS[0], SEEDS[1] + 1)
    o3, _ = ka._flash_fwd_folded(q, k, v, **kw)
    g3 = ka._flash_bwd_folded(q, k, v, o1, lse1, do, **kw)
    assert not torch.equal(o1, o3)
    assert not any(torch.equal(a, b) for a, b in zip(g1, g3))


# The wgmma kernels (bf16/fp16, d == dv in (64, 128)): d = 64 and 128,
# causal or not, ragged both ways, fp16, dropout at 0.1 and 0.5
_WGMMA_CASES = [
    (128, 128, 64, False, 0.0, torch.bfloat16),
    (512, 512, 64, True, 0.0, torch.bfloat16),
    (100, 300, 64, False, 0.0, torch.bfloat16),
    (300, 100, 64, True, 0.0, torch.bfloat16),   # causal, sq > sk
    (64, 160, 64, True, 0.0, torch.bfloat16),    # keys no query sees
    (129, 257, 64, True, 0.1, torch.bfloat16),
    (256, 256, 128, False, 0.0, torch.bfloat16),
    (300, 100, 128, True, 0.5, torch.bfloat16),
    (129, 257, 128, False, 0.1, torch.float16),
    (128, 128, 64, True, 0.5, torch.float16),
]


@pytest.mark.parametrize("sq,sk,d,causal,rate,dtype", _WGMMA_CASES)
def test_wgmma_kernels_match_plain(gen, sq, sk, d, causal, rate, dtype):
    assert ka.flash_path(dtype, d, d) == "wgmma"
    q, k, v, do = (_randn(gen, 4, n, d, dtype=dtype)
                   for n in (sq, sk, sk, sq))
    kw = dict(causal=causal, dropout=rate, seeds=SEEDS)
    before = dict(build.path_counts)
    o, lse = ka._flash_fwd_folded(q, k, v, **kw)
    got = ka._flash_bwd_folded(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert {k_: build.path_counts[k_] - before[k_]
            for k_ in build.path_counts} == {
        k_: int(k_ in ("flash_fwd_wgmma", "flash_bwd_wgmma"))
        for k_ in build.path_counts}
    po, plse = ka.flash_fwd_plain(q, k, v, **kw)
    _assert_close(o, po, "flash")
    assert (lse - plse).abs().max().item() <= LSE_ATOL
    ref = ka.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    _assert_bwd_close(got, ref, (q, k, v, o, lse, do), **kw)
    if causal and sk > sq:
        assert not got[1][:, sq:].any() and not got[2][:, sq:].any()


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (128, torch.float16)])
def test_wgmma_forward_mask_is_the_hash_bit_for_bit(gen, d, dtype):
    """V = I with d = dv = sk: each output column is one key's probability,
    exactly 0 where the wgmma kernel dropped it, so its mapping of the
    accumulator fragment to (q, k) meets the plain mask at every element."""
    bh, sq, sk = 6, 200, d
    q, k = _randn(gen, bh, sq, d, dtype=dtype), _randn(gen, bh, sk, d,
                                                        dtype=dtype)
    v = torch.eye(sk, dtype=dtype, device="cuda").expand(bh, sk, sk)
    before = build.path_counts["flash_fwd_wgmma"]
    o, _ = ka._flash_fwd_folded(q, k, v.contiguous(), causal=False,
                                dropout=0.3, seeds=SEEDS)
    keep = ka.attention_dropout_mask(SEEDS, 0.3, bh, sq, sk, device="cuda")
    torch.cuda.synchronize()
    assert build.path_counts["flash_fwd_wgmma"] == before + 1
    assert torch.equal(o != 0, keep)


def test_wgmma_backward_is_bit_equal_run_to_run(gen):
    """The training shape (bh 128, sq = sk = 512, d 64, bf16): two passes,
    no atomics, so the same inputs give the same bits."""
    q, k, v, do = (_randn(gen, 128, 512, 64) for _ in range(4))
    o, lse = ka._flash_fwd_folded(q, k, v, causal=False)
    first = ka._flash_bwd_folded(q, k, v, o, lse, do, causal=False)
    for _ in range(2):
        again = ka._flash_bwd_folded(q, k, v, o, lse, do, causal=False)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("d,dv,dtype,path", [
    (64, 64, torch.bfloat16, "wgmma"), (128, 128, torch.float16, "wgmma"),
    (64, 32, torch.bfloat16, "wmma"), (256, 256, torch.float16, "wmma"),
    (40, 40, torch.bfloat16, "rows"), (64, 64, torch.float32, "rows")])
def test_launches_count_by_path(gen, d, dv, dtype, path):
    """Each launch adds one to its kernel's count and one to its path's,
    the path `flash_path` names; forward and backward alike."""
    assert ka.flash_path(dtype, d, dv) == path
    q, k, v = (_randn(gen, 2, 96, c, dtype=dtype) for c in (d, d, dv))
    before, paths = dict(build.launch_counts), dict(build.path_counts)
    o, lse = ka._flash_fwd_folded(q, k, v, causal=True)
    ka._flash_bwd_folded(q, k, v, o, lse, o, causal=True)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_fwd"] == before["flash_fwd"] + 1
    assert build.launch_counts["flash_bwd"] == before["flash_bwd"] + 1
    assert {k_: build.path_counts[k_] - paths[k_]
            for k_ in build.path_counts} == {
        k_: int(k_ in (f"flash_fwd_{path}", f"flash_bwd_{path}"))
        for k_ in build.path_counts}


def test_a_path_that_does_not_take_the_shape_raises(gen):
    """No launch moves to another path: the wgmma kernels refuse head dims
    other than 64 and 128 (and d != dv), the WMMA ones head dims that are
    not multiples of 16; the wrapper raises and counts nothing."""
    q = _randn(gen, 2, 64, 40)
    before = dict(build.path_counts)
    with pytest.raises(RuntimeError):
        ka._flash_fwd_cuda(q, q, q, causal=True, _path="wgmma")
    with pytest.raises(RuntimeError):
        ka._flash_fwd_cuda(q, q, q, causal=True, _path="wmma")
    w = _randn(gen, 2, 64, 64)
    with pytest.raises(RuntimeError):
        ka._flash_fwd_cuda(w, w, _randn(gen, 2, 64, 32), causal=False,
                           _path="wgmma")
    o, lse = ka._flash_fwd_cuda(q, q, q, causal=True)
    with pytest.raises(RuntimeError):
        ka._flash_bwd_cuda(q, q, q, o, lse, o, causal=True, _path="wgmma")
    with pytest.raises(ValueError):
        ka._flash_fwd_cuda(w, w, w, causal=True, _path="tiles")
    torch.cuda.synchronize()
    assert build.path_counts["flash_fwd_rows"] == before["flash_fwd_rows"] + 1
    assert sum(build.path_counts.values()) == sum(before.values()) + 1


# -- CUDA graphs: the train scan and the captured decode step -------------
def _drop_model(device="cuda", spd=1, mixed=True, seed=0):
    """A small MHA model with attention dropout (the flash kernels' dropout
    variants on the card, head dim 16: the WMMA path) and a standalone
    Dropout op, bf16 over f32 weights."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType

    m = FFModel(FFConfig(batch_size=2, device=device, seed=seed,
                         allow_mixed_precision=mixed,
                         iterations_per_dispatch=spd))
    x = m.create_tensor((2, 32, 64))
    t = m.multihead_attention(x, x, x, 64, 4, dropout=0.2)
    t = m.dropout(t, 0.3)
    m.dense(t, 64)
    m.compile(SGDOptimizer(lr=0.05),
              LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              [MetricsType.METRICS_MEAN_SQUARED_ERROR])
    return m


def _drop_data(n=14):
    rng = np.random.RandomState(3)
    return (rng.randn(n, 32, 64).astype(np.float32),
            rng.randn(n, 32, 64).astype(np.float32))


def test_scan_equals_stepwise_fit_on_the_card(gen, capsys):
    """fit with iterations_per_dispatch 3 over 7 batches (two captured
    chunks of 3 and a tail graph of 1) leaves the weights and the printed
    per-epoch metrics of stepwise fit, bit for bit: the same kernels run
    on the same data with the same seed-table rows."""
    x, y = _drop_data()
    a, b = _drop_model(spd=1), _drop_model(spd=3)
    a.fit(x, y, epochs=2)
    la = [ln for ln in capsys.readouterr().out.splitlines()
          if ln.startswith("epoch")]
    b.fit(x, y, epochs=2)
    lb = [ln for ln in capsys.readouterr().out.splitlines()
          if ln.startswith("epoch")]
    strip = lambda ls: [ln.split("throughput")[0] + ln.split("samples/s")[1]  # noqa: E731
                        for ln in ls]
    assert strip(la) == strip(lb) and len(la) == 2
    assert a.state.step == b.state.step == 14
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n]), f"{op}.{n}"


def test_launch_counts_include_replays(gen):
    """A replayed graph runs its kernels without passing through the
    wrappers: the counts add the capture's launches on every replay and
    leave out the capture itself. Chunks of 2 over 4 batches: the first
    fit warms up one step and replays twice, the second only replays."""
    x, y = _drop_data(8)
    m = _drop_model(spd=2)
    build.reset_launch_counts()
    m.fit(x, y, verbose=False)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_fwd_dropout"] == 4 + 1
    assert build.launch_counts["flash_bwd_dropout"] == 4 + 1
    build.reset_launch_counts()
    m.fit(x, y, verbose=False)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_fwd_dropout"] == 4
    assert build.launch_counts["flash_bwd_dropout"] == 4
    assert build.path_counts["flash_fwd_wmma"] == 4


def test_a_failed_capture_raises(gen, monkeypatch):
    """An op that syncs with the host cannot be captured: the scan raises
    and runs no eager step in its place (the weights do not move)."""
    from flexflow_tpu_torch.ops import linear

    x, y = _drop_data(4)
    m = _drop_model(spd=2)
    before = {op: {n: w.clone() for n, w in ws.items()}
              for op, ws in m.params.items()}
    fwd = linear._forward

    def syncing(params, weights, inputs, ctx):
        inputs[0].sum().item()
        return fwd(params, weights, inputs, ctx)

    from flexflow_tpu_torch.ops.registry import get_op_def
    from flexflow_tpu_torch.ff_types import OperatorType

    monkeypatch.setattr(get_op_def(OperatorType.OP_LINEAR), "forward",
                        syncing)
    with pytest.raises(RuntimeError):
        m.fit(x, y, verbose=False)
    monkeypatch.undo()
    torch.cuda.synchronize()
    for op, ws in m.params.items():
        for n, w in ws.items():
            assert torch.equal(w, before[op][n]), f"{op}.{n}"


def _lm(device="cuda", seed=0, spd=0):
    """A small causal LM, bf16 over f32. With `spd` it is compiled to
    train (sparse CE, SGD) with that many iterations a dispatch."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import (ActiMode, DataType, LossType,
                                             MetricsType)

    m = FFModel(FFConfig(batch_size=4, device=device, seed=seed,
                         allow_mixed_precision=True,
                         iterations_per_dispatch=max(spd, 1)))
    ids = m.create_tensor((4, 64), DataType.DT_INT32)
    t = m.embedding(ids, 97, 64)
    for _ in range(2):
        t = m.multihead_attention(t, t, t, 64, 4, causal=True)
        t = m.dense(t, 64, ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, 97))
    if spd:
        # left at its init: unit-scale logits saturate the softmax, and
        # sparse CE would then have no gradient to train on
        m.compile(SGDOptimizer(lr=0.5),
                  LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  [MetricsType.METRICS_ACCURACY])
        return m
    m.compile()
    # unit-scale activations, so greedy tokens depend on the weights
    with torch.no_grad():
        for op, ws in m.params.items():
            for n, w in ws.items():
                w.mul_(4.0)
    return m


def test_captured_decode_matches_the_eager_step_token_for_token(gen):
    """incremental_generate's one-token steps replay the captured decode
    step: the tokens equal the eager steps', and the paged kernel's
    launches count the replays (2 layers a step). Then the weights move
    in place (as training moves them): the cached bf16 copies follow, and
    the replays still equal the eager steps. Last, new weight tensors
    replace them (params_from_numpy): a new graph is captured for them,
    and it too equals the eager steps."""
    from flexflow_tpu_torch.runtime.serving import incremental_generate
    from flexflow_tpu_torch.runtime.weights import params_from_numpy

    m = _lm()
    prompts = np.random.RandomState(4).randint(0, 97, (4, 9)) \
        .astype(np.int32)
    build.reset_launch_counts()
    got = incremental_generate(m, prompts, max_new_tokens=12, max_len=64)
    torch.cuda.synchronize()
    # 11 one-token steps, the first warmed up and replayed
    assert build.launch_counts["paged_decode"] == 2 * (11 + 1)
    want = incremental_generate(m, prompts, max_new_tokens=12, max_len=64,
                                _eager=True)
    np.testing.assert_array_equal(got, want)
    with torch.no_grad():
        for ws in m.params.values():
            for w in ws.values():
                w.mul_(-1.0)
    got = incremental_generate(m, prompts, max_new_tokens=12, max_len=64)
    want = incremental_generate(m, prompts, max_new_tokens=12, max_len=64,
                                _eager=True)
    np.testing.assert_array_equal(got, want)
    params_from_numpy(m, {op: {n: (0.5 * w).cpu().numpy()
                               for n, w in ws.items()}
                          for op, ws in m.params.items()})
    got = incremental_generate(m, prompts, max_new_tokens=12, max_len=64)
    want = incremental_generate(m, prompts, max_new_tokens=12, max_len=64,
                                _eager=True)
    np.testing.assert_array_equal(got, want)


def test_the_batcher_replays_the_captured_step(gen):
    """The continuous batcher's batched step replays the graph it captured
    in its serving thread, and every answer equals incremental_generate's
    on its prompt."""
    from flexflow_tpu_torch.runtime.serving import (AdmissionQueue,
                                                    ContinuousBatcher,
                                                    GenerationRequest,
                                                    ServingConfig,
                                                    incremental_generate)

    m = _lm()
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 97, n).astype(np.int32) for n in (3, 9, 17, 30,
                                                                5, 12)]
    q = AdmissionQueue(max_depth=len(prompts))
    b = ContinuousBatcher(m, ServingConfig(max_len=64, slots=4, page_size=8),
                          q)
    reqs = [GenerationRequest(p, 10, deadline_s=300.0) for p in prompts]
    b.start()
    try:
        for r in reqs:
            q.offer(r)
        outs = [r.result(timeout=300) for r in reqs]
    finally:
        b.stop()
    assert not b.dead, b.death_cause
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(
            o, incremental_generate(m, p[None], max_new_tokens=10,
                                    max_len=64)[0])


def test_served_paths_read_the_weights_the_scan_trained(gen):
    """A scan replay moves the weights without ATen dispatch. Serving
    between two fits still reads the trained weights: fit (2 steps a
    dispatch), predict and a captured decode run (they fill the bf16
    cache and capture the decode graph), fit again (replays only); then
    predict equals the uncached forward, and the captured decode steps
    give the tokens of the eager steps of a fresh model loaded with the
    trained weights."""
    from flexflow_tpu_torch.runtime.serving import incremental_generate
    from flexflow_tpu_torch.runtime.weights import params_from_numpy

    m = _lm(spd=2)
    ex = m.executor
    rng = np.random.RandomState(6)
    x = rng.randint(0, 97, (8, 64)).astype(np.int32)
    y = rng.randint(0, 97, (8, 64, 1)).astype(np.int32)
    prompts = rng.randint(0, 97, (4, 9)).astype(np.int32)
    m.fit(x, y, verbose=False)
    before = m.predict(x[:4])
    incremental_generate(m, prompts, max_new_tokens=12, max_len=64)
    m.fit(x, y, verbose=False)
    after = m.predict(x[:4])
    with torch.no_grad():
        want = ex.apply(m.params, ex._input_vals([x[:4]]))[
            ex.logits_pt.guid].float().cpu().numpy()
    assert not np.array_equal(after, before)
    np.testing.assert_array_equal(after, want)
    got = incremental_generate(m, prompts, max_new_tokens=12, max_len=64)
    fresh = _lm()
    params_from_numpy(fresh, {op: {n: w.cpu().numpy() for n, w in ws.items()}
                              for op, ws in m.params.items()})
    np.testing.assert_array_equal(
        got, incremental_generate(fresh, prompts, max_new_tokens=12,
                                  max_len=64, _eager=True))


def test_new_weights_release_the_retired_ones(gen):
    """A decode graph holds the weights it was captured on. Once new
    weight tensors replace them (params_from_numpy) and a step captures a
    graph for those, the old graph goes, and with it the retired weights
    and their cached bf16 copies."""
    import gc
    import weakref

    from flexflow_tpu_torch.runtime.serving import incremental_generate
    from flexflow_tpu_torch.runtime.weights import params_from_numpy

    m = _lm()
    prompts = np.random.RandomState(7).randint(0, 97, (4, 9)) \
        .astype(np.int32)
    incremental_generate(m, prompts, max_new_tokens=4, max_len=64)
    retired = [weakref.ref(w) for ws in m.params.values()
               for w in ws.values()]
    n_cached = len(m.executor.weight_cache._entries)
    params_from_numpy(m, {op: {n: (0.5 * w).cpu().numpy()
                               for n, w in ws.items()}
                          for op, ws in m.params.items()})
    incremental_generate(m, prompts, max_new_tokens=4, max_len=64)
    gc.collect()
    assert all(r() is None for r in retired)
    assert len(m.executor.weight_cache._entries) == n_cached


# -- the CNN path: cuDNN convolutions in exact f32, BatchNorm in a scan ----
def test_f32_conv_on_the_card_is_full_f32_and_leaves_the_flags(gen):
    """The conv op's forward and both backward convolutions in f32 stay
    within f32 rounding of the same convolution in f64 (TF32, which cuDNN
    would use by default, keeps 10 mantissa bits: ~1e-3 off), and the
    caller's cuDNN flags are as they were."""
    from flexflow_tpu_torch.ops.conv2d import conv2d

    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic)
    x = torch.randn(8, 64, 28, 28, device="cuda", generator=gen)
    k = torch.randn(128, 64 // 32, 3, 3, device="cuda", generator=gen)
    k2 = torch.randn(96, 64, 3, 3, device="cuda", generator=gen)
    for kernel, groups in ((k, 32), (k2, 1)):
        xs = [x.clone().requires_grad_(), x.double().requires_grad_()]
        ks = [kernel.clone().requires_grad_(),
              kernel.double().requires_grad_()]
        outs = [conv2d(a, b, (1, 1), (1, 1), groups) for a, b in zip(xs, ks)]
        cot = torch.randn(outs[0].shape, device="cuda", generator=gen)
        grads = [torch.autograd.grad(o, [a, b], cot.to(o.dtype))
                 for o, a, b in zip(outs, xs, ks)]
        for got, ref in [(outs[0], outs[1])] + list(zip(*grads)):
            err = ((got.double() - ref).norm() / ref.norm()).item()
            # f32 sums of up to 8 x 28 x 28 = 6272 products: ~sqrt(n)
            # roundings of 2^-24, ~5e-6; TF32 would read ~5e-4
            assert err < 5e-5, (groups, err)
    assert (cudnn.allow_tf32, cudnn.deterministic) == saved


def _bn_model(spd=1):
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType
    from flexflow_tpu_torch.models import resnext_block

    m = FFModel(FFConfig(batch_size=4, seed=0, iterations_per_dispatch=spd))
    t = m.create_tensor((4, 64, 8, 8))
    t = resnext_block(m, t, 2, 64, groups=32, projection=True)
    t = m.pool2d(t, 4, 4, 1, 1, 0, 0)
    m.softmax(m.dense(m.flat(t), 4))
    m.compile(SGDOptimizer(lr=0.05),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [MetricsType.METRICS_ACCURACY])
    return m


def test_scan_with_batchnorm_equals_stepwise_fit_on_the_card(gen):
    """A ResNeXt block's fit with iterations_per_dispatch 3 over 7
    batches (two captured chunks and a tail graph) against stepwise fit:
    the weights and the BatchNorm running statistics the captured graphs
    update in place are bit-equal, and the statistics moved."""
    rng = np.random.RandomState(4)
    x = rng.randn(28, 64, 8, 8).astype(np.float32)
    y = rng.randint(0, 4, (28, 1)).astype(np.int32)
    a, b = _bn_model(), _bn_model(spd=3)
    a.fit(x, y, epochs=2)
    b.fit(x, y, epochs=2)
    assert a.state.step == b.state.step == 14
    for tree in ("params", "net_state"):
        ta, tb = getattr(a.state, tree), getattr(b.state, tree)
        assert ta
        for op in ta:
            for n in ta[op]:
                assert torch.equal(ta[op][n], tb[op][n]), f"{tree} {op}.{n}"
    rv = next(iter(b.state.net_state.values()))["running_var"]
    assert not torch.equal(rv, torch.ones_like(rv))


def test_top_k_breaks_ties_toward_the_lower_index_on_the_card(gen):
    """RELU'd gate rows with many zeros (and ties among positive values)
    give the same top-k indices and values on the card as on the CPU,
    where tests/test_torch_port_ops2.py holds them to lax.top_k's."""
    from flexflow_tpu_torch.ops.reduce import top_k

    for shape, dtype in (((8192, 4), torch.bfloat16), ((256, 64),
                                                        torch.float32)):
        g = torch.relu(torch.randn(shape, generator=gen, device="cuda"))
        g[: shape[0] // 4] = 0.0
        g[shape[0] // 4: shape[0] // 2, ::2] = 1.25
        g = g.to(dtype)
        v, i = top_k(g, 2)
        vc, ic = top_k(g.cpu(), 2)
        assert torch.equal(i.cpu(), ic)
        assert torch.equal(v.cpu(), vc)


def test_dispatch_mask_on_the_card_equals_the_cpu(gen):
    """Capacity overflow (every token to expert 0 first) builds the same
    mask on the card as on the CPU, with no device assert from slots
    out of range (ops/moe.py builds it by comparison)."""
    from flexflow_tpu_torch.ops.moe import dispatch_mask

    assign = torch.randint(0, 4, (512, 2), generator=gen, device="cuda")
    assign[:, 0] = 0
    assign[:, 1] = torch.where(assign[:, 1] == 0, 1, assign[:, 1])
    m = dispatch_mask(assign, 4, 100)
    torch.cuda.synchronize()
    assert torch.equal(m.cpu(), dispatch_mask(assign.cpu(), 4, 100))
    assert m[:, 0].sum() == 100


def test_gather_backward_is_deterministic_on_the_card(gen):
    """The Gather op's backward sums repeated indices in a fixed order:
    two runs give the same bits, and torch's deterministic setting is
    the caller's again after each."""
    from flexflow_tpu_torch.ff_types import OperatorType
    from flexflow_tpu_torch.ops.registry import FwdCtx, get_op_def
    from flexflow_tpu_torch.ops.tensor_ops import GatherParams

    fwd = get_op_def(OperatorType.OP_GATHER).forward
    idx = torch.randint(0, 64, (4096, 256), generator=gen, device="cuda")
    cot = torch.randn(4096, 256, generator=gen, device="cuda")
    grads = []
    for _ in range(2):
        x = torch.randn(64, 256, generator=torch.Generator(
            device="cuda").manual_seed(1), device="cuda").requires_grad_()
        (y,) = fwd(GatherParams(0), {}, [x, idx], FwdCtx(training=True))
        (g,) = torch.autograd.grad((y * cot).sum(), [x])
        assert not torch.are_deterministic_algorithms_enabled()
        grads.append(g)
    assert torch.equal(grads[0], grads[1])


def _moe_cache_model(spd=1):
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import ActiMode, LossType

    m = FFModel(FFConfig(batch_size=16, seed=0, iterations_per_dispatch=spd))
    t = m.create_tensor((16, 32))
    t = m.cache(m.dense(t, 32, ActiMode.AC_MODE_RELU), num_batches=2)
    t = m.moe(t, 4, 2, 16, alpha=1.0, lambda_bal=0.5)
    m.softmax(m.dense(t, 4))
    m.compile(SGDOptimizer(lr=0.05),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return m


def test_scan_with_cache_and_balance_loss_equals_stepwise_on_the_card(gen):
    """A Cache op (its buffers updated in place by the captured graph)
    feeding an MoE layer (the balance loss in every captured step, tokens
    dropped by capacity): fit with iterations_per_dispatch 3 over 7
    batches against stepwise fit, weights and buffers bit for bit."""
    rng = np.random.RandomState(5)
    x = rng.randn(112, 32).astype(np.float32)
    y = rng.randint(0, 4, (112, 1)).astype(np.int32)
    a, b = _moe_cache_model(), _moe_cache_model(spd=3)
    a.fit(x, y, epochs=2)
    b.fit(x, y, epochs=2)
    for tree in ("params", "net_state"):
        ta, tb = getattr(a.state, tree), getattr(b.state, tree)
        assert ta
        for op in ta:
            for n in ta[op]:
                assert torch.equal(ta[op][n], tb[op][n]), f"{tree} {op}.{n}"
    (bufs,) = b.state.net_state.values()
    assert float(bufs["filled"]) == 1.0


def _assert_norm_close(got, ref):
    """||got - ref|| / ||ref|| under FLASH_NORM_TOL, a limit no scale of
    the values moves."""
    err = ka.rel_norm_err(got, ref)
    assert err <= ka.FLASH_NORM_TOL[got.dtype], f"||err||/||ref|| {err}"


def test_flash_at_a_long_length_matches_chunked_attention(gen):
    """local_attention on the card takes the flash kernels (wgmma) at
    8192 positions; the forward against chunked_attention on the same
    bf16 values in f32 (the flash limit: chunked keeps P in f32, which
    the limit's P term covers), and the backward, with dO live on one
    block of 128 queries (every other row's dS is then exactly 0), against
    the plain backward over that block under the derived limit. At this
    length |O| ~ sqrt(e / 8192) and |dv| ~ 2e-3, under the limits' atol,
    so every output is also held by the norm of its error
    (FLASH_NORM_TOL), and the live dO is scaled by 2^10 (exact in bf16;
    the backward's products and roundings scale with it), which puts dk
    and dv near 1, where the derived limit's rtol and slack decide."""
    b, s, h, d = 1, 8192, 2, 64
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    before = dict(build.path_counts)
    out = ka.local_attention(q, k, v, causal=False)
    ref = ka.chunked_attention(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert build.path_counts["flash_fwd_wgmma"] == \
        before["flash_fwd_wgmma"] + 1
    _assert_close(out, ref, "flash")
    _assert_norm_close(out, ref)
    qf, kf, vf = (ka._bhsd_to_fold(x).contiguous() for x in (q, k, v))
    o, lse = ka._flash_fwd_cuda(qf, kf, vf, causal=False)
    do = torch.zeros_like(o)
    rows = slice(4096, 4096 + 128)
    do[:, rows] = _randn(gen, b * h, 128, d) * 2.0 ** 10
    got = ka._flash_bwd_cuda(qf, kf, vf, o, lse, do, causal=False)
    torch.cuda.synchronize()
    ins = (qf[:, rows].contiguous(), kf, vf, o[:, rows].contiguous(),
           lse[:, :, rows].contiguous(), do[:, rows].contiguous())
    ref = ka.flash_bwd_plain(*ins, causal=False)
    assert not got[0][:, :4096].any() and not got[0][:, 4096 + 128:].any()
    got = (got[0][:, rows], got[1], got[2])
    _assert_bwd_close(got, ref, ins, causal=False)
    for g, r in zip(got, ref):
        _assert_norm_close(g, r)


def _nmt(spd):
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType
    from flexflow_tpu_torch.models import build_nmt

    m = FFModel(FFConfig(batch_size=8, seed=0, iterations_per_dispatch=spd))
    build_nmt(m, 8, src_vocab=64, tgt_vocab=64, src_len=6, tgt_len=5,
              embed_dim=16, hidden=32, num_layers=2)
    m.compile(SGDOptimizer(lr=0.1),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return m


def test_lstm_in_a_captured_scan_equals_stepwise_on_the_card(gen):
    """NMT's five LSTMs (their step loops captured in the scan's CUDA
    graph): fit with iterations_per_dispatch 2 over 5 batches against
    stepwise fit, every weight bit for bit."""
    rng = np.random.RandomState(6)
    xs = [rng.randint(0, 64, (40, n)).astype(np.int32) for n in (6, 5)]
    y = rng.randint(0, 64, (40, 5, 1)).astype(np.int32)
    a, b = _nmt(1), _nmt(2)
    a.fit(xs, y, epochs=2)
    b.fit(xs, y, epochs=2)
    assert b.executor._scan_graphs
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n]), f"{op}.{n}"


# the H100 SXM's published peaks (dense bf16, HBM3), the search's
# H100_SPEC (search/machine_model.py)
H100_BF16_FLOP_PER_S, H100_BYTES_PER_S = 989e12, 3.35e12


def test_measured_attention_runs_the_flash_kernels_above_its_bound(gen):
    """The measured mode's MHA forward and forward-with-backward
    (search/measure.py: R calls captured in a CUDA graph, R against 4R)
    are positive, not below the roofline bound of what the call moves and
    computes, and launch flash_fwd and flash_bwd on the wgmma path and no
    other."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.pcg.lowering import layers_to_pcg
    from flexflow_tpu_torch.pcg.machine_view import MachineView
    from flexflow_tpu_torch.search.cost_model import op_flops
    from flexflow_tpu_torch.search.measure import OperatorMeasurer

    m = FFModel(FFConfig(batch_size=4))
    x = m.create_tensor((4, 256, 512))
    m.multihead_attention(x, x, x, 512, 8)
    (op,) = layers_to_pcg(m.layers)[0].ops
    meas = OperatorMeasurer(repeats=10, device="cuda",
                            compute_dtype=torch.bfloat16)
    build.reset_launch_counts()
    fwd, bwd = meas(op, MachineView())
    torch.cuda.synchronize()
    rec = next(iter(meas.measurements.values()))
    flops = op_flops(op)
    fwd_bound = max(rec.fwd_bytes / H100_BYTES_PER_S,
                    flops / H100_BF16_FLOP_PER_S)
    total_bound = max((rec.fwd_bytes + rec.grad_bytes) / H100_BYTES_PER_S,
                      3 * flops / H100_BF16_FLOP_PER_S)
    assert fwd > 0 and bwd > 0 and not meas.fallbacks
    assert fwd >= fwd_bound, (fwd, fwd_bound)
    assert rec.total_s >= total_bound, (rec.total_s, total_bound)
    assert build.path_counts["flash_fwd_wgmma"] > 0
    assert build.path_counts["flash_bwd_wgmma"] > 0
    assert all(c == 0 for k, c in build.path_counts.items()
               if k.startswith("flash") and not k.endswith("wgmma"))


def test_measured_search_compile_trains_on_the_card(gen):
    """compile(search_budget >= 0) with measure_operator_costs on the
    card: every op priced from a measurement, the winner trains."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType
    from flexflow_tpu_torch.models import build_transformer

    m = FFModel(FFConfig(batch_size=4, search_budget=2,
                         measure_operator_costs=True,
                         allow_mixed_precision=True))
    build_transformer(m, 4, 128, 256, 4, 2)
    m.compile(SGDOptimizer(lr=0.01),
              LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert m.searched_cost > 0 and not m.measurer.fallbacks
    assert m.searched_op_costs and all(
        e["measured"] and e["measurement"] is not None
        for e in m.searched_op_costs)
    x = np.random.RandomState(0).randn(4, 128, 256).astype(np.float32)
    m.fit(x, x, epochs=2)
    assert all(torch.isfinite(w).all() for ws in m.params.values()
               for w in ws.values())


def _seq2seq(src=16, dec=16, vocab=89, d=64, heads=4, layers=2, batch=4,
             mixed=True):
    """A small post-LN encoder-decoder (Transformer (big)'s graph at width
    64: sinusoidal position constants, cross-attention) on the card."""
    import math

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.ff_types import ActiMode, AggrMode, DataType

    def table(n):
        ang = np.arange(n)[:, None] / np.power(
            10000.0, 2 * np.arange(d // 2)[None, :] / d)
        out = np.zeros((1, n, d), np.float32)
        out[0, :, 0::2], out[0, :, 1::2] = np.sin(ang), np.cos(ang)
        return out

    m = FFModel(FFConfig(batch_size=batch, allow_mixed_precision=mixed))
    s = m.create_tensor((batch, src), DataType.DT_INT32)
    g = m.create_tensor((batch, dec), DataType.DT_INT32)

    def embed(ids, n):
        e = m.scalar_multiply(m.embedding(ids, vocab, d, AggrMode.AGGR_MODE_NONE),
                              math.sqrt(d))
        return m.add(e, m.create_constant_tensor(table(n), DataType.DT_FLOAT))

    def ffn(x):
        f = m.dense(x, 2 * d, ActiMode.AC_MODE_RELU)
        return m.layer_norm(m.add(x, m.dense(f, d)))

    e = embed(s, src)
    for _ in range(layers):
        e = ffn(m.layer_norm(m.add(e, m.multihead_attention(e, e, e, d,
                                                            heads))))
    x = embed(g, dec)
    for _ in range(layers):
        x = m.layer_norm(m.add(x, m.multihead_attention(x, x, x, d, heads,
                                                        causal=True)))
        x = m.layer_norm(m.add(x, m.multihead_attention(x, e, e, d, heads)))
        x = ffn(x)
    m.dense(x, vocab)
    m.compile()
    return m


def _count_captures(monkeypatch):
    from flexflow_tpu_torch.parallel import executor

    captures = []
    real = executor._DecodeGraph.capture

    def capture(self, fn):
        captures.append(self)
        return real(self, fn)

    monkeypatch.setattr(executor._DecodeGraph, "capture", capture)
    return captures


def test_decode_replays_across_two_cache_sets(gen):
    """Two source batches' caches alive at once, stepped in turns: each
    replay reads its own cache set's encoder K/V and position rows (the
    graph key holds every cache tensor), so each equals the eager steps
    on fresh caches; incremental_seq2seq_generate on two sources in a row
    equals its eager steps."""
    from flexflow_tpu_torch.runtime.serving import \
        incremental_seq2seq_generate

    m = _seq2seq()
    rng = np.random.RandomState(6)
    srcs = [rng.randint(0, 89, (4, 16)).astype(np.int32) for _ in range(2)]
    dec = rng.randint(0, 89, (4, 16)).astype(np.int32)
    init, step = m.executor.build_decode(4, 16)
    sets = [init(m.params, [s]) for s in srcs]
    eager = [init(m.params, [s]) for s in srcs]
    for t in range(6):
        pos = np.full(4, t, np.int32)
        for c, e in zip(sets, eager):
            got = step(m.params, c, pos, [dec[:, t:t + 1]])[0].clone()
            want = step(m.params, e, pos, [dec[:, t:t + 1]], _eager=True)[0]
            torch.testing.assert_close(got, want)
    toks = [incremental_seq2seq_generate(m, s, max_new_tokens=12)
            for s in srcs]
    assert not np.array_equal(toks[0], toks[1])
    for s, tk in zip(srcs, toks):
        np.testing.assert_array_equal(tk, incremental_seq2seq_generate(
            m, s, max_new_tokens=12, _eager=True))


def test_beam_reorder_in_place_keeps_replaying_one_graph(gen, monkeypatch):
    """incremental_beam_generate gathers the per-beam caches into the same
    tensors: one sample's 11 one-token steps capture one graph and replay
    it, and the beams equal the eager steps'."""
    from flexflow_tpu_torch.runtime.serving import incremental_beam_generate

    m = _seq2seq()
    src = np.random.RandomState(7).randint(0, 89, (1, 16)).astype(np.int32)
    starts = np.zeros((1, 1), np.int32)
    captures = _count_captures(monkeypatch)
    got = incremental_beam_generate(m, starts, num_beams=4,
                                    max_new_tokens=12, max_len=16,
                                    encoder_ids=src)
    assert len(captures) == 1
    want = incremental_beam_generate(m, starts, num_beams=4,
                                     max_new_tokens=12, max_len=16,
                                     encoder_ids=src, _eager=True)
    np.testing.assert_array_equal(got, want)


def test_per_row_prefix_writes_under_capture(gen):
    """Primitive-op attention (batch_matmul, a baked tril mask, softmax,
    batch_matmul) with its prefix caches: rows at different positions
    write their own cache positions inside the captured step, and the
    replayed logits equal the eager steps' and the full forward's."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.ff_types import AggrMode, DataType

    n, e = 16, 32
    m = FFModel(FFConfig(batch_size=4))
    ids = m.create_tensor((4, n), DataType.DT_INT32)
    x = m.embedding(ids, 50, e, AggrMode.AGGR_MODE_NONE)
    s = m.batch_matmul(x, m.transpose(x, (0, 2, 1)))
    mask = np.where(np.tril(np.ones((n, n), bool)), 0.0, -1e9)
    s = m.add(s, m.create_constant_tensor(mask[None].astype(np.float32),
                                          DataType.DT_FLOAT))
    m.dense(m.batch_matmul(m.softmax(s, axis=-1), x), 50)
    m.compile()
    xs = np.random.RandomState(8).randint(0, 50, (4, n)).astype(np.int32)
    full = m.executor.build_forward()(m.params, [xs])
    init, step = m.executor.build_decode(4, n)
    cap, eag = init(m.params), init(m.params)
    # one token a step from position 0, row i held back i steps (it
    # rewrites position 0 with the same token until it starts): every
    # step's rows sit at different positions
    rows = np.arange(4)
    for k in range(n + 3):
        pos = np.clip(k - rows, 0, n - 1).astype(np.int32)
        tok = xs[rows, pos][:, None]
        got = step(m.params, cap, pos, [tok])[0].clone()
        want = step(m.params, eag, pos, [tok], _eager=True)[0]
        torch.testing.assert_close(got, want)
        torch.testing.assert_close(got[:, 0], full[rows, pos], atol=1e-4,
                                   rtol=1e-4)
    for g in cap["prefix"]:
        torch.testing.assert_close(cap["prefix"][g], eag["prefix"][g])


def test_a_dropped_models_graphs_do_not_break_a_capture(gen):
    """A dropped model's captured graphs sit in a reference cycle (an
    executor and its graphs) until Python's cycle collector runs; run
    while another capture is open, their destruction would invalidate
    it. With the collector at its most eager, a scan still captures and
    leaves the stepwise weights."""
    import gc

    from flexflow_tpu_torch.runtime.serving import incremental_generate

    for _ in range(2):
        m = _lm()
        incremental_generate(m, np.zeros((4, 3), np.int32),
                             max_new_tokens=4, max_len=64)
        del m
    x, y = _drop_data(n=6)
    a = _drop_model(spd=1)
    a.fit(x, y, epochs=1)
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        b = _drop_model(spd=3)
        b.fit(x, y, epochs=1)
    finally:
        gc.set_threshold(*old)
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n]), f"{op}.{n}"


# -- the step guard and checkpoint restore on the card ----------------------
def _guard_pair(adam):
    """The same f32 MHA model on the card and on the CPU (same weights),
    SGD with momentum or Adam, the step guard armed at scale 4."""
    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                    SGDOptimizer)
    from flexflow_tpu_torch.ff_types import LossType
    from flexflow_tpu_torch.runtime.resilience import StepGuardConfig

    def make(device):
        m = FFModel(FFConfig(batch_size=2, device=device, seed=0))
        x = m.create_tensor((2, 24, 40))
        t = m.multihead_attention(x, x, x, 40, 4, causal=True)
        m.dense(t, 40)
        m.compile(AdamOptimizer(alpha=0.01) if adam
                  else SGDOptimizer(lr=0.01, momentum=0.9),
                  LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
        m.executor.set_step_guard(StepGuardConfig(init_loss_scale=4.0,
                                                  growth_interval=2))
        m.state.guard = m.executor.init_guard_state()
        return m

    gm, cm = make("cuda"), make("cpu")
    for op, ws in gm.params.items():
        for n, w in ws.items():
            cm.params[op][n].copy_(w.cpu())
    return gm, cm


def _state_tensors(m):
    from flexflow_tpu_torch.parallel.executor import _tensors

    return _tensors((m.state.params, m.state.opt_state,
                     m.state.guard.as_dict()))


@pytest.mark.parametrize("adam", [False, True])
def test_guarded_steps_on_the_card_match_the_cpu(gen, adam):
    """Guarded steps on the card (good, poisoned, good, good) against the
    same steps on the CPU: the guard's counters equal, the weights and
    optimizer state within f32 summation order (1e-5), and the poisoned
    step leaves every weight and optimizer slot on the card (Adam's
    beta_t too) bit for bit as it was."""
    gm, cm = _guard_pair(adam)
    rng = np.random.RandomState(2)
    steps = {m: m.executor.build_train_step() for m in (gm, cm)}
    for i, poisoned in enumerate((False, True, False, False)):
        x = rng.randn(2, 24, 40).astype(np.float32)
        y = rng.randn(2, 24, 40).astype(np.float32)
        before = [t.clone() for t in _state_tensors(gm)]
        for m in (gm, cm):
            poison = torch.full((), float("nan") if poisoned else 1.0,
                                device=m.executor.device)
            m.state, _ = steps[m](m.state, [x], y, None, poison)
        torch.cuda.synchronize()
        g, c = _state_tensors(gm), _state_tensors(cm)
        for a, b in zip(g[-4:], c[-4:]):
            assert a.item() == b.item(), f"step {i}: guard"
        if poisoned:
            for t, old in zip(g[:-4], before[:-4]):
                assert torch.equal(t, old), f"step {i}"
        for a, b in zip(g[:-4], c[:-4]):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-5, atol=1e-5)
    assert gm.state.guard.loss_scale.item() == 4.0
    assert gm.state.guard.total_skips.item() == 1


def test_a_restore_keeps_the_captured_scan_graph(gen, tmp_path):
    """A restore writes into the live tensors: the train scan's graph,
    keyed by their addresses, replays without a new capture (the launch
    counts take no warm-up), and the weights it trains equal those of a
    fresh model restored from the same checkpoint."""
    from flexflow_tpu_torch.runtime.checkpoint import (restore_checkpoint,
                                                       save_checkpoint)

    x, y = _drop_data(8)
    m = _drop_model(spd=2)
    path = str(tmp_path / "ck")
    save_checkpoint(m, path)
    m.fit(x, y, verbose=False)
    rng_state = m._rng.get_state()
    restore_checkpoint(m, path)
    build.reset_launch_counts()
    m.fit(x, y, verbose=False)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_fwd_dropout"] == 4
    fresh = _drop_model(spd=2, seed=1)
    restore_checkpoint(fresh, path)
    fresh._rng.set_state(rng_state)
    fresh.fit(x, y, verbose=False)
    for op, ws in m.params.items():
        for n, w in ws.items():
            assert torch.equal(w, fresh.params[op][n]), f"{op}.{n}"


def test_a_restored_model_serves_through_its_captured_decode_graph(
        gen, tmp_path):
    """A model that served (its decode graph captured on its weights and
    their bf16 copies), restored from another model's checkpoint, replays
    that graph on the restored weights: its tokens equal a fresh model's
    eager steps on the checkpoint's weights."""
    from flexflow_tpu_torch.runtime.checkpoint import (restore_checkpoint,
                                                       save_checkpoint)
    from flexflow_tpu_torch.runtime.serving import incremental_generate

    prompts = np.random.RandomState(8).randint(0, 97, (4, 9)) \
        .astype(np.int32)
    m = _lm()
    first = incremental_generate(m, prompts, max_new_tokens=12, max_len=64)
    other = _lm(seed=1)
    path = str(tmp_path / "other")
    save_checkpoint(other, path)
    restore_checkpoint(m, path)
    got = incremental_generate(m, prompts, max_new_tokens=12, max_len=64)
    fresh = _lm(seed=2)
    restore_checkpoint(fresh, path)
    want = incremental_generate(fresh, prompts, max_new_tokens=12,
                                max_len=64, _eager=True)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, first)


def _observatory_model(layers=2):
    """A 2-block flagship Transformer in bf16 on the card (MSE, SGD with
    momentum), and a batch for it."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType
    from flexflow_tpu_torch.models import build_transformer

    m = FFModel(FFConfig(batch_size=4, allow_mixed_precision=True))
    build_transformer(m, 4, 128, 256, 4, layers)
    m.compile(SGDOptimizer(lr=0.01, momentum=0.9),
              LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 128, 256).astype(np.float32)
    return m, x


def test_cuda_trace_attributes_flash_kernels_to_their_ops(gen):
    """mode "auto" on the card is "cuda_trace": each MHA op's flash
    forward kernel lands under its name, its flash backward under
    <name>.bwd, and most of the step's device time is attributed."""
    from flexflow_tpu_torch import obs

    m, x = _observatory_model()
    m.fit(x, x, verbose=False)
    prof = obs.capture_step_profile(m, x, x, batch_size=4, repeats=1)
    assert prof.mode == "cuda_trace" and prof.backend == "cuda"
    assert prof.attributed_share >= 0.9, prof.summary()
    mha = [op.name for op in m.executor.topo
           if op.op_type.name == "OP_MULTIHEAD_ATTENTION"]
    assert len(mha) == 2
    for name in mha:
        fwd = [e["args"]["kernel"] for e in prof.events if e["name"] == name]
        bwd = [e["args"]["kernel"] for e in prof.events
               if e["name"] == name + ".bwd"]
        assert any("flash_fwd" in k for k in fwd), fwd
        assert any("flash_bwd" in k for k in bwd), bwd
    assert any(e["name"] == "optimizer" and e["tid"] == 1
               for e in prof.events)


def test_hbm_sampler_reads_the_allocator(gen):
    from flexflow_tpu_torch.obs.step_profile import HbmSampler

    s = HbmSampler(torch.device("cuda"))
    assert s.source == "memory_stats"
    t = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    peak = s.sample()[s.index]
    assert peak >= t.numel()
    del t


def test_time_train_step_leaves_weights_momentum_and_generator(gen):
    from flexflow_tpu_torch.parallel.executor import _tensors

    m, x = _observatory_model(layers=1)
    m.fit(x, x, verbose=False)
    live = _tensors((m.state.params, m.state.opt_state))
    before = [t.clone() for t in live]
    rng = m._rng.get_state().clone()
    wall = m.executor.time_train_step(m.state, [x[:4]], x[:4], repeats=2)
    assert wall > 0
    assert all(torch.equal(a, b) for a, b in zip(before, live))
    assert torch.equal(rng, m._rng.get_state())


def test_determinism_canary_passes_on_the_flash_kernels(gen):
    """A 2-block bf16 Transformer's determinism canary re-executes every
    step through both flash kernels (on wgmma) and finds every weight's
    bytes equal; the canaried fit is bit-equal to an uncanaried one."""
    from flexflow_tpu_torch import CanaryConfig, FaultInjector
    from flexflow_tpu_torch.parallel.executor import _tensors

    a, x = _observatory_model()
    b, _ = _observatory_model()
    build.reset_launch_counts()
    a.fit(x, x, verbose=False, canary=CanaryConfig(every_n_steps=1))
    assert build.path_counts["flash_fwd_wgmma"] > 0
    assert build.path_counts["flash_bwd_wgmma"] > 0
    b.fit(x, x, verbose=False, fault_injector=FaultInjector())
    assert all(torch.equal(p, q) for p, q in zip(
        _tensors((a.state.params, a.state.opt_state)),
        _tensors((b.state.params, b.state.opt_state))))


def test_native_library_builds_under_build_not_the_jax_package(gen):
    """The native simulator and data loader build from the port's own
    sources into build/native, and nothing is written or loaded under
    flexflow_tpu/native."""
    import pathlib

    from flexflow_tpu_torch import native

    repo = pathlib.Path(__file__).resolve().parent.parent
    jax_dir = repo / "flexflow_tpu" / "native"
    before = sorted(p.name for p in jax_dir.iterdir()) \
        if jax_dir.exists() else []
    assert native.available()
    path = native.lib_path()
    assert path.parent == repo / "build" / "native" and path.exists()
    assert (sorted(p.name for p in jax_dir.iterdir())
            if jax_dir.exists() else []) == before
    maps = open("/proc/self/maps").read()
    assert str(path) in maps
    assert "/flexflow_tpu/native/" not in maps
