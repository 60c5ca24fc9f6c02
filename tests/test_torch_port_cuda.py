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
  * flash backward, 16-bit: both versions round P and dS to the input
    dtype before their products; where the kernel's f32 scores (summed in
    another order) put an element on the other side of a rounding
    boundary it moves by one step of its dtype, times |dO|, |q| or |k|
    (atol 3e-3 in bf16, 5e-4 in fp16), and the output may round one step
    apart (rtol 2^-7 in bf16, 2^-10 in fp16);
  * flash backward, f32: summation order only (atol 2e-6, rtol 1e-5).
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
       "flash_f32": (1e-5, 1e-5), "flash_bwd": (3e-3, BF16_STEP),
       "flash_bwd_f16": (5e-4, 2.0 ** -10), "flash_bwd_f32": (2e-6, 1e-5)}
LSE_ATOL = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _assert_close(out, ref, which):
    atol, rtol = TOL[which]
    err = (out.float() - ref.float()).abs()
    lim = atol + rtol * ref.float().abs()
    assert bool((err <= lim).all()), \
        f"{which}: max err {err.max().item()}, worst err/limit " \
        f"{(err / lim).max().item()}"


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
    which = {torch.float32: "flash_bwd_f32", torch.float16: "flash_bwd_f16",
             torch.bfloat16: "flash_bwd"}[dtype]
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        _assert_close(g, r, which)
    if causal and sk > sq:
        assert not got[1][:, sq:].any() and not got[2][:, sq:].any()
    # two passes, no atomics: the same inputs give the same bits
    again = ka._flash_bwd_folded(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_matches_plain_on_a_strided_cache_view(gen, dtype):
    kc = _randn(gen, 3, 64, 4, 64, dtype=dtype)
    vc = _randn(gen, 3, 64, 4, 64, dtype=dtype)
    kp, vp, table = kd.paged_view_of_cache(kc, vc, 16)
    q = _randn(gen, 3, 4, 64, dtype=dtype)
    lengths = torch.tensor([1, 30, 64], dtype=torch.int32, device="cuda")
    out = kd.paged_flash_decode(q, kp, vp, table, lengths)
    ref = kd.paged_decode_plain(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    _assert_close(out, ref, "paged")


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
    out = gm.forward([ids])
    torch.cuda.synchronize()
    assert build.launch_counts["flash_fwd"] == before + 1
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.cpu().numpy(), cm.forward([ids]).numpy(),
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
        gm.forward([x])
    monkeypatch.setenv("FF_ATTENTION_IMPL", "ring")
    with pytest.raises(NotImplementedError):
        gm.executor.build_grad_step()(gm.params, [x], x)
