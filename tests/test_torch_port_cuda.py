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
  * lse is f32 in both: 1e-5.
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
       "flash_f32": (1e-5, 1e-5)}
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
