"""The derived limit of the 16-bit flash backward checks, on the CPU.

A backward kernel and `flash_bwd_plain` both round dS and the P of dV to
the input dtype before their products; the kernel sums S and dP in
another order, so where an element lies at a rounding boundary the two
round it to different sides. `flash_bwd_slack` allows two such flips per
row at the row's largest step, on top of `FLASH_BWD_TOL`. Here a plain
backward whose S and dP are summed in float64 (then rounded to f32) plays
the kernel: it must stay inside the limit, and each wiring fault a
kernel could carry (a lost 1/sqrt(d), dk and dv swapped, lse shifted by
0.1, one mask element flipped) must break it.
"""
import math

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.kernels import attention as ka

BF16 = torch.bfloat16
SEEDS = (0x9E3779B9, 0x01234567)
BH, D = 8, 64

# (causal, dropout rate, sq, sk): bf16, bh 8, the sequence lengths the
# main paths use and ragged ones; the last is the bf16 causal dropout
# edge that read err/limit 1.27 on the card under the old limit
CASES = [(False, 0.0, 128, 128), (True, 0.0, 256, 256),
         (False, 0.1, 256, 512), (True, 0.1, 512, 512)]
MUTATIONS = ("lost_scale", "dk_dv_swapped", "lse_shifted", "mask_flipped")


def _inputs(causal, rate, sq, sk, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(BH, n, D).astype(np.float32))
                   .to(BF16) for n in (sq, sk, sk, sq))
    o, lse = ka.flash_fwd_plain(q, k, v, causal=causal, dropout=rate,
                                seeds=SEEDS)
    return q, k, v, o, lse, do


def _backward(q, k, v, o, lse, do, causal, rate, *, f64=False,
              mutation=None):
    """`flash_bwd_plain`'s arithmetic, with S and dP optionally summed in
    float64 and rounded to f32 (another summation order, as a kernel's),
    and optionally one wiring fault."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    wide = (lambda a, b: torch.matmul(a.double(), b.double()).float()) \
        if f64 else torch.matmul
    delta = (do32 * o.float()).sum(-1, keepdim=True)
    s = wide(q32, k32.transpose(1, 2)) * scale
    sq, sk = s.shape[-2:]
    visible = torch.ones(sq, sk, dtype=torch.bool).tril() if causal \
        else torch.ones(sq, sk, dtype=torch.bool)
    s = s.masked_fill(~visible, ka.NEG_INF)
    shift = 0.1 if mutation == "lse_shifted" else 0.0
    p = torch.exp(s - (lse + shift).transpose(1, 2))
    dp = wide(do32, v32.transpose(1, 2))
    keep = ka.attention_dropout_mask(SEEDS, rate, *p.shape) if rate > 0.0 \
        else torch.ones(p.shape, dtype=torch.bool)
    if mutation == "mask_flipped":
        # the visible, kept element that carries the most probability
        # becomes masked (causal) or dropped (dropout)
        at = torch.where(keep & visible, p, -1.0).argmax()
        flat = keep.flatten().clone()
        flat[at] = False
        keep = flat.view(keep.shape)
        if rate == 0.0:
            p = torch.where(keep, p, 0.0)
    pb = p
    if rate > 0.0:
        inv_keep = 1.0 / (1.0 - rate)
        dp = torch.where(keep, dp * inv_keep, 0.0)
        pb = torch.where(keep, p * inv_keep, 0.0)
    ds = (p * (dp - delta)).to(dt).float()
    sc = 1.0 if mutation == "lost_scale" else scale
    dq = torch.matmul(ds, k32) * sc
    dk = torch.matmul(ds.transpose(1, 2), q32) * sc
    dv = torch.matmul(pb.to(dt).float().transpose(1, 2), do32)
    out = [dq.to(dt), dk.to(dt), dv.to(dt)]
    if mutation == "dk_dv_swapped":
        out[1], out[2] = out[2], out[1]
    return out


def _worst_over_limit(got, ref, slack, dtype=BF16):
    """The largest err / limit over dq, dk, dv (<= 1 is inside)."""
    atol, rtol = ka.FLASH_BWD_TOL[dtype]
    return max(((a.float() - b.float()).abs()
                / (atol + rtol * b.float().abs() + s)).max().item()
               for a, b, s in zip(got, ref, slack))


@pytest.mark.parametrize("causal,rate,sq,sk", CASES)
def test_the_unfaulted_copy_is_the_plain_backward(causal, rate, sq, sk):
    ins = _inputs(causal, rate, sq, sk)
    ref = ka.flash_bwd_plain(*ins, causal=causal, dropout=rate, seeds=SEEDS)
    got = _backward(*ins, causal, rate)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("causal,rate,sq,sk", CASES)
def test_another_summation_order_stays_inside_the_limit(causal, rate, sq,
                                                          sk):
    ins = _inputs(causal, rate, sq, sk)
    kw = dict(causal=causal, dropout=rate, seeds=SEEDS)
    ref = ka.flash_bwd_plain(*ins, **kw)
    slack = ka.flash_bwd_slack(*ins, **kw)
    got = _backward(*ins, causal, rate, f64=True)
    assert any(not torch.equal(a, b) for a, b in zip(got, ref)), \
        "the f64 sums changed no rounding: the check tests nothing"
    assert _worst_over_limit(got, ref, slack) <= 1.0


@pytest.mark.parametrize("causal,rate,sq,sk,mutation", [
    c + (m,) for c in CASES for m in MUTATIONS
    if not (m == "mask_flipped" and not c[0] and c[1] == 0.0)])
def test_each_wiring_fault_breaks_the_limit(causal, rate, sq, sk, mutation):
    ins = _inputs(causal, rate, sq, sk)
    kw = dict(causal=causal, dropout=rate, seeds=SEEDS)
    ref = ka.flash_bwd_plain(*ins, **kw)
    slack = ka.flash_bwd_slack(*ins, **kw)
    got = _backward(*ins, causal, rate, f64=True, mutation=mutation)
    assert _worst_over_limit(got, ref, slack) > 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ulp_is_the_dtype_step(dtype):
    x = torch.tensor([1.0, 1.5, 3.0, 0.4, 1e-3, 8.0, 0.0])
    step = ka._ulp(x, dtype)
    up = torch.nextafter(x.to(dtype), torch.tensor(np.inf, dtype=dtype))
    want = torch.where(x != 0, (up.float() - x.to(dtype).float()), 0.0)
    torch.testing.assert_close(step, want, rtol=0, atol=0)


def test_slack_grows_with_the_largest_ds_step_of_the_row():
    """Scaling dO by 2^k scales dP, delta, dS, its steps and so the
    slack by 2^k: the slack follows the data, as a fixed atol cannot."""
    ins = _inputs(True, 0.0, 128, 128)
    base = ka.flash_bwd_slack(*ins, causal=True)
    q, k, v, o, lse, do = ins
    scaled = ka.flash_bwd_slack(q, k, v, o, lse, do * 8, causal=True)
    for a, b in zip(base, scaled):
        torch.testing.assert_close(b, a * 8, rtol=0, atol=0)
    assert (base[0] > 0).any() and (base[2] > 0).any()
