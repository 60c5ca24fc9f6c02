#!/usr/bin/env python3
"""Drive flexflow_tpu_torch's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (PATH or $CUDA_HOME/bin); imports nothing
of JAX. Phases, each of which must pass or the script exits non-zero:

  1. build every CUDA kernel of the package from csrc/ (one nvcc each,
     all at once) into build/kernels/;
  2. kernels: each kernel against its plain PyTorch version on the card,
     in bf16 at the shapes the serving and training paths give it (and at
     edge shapes, in fp16 and f32 too), timed beside its plain version,
     its library counterpart where one exists, and its least possible
     time on an H100 (the bound);
  3. serving: the full-width causal LM (GPT-2 vocab 50257, width 1024, 12
     blocks of causal MHA with 16 heads of 64 + dense RELU + dense, bf16
     compute over f32 weights, max_len 512, 8 slots, 16-token pages) with
     random weights from a seed, through incremental_generate, the full
     forward (the flash kernel) as the oracle of the KV-cached logits, and
     a ContinuousBatcher answering ragged requests, each held against
     incremental_generate on its prompt;
  4. training: the flagship Transformer (models/transformer.py: batch 8,
     seq 512, hidden 1024, 12 blocks of non-causal MHA with 16 heads of 64
     + dense RELU + dense, bias-free dense) with bf16 compute and bf16
     gradients over f32 weights, MSE loss, SGD at lr 0.01, random weights
     and data from seed 0 (bench.py's default workload). `FFModel.fit`
     takes a few steps on one batch (the loss must fall); then, with the
     weights rescaled to unit activations, `build_grad_step` through the
     flash kernels is held against the same step through the dense
     attention path (FF_ATTENTION_IMPL=dense), weight by weight.

Launch counts are reset just before each path is driven and read just
after it. Prints the card's name and power limit, a `kernels` JSON line,
a `serving` and a `training` JSON line and, last, {"ok": true, "device":
{...}}. Details go to chiprun_out/chip_smoke.json.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12

# Kernel vs plain on the card: every element must meet
# |kernel - plain| <= atol + rtol * |plain|. A bf16 output step is at most
# 2^-7 of the value.
BF16_STEP = 2.0 ** -7
TOL = {
    # both versions keep every step in f32 and round only the output: one
    # output step, plus f32 summation order
    "paged_decode": (1e-5, BF16_STEP),
    # 16-bit: the kernel rounds P at the running row maximum, the plain
    # version at the final one, so O moves by a few 2^-9 relative steps of
    # P averaged over the row (atol: one bf16 step at |O| ~ 1), plus one
    # output step
    "flash_fwd": (4e-3, BF16_STEP),
    # f32: nothing is rounded but the summation order
    "flash_fwd_f32": (1e-5, 1e-5),
    # backward, 16-bit: both versions round P and dS to the input dtype
    # before their products; where the kernel's f32 scores (summed in
    # another order) put an element on the other side of a rounding
    # boundary, it moves by one step of its dtype times |dO|, |q| or |k|
    # (atol: the worst bf16 reading is 2^-8 at a gradient of ~0.33, two
    # steps there; fp16 2^-11 below 1), and the output may round one step
    # apart (rtol: one bf16 / fp16 step)
    "flash_bwd": (3e-3, BF16_STEP),
    "flash_bwd_f16": (5e-4, 2.0 ** -10),
    # f32: summation order only, over up to 512 terms per output
    "flash_bwd_f32": (2e-6, 1e-5),
}
LSE_ATOL = 1e-5      # lse stays f32 in both
# The KV-cached logits against the full forward, on softmax outputs
# relative to their row's maximum. Through 12 layers each path rounds its
# activations (and P inside attention: the flash and dense paths round P
# to bf16, the paged kernel keeps it f32) to 8 significant bits at other
# places, so with unit-scale logits the outputs of the two paths differ by
# ~1.6% on average and by 3.36% at the worst of ~13M entries (this
# script's reading on an H100 80GB HBM3 at 700 W).
LOGIT_RTOL = 0.05

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN, SLOTS = 50257, 1024, 16, 12, 512, 8
# the training path: bench.py's default workload
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 4
# The gradient oracle, per weight: ||g_flash - g_dense|| over the norm of
# the op's dense gradient. Both steps round activations and gradients to
# bf16 at the op boundaries; inside attention the flash path rounds the
# unnormalised P and dS to bf16 and accumulates in f32, the dense path
# rounds the normalised probabilities and runs autograd's bf16 casts. The
# top block sees one attention's worth of those differences (a few 2^-9
# steps per element; the worst top-block reading is 0.025 of its op's
# norm); every block below adds its own, ~1% each, and carries the ones
# above on through its backward, so the gap grows with depth to 0.149 at
# the first block (readings on an H100 80GB HBM3, 700 W). The limits are
# twice those readings. A wiring fault (a lost scale, dq and dk swapped, a
# stale lse) moves a gradient by its own size.
ORACLE_RTOL = 0.3
ORACLE_TOP_RTOL = 0.05


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, flush=None):
    """Mean device time of fn() over `iters` launches, CUDA events around
    each; `flush` (run between launches, outside the timed span) evicts
    the L2 so each launch finds its operands cold, as the serving path
    does (each layer reads its own cache)."""
    import torch

    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def check_close(what, which, out, ref):
    """Hold `out` against `ref` under TOL[which]; returns the largest
    absolute error and the largest error over its limit (<= 1 passes)."""
    atol, rtol = TOL[which]
    err = (out.float() - ref.float()).abs()
    ratio = (err / (atol + rtol * ref.float().abs())).max().item()
    emax = err.max().item()
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: max err {emax}, worst err/limit "
                             f"{ratio} (atol {atol}, rtol {rtol})")
    return emax, ratio


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_flash(torch, rng_seed=0):
    from flexflow_tpu_torch.kernels import attention as ka

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    dev, bf16 = "cuda", torch.bfloat16
    worst = {"o": 0.0, "ratio": 0.0, "lse": 0.0}

    def one(bh, sq, sk, d, dv, causal, dtype=bf16):
        q = torch.randn(bh, sq, d, generator=g, device=dev).to(dtype)
        k = torch.randn(bh, sk, d, generator=g, device=dev).to(dtype)
        v = torch.randn(bh, sk, dv, generator=g, device=dev).to(dtype)
        o, lse = ka._flash_fwd_cuda(q, k, v, causal=causal)
        po, plse = ka.flash_fwd_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        what = (f"flash bh={bh} sq={sq} sk={sk} d={d} dv={dv} "
                f"causal={causal} {str(dtype)[6:]}")
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"{what}: non-finite")
        eo, ratio = check_close(what, "flash_fwd_f32" if dtype ==
                                torch.float32 else "flash_fwd", o, po)
        el = (lse - plse).abs().max().item()
        if not el <= LSE_ATOL:
            raise AssertionError(f"{what}: lse err {el} (tol {LSE_ATOL})")
        worst["lse"] = max(worst["lse"], el)
        if dtype != torch.float32:   # the serving dtypes' worst
            worst["o"] = max(worst["o"], eo)
            worst["ratio"] = max(worst["ratio"], ratio)
        log(f"  {what}: max|O-plain|={eo:.3g} (err/limit {ratio:.3g}) "
            f"max|lse-plain|={el:.3g}")
        return q, k, v

    # the serving shape: 8 rows x 16 heads, 512 x 512, d 64, causal
    q, k, v = one(128, 512, 512, 64, 64, True)
    qn, kn, vn = one(128, 512, 512, 64, 64, False)   # the training shape
    one(16, 512, 512, 64, 32, True)      # dv != d
    one(16, 512, 512, 64, 128, True)
    one(8, 100, 300, 64, 64, False)      # ragged, not multiples of a tile
    one(8, 300, 100, 128, 64, True)      # more queries than keys
    one(8, 64, 64, 64, 64, True, torch.float16)
    # the CUDA-core kernel: head dims not multiples of 16, and f32
    one(8, 200, 200, 40, 24, True)
    one(16, 512, 512, 64, 64, True, torch.float32)
    one(8, 90, 130, 20, 36, False, torch.float32)
    bh, s, d = 128, 512, 64
    t_k = time_ms(lambda: ka._flash_fwd_cuda(q, k, v, causal=True), 50)
    t_p = time_ms(lambda: ka.flash_fwd_plain(q, k, v, causal=True), 10)
    q4, k4, v4 = (x.view(1, bh, s, d) for x in (q, k, v))
    t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 50)
    pairs = bh * s * (s + 1) // 2            # causal (query, key) pairs
    flops = pairs * (2 * d + 2 * d)          # QK^T and PV
    nbytes = 2 * (3 * bh * s * d + bh * s * d) + 4 * bh * s
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  flash serving shape: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"SDPA {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # the training shape: the same operands, not causal
    tt_k = time_ms(lambda: ka._flash_fwd_cuda(qn, kn, vn, causal=False), 50)
    tt_p = time_ms(lambda: ka.flash_fwd_plain(qn, kn, vn, causal=False), 10)
    q4, k4, v4 = (x.view(1, bh, s, d) for x in (qn, kn, vn))
    tt_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4), 50)
    tb_ms, tb_by = bound_ms(nbytes, bh * s * s * (2 * d + 2 * d))
    log(f"  flash training shape: kernel {tt_k:.4f} ms, plain {tt_p:.4f} ms, "
        f"SDPA {tt_l:.4f} ms, bound {tb_ms:.4f} ms ({tb_by})")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "flexflow_tpu/kernels/attention.py:183",
            "max_abs_err": worst["o"], "err_over_limit": worst["ratio"],
            "tol": TOL["flash_fwd"], "lse_max_abs_err": worst["lse"],
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_l,
            "shape": "bh=128 sq=sk=512 d=dv=64 causal bf16, L2 warm",
            "training_shape": {
                "shape": "bh=128 sq=sk=512 d=dv=64 non-causal bf16, L2 warm",
                "ms": tt_k, "plain_ms": tt_p, "bound_ms": tb_ms,
                "bound_by": tb_by, "library_ms": tt_l}}


def check_flash_bwd(torch, rng_seed=2):
    from flexflow_tpu_torch.kernels import attention as ka

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    dev, bf16 = "cuda", torch.bfloat16
    which = {torch.bfloat16: "flash_bwd", torch.float16: "flash_bwd_f16",
             torch.float32: "flash_bwd_f32"}
    worst = {}   # tol name -> (max abs err, worst err/limit)

    def one(bh, sq, sk, d, dv, causal, dtype=bf16):
        q, k, do = (torch.randn(bh, n, c, generator=g, device=dev).to(dtype)
                    for n, c in ((sq, d), (sk, d), (sq, dv)))
        v = torch.randn(bh, sk, dv, generator=g, device=dev).to(dtype)
        o, lse = ka._flash_fwd_cuda(q, k, v, causal=causal)
        got = ka._flash_bwd_cuda(q, k, v, o, lse, do, causal=causal)
        ref = ka.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        what = (f"flash_bwd bh={bh} sq={sq} sk={sk} d={d} dv={dv} "
                f"causal={causal} {str(dtype)[6:]}")
        msg = []
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{what} {name}: non-finite")
            e, ratio = check_close(f"{what} {name}", which[dtype], a, b)
            w = worst.get(which[dtype], (0.0, 0.0))
            worst[which[dtype]] = (max(w[0], e), max(w[1], ratio))
            msg.append(f"{name} {e:.3g} ({ratio:.3g})")
        log(f"  {what}: max|grad-plain| (err/limit) " + ", ".join(msg))
        return q, k, v, o, lse, do

    # the training shape: 8 rows x 16 heads, 512 x 512, d 64, not causal
    q, k, v, o, lse, do = one(128, 512, 512, 64, 64, False)
    one(128, 512, 512, 64, 64, True)
    one(16, 512, 512, 64, 32, True)       # dv != d
    one(8, 100, 300, 64, 64, False)       # ragged, fewer queries than keys
    one(8, 300, 100, 128, 64, True)       # more queries than keys
    one(8, 200, 200, 256, 256, True)      # 2 warps a block
    one(8, 256, 256, 64, 64, True, torch.float16)
    # the CUDA-core kernels: f32, and head dims not multiples of 16
    one(16, 512, 512, 64, 64, True, torch.float32)
    one(8, 90, 130, 20, 36, False, torch.float32)
    one(8, 200, 200, 40, 24, True)
    bh, s, d = 128, 512, 64
    t_k = time_ms(lambda: ka._flash_bwd_cuda(q, k, v, o, lse, do,
                                             causal=False), 50)
    t_p = time_ms(lambda: ka.flash_bwd_plain(q, k, v, o, lse, do,
                                             causal=False), 5)
    # the yardstick: SDPA's backward alone, through autograd
    q4, k4, v4 = (x.view(TRAIN_BATCH, HEADS, s, d).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
    do4 = do.view(TRAIN_BATCH, HEADS, s, d)
    t_l = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                              retain_graph=True), 50)
    # five products of 2*bh*s*s*d; q, k, v, O, dO read, dq, dk, dv
    # written (bf16), lse read (f32)
    flops = 5 * 2 * bh * s * s * d
    nbytes = 2 * 8 * bh * s * d + 4 * bh * s
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  flash_bwd training shape: kernel {t_k:.4f} ms, plain {t_p:.4f} "
        f"ms, SDPA backward {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "flash_bwd", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "flexflow_tpu/kernels/attention.py:233",
            "max_abs_err": worst["flash_bwd"][0],
            "err_over_limit": worst["flash_bwd"][1],
            "tol": TOL["flash_bwd"],
            "by_dtype": {n: {"max_abs_err": e, "err_over_limit": r,
                             "tol": TOL[n]} for n, (e, r) in worst.items()},
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_l,
            "shape": "bh=128 sq=sk=512 d=dv=64 non-causal bf16, L2 warm; "
                     "library: scaled_dot_product_attention backward"}


def check_paged(torch, rng_seed=1):
    from flexflow_tpu_torch.kernels import decode as kd

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    dev, bf16 = "cuda", torch.bfloat16
    slots, h, d, page = SLOTS, HEADS, HIDDEN // HEADS, 16
    pp = MAX_LEN // page
    worst = {"e": 0.0, "ratio": 0.0}
    # ragged: a freshly admitted 1-token slot, mid lengths, full slots
    lengths = torch.tensor([1, 17, 100, 256, 300, 511, 512, 512],
                           dtype=torch.int32, device=dev)

    def compare(what, q, kp, vp, table):
        out = kd._paged_decode_cuda(q, kp, vp, table, lengths)
        plain = kd.paged_decode_plain(q, kp, vp, table, lengths)
        ref = kd.paged_decode_reference(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        e, ratio = check_close(f"paged decode ({what}) vs plain",
                               "paged_decode", out, plain)
        er, ratio_r = check_close(f"paged decode ({what}) vs reference",
                                  "paged_decode", out, ref)
        worst["e"] = max(worst["e"], e)
        worst["ratio"] = max(worst["ratio"], ratio)
        log(f"  paged {what}: max|out-plain|={e:.3g} (err/limit "
            f"{ratio:.3g}) max|out-ref|={er:.3g} (err/limit {ratio_r:.3g})")

    # 1. a contiguous pool with a scattered page table
    q = torch.randn(slots, h, d, generator=g, device=dev).to(bf16)
    kp = torch.randn(h, slots * pp, page, d, generator=g, device=dev).to(bf16)
    vp = torch.randn(h, slots * pp, page, d, generator=g, device=dev).to(bf16)
    perm = torch.randperm(slots * pp, generator=g, device=dev)
    compare("scattered table", q, kp, vp,
            perm.view(slots, pp).to(torch.int32).contiguous())
    # 2. the serving path's pool: a strided view of dense per-slot caches
    kc = torch.randn(slots, MAX_LEN, h, d, generator=g, device=dev).to(bf16)
    vc = torch.randn(slots, MAX_LEN, h, d, generator=g, device=dev).to(bf16)
    kv, vv, table = kd.paged_view_of_cache(kc, vc, page)
    compare("strided cache view", q, kv, vv, table)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    t_k = time_ms(lambda: kd._paged_decode_cuda(q, kv, vv, table, lengths),
                  50, flush)
    t_p = time_ms(lambda: kd.paged_decode_plain(q, kv, vv, table, lengths),
                  3, flush)
    live = int(lengths.sum())
    nbytes = (2 * live * h * 2 * d          # live K and V
              + 2 * 2 * slots * h * d       # q in, out
              + 4 * (slots * pp + slots))   # table, lengths
    flops = live * h * (2 * d + 2 * d)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  paged serving shape: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return {"name": "paged_decode", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/paged_decode.cu",
            "replaces": "flexflow_tpu/kernels/decode.py:50",
            "max_abs_err": worst["e"], "err_over_limit": worst["ratio"],
            "tol": TOL["paged_decode"], "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": ("8 slots x 16 heads, d 64, page 16, lengths "
                      "1/17/100/256/300/511/512/512, strided cache view, "
                      "bf16, L2 cold")}


def build_model(torch):
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.ff_types import ActiMode, AggrMode, DataType

    cfg = FFConfig(batch_size=SLOTS, allow_mixed_precision=True, seed=0)
    m = FFModel(cfg)
    ids = m.create_tensor((SLOTS, MAX_LEN), DataType.DT_INT32)
    t = m.embedding(ids, VOCAB, HIDDEN, AggrMode.AGGR_MODE_NONE)
    for _ in range(LAYERS):
        t = m.multihead_attention(t, t, t, HIDDEN, HEADS, causal=True)
        t = m.dense(t, HIDDEN, ActiMode.AC_MODE_RELU, use_bias=False)
        t = m.dense(t, HIDDEN, use_bias=False)
    m.softmax(m.dense(t, VOCAB))
    m.compile()
    return m


def unit_scale_weights(torch, model, inputs):
    """The models have no residuals or norms, so their glorot draws shrink
    the activations layer by layer until every output row is uniform and
    every check below is vacuous. Rescale, in graph order, each embedding
    table, attention output projection and dense kernel so that its op's
    output has unit standard deviation on `inputs` (data-dependent init in
    the manner of LSUV). The weights stay random from the seed."""
    from flexflow_tpu_torch.ff_types import OperatorType as T

    ex = model.executor
    which = {T.OP_EMBEDDING: "weight", T.OP_MULTIHEAD_ATTENTION: "wo",
             T.OP_LINEAR: "kernel"}
    inp = {ex.input_pts[0].guid: torch.as_tensor(inputs, device="cuda")}
    with torch.no_grad():
        for op in ex.topo:
            if op.op_type in which:
                out = ex.apply(model.params, inp)[op.outputs[0].guid].float()
                model.params[op.name][which[op.op_type]] /= out.std().item()


def check_cached_vs_forward(torch, model, seqs, plen):
    """The KV-cached path (prefill, then one paged-decode step per token)
    against the full causal forward (the flash kernel) on the same tokens:
    the JAX package's own oracle for its serving. Error metric per
    position: max over the vocab of |p_cached - p_forward|, over the max
    of p_forward (LOGIT_RTOL says why it is not 0)."""
    init, step = model.executor.build_decode(SLOTS, MAX_LEN)
    caches = init(model.params)
    n = seqs.shape[1]
    logits, caches = step(model.params, caches, 0, [seqs[:, :plen]])
    cached = [logits[:, -1]]
    for t in range(plen, n - 1):
        logits, caches = step(model.params, caches, t, [seqs[:, t:t + 1]])
        cached.append(logits[:, 0])
    cached = torch.stack(cached, 1).float()           # positions plen-1..n-2
    padded = np.zeros((SLOTS, MAX_LEN), np.int32)
    padded[:, :n] = seqs
    full = model.forward([padded])[:, plen - 1:n - 1].float()
    rel = (cached - full).abs().amax(-1) / full.amax(-1)
    err, mean_err = rel.max().item(), rel.mean().item()
    agree = (cached.argmax(-1) == full.argmax(-1)).float().mean().item()
    if not (torch.isfinite(cached).all() and torch.isfinite(full).all()):
        raise AssertionError("non-finite logits")
    if err > LOGIT_RTOL:
        raise AssertionError(f"cached logits vs forward: {err} > {LOGIT_RTOL}")
    return err, mean_err, agree


def serve(torch, model):
    """The main path. Returns the serving summary."""
    from flexflow_tpu_torch.runtime.serving import (AdmissionQueue,
                                                    ContinuousBatcher,
                                                    GenerationRequest,
                                                    ServingConfig,
                                                    incremental_generate)

    rng = np.random.RandomState(0)
    summary = {}
    # 1. incremental_generate on a batch of prompts
    plen, new = 64, 32
    prompts = rng.randint(0, VOCAB, (SLOTS, plen)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = incremental_generate(model, prompts, max_new_tokens=new,
                                max_len=MAX_LEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    summary["incremental_generate"] = {
        "batch": SLOTS, "prompt_len": plen, "new_tokens": new,
        "s": dt, "tokens_per_s": SLOTS * new / dt}
    log(f"  incremental_generate: {SLOTS}x{new} tokens in {dt:.3f}s")
    # 2. cached logits against the full forward (the flash kernel)
    err, mean_err, agree = check_cached_vs_forward(torch, model, toks, plen)
    summary["cached_vs_forward"] = {"max_rel_err": err,
                                    "mean_rel_err": mean_err,
                                    "tol": LOGIT_RTOL, "argmax_agree": agree}
    log(f"  cached vs forward: max rel err {err:.4g} (tol {LOGIT_RTOL}), "
        f"mean {mean_err:.4g}, argmax agreement {agree:.4f}")
    # 3. a continuous batcher answering ragged requests
    lens = [16, 40, 64, 97, 128, 150, 181, 200, 230, 256]
    reqs_p = [rng.randint(0, VOCAB, n).astype(np.int32) for n in lens]
    q = AdmissionQueue(max_depth=len(lens))
    b = ContinuousBatcher(model, ServingConfig(max_len=MAX_LEN, slots=SLOTS,
                                               page_size=16), q)
    reqs = [GenerationRequest(p, new, deadline_s=600.0) for p in reqs_p]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.start()
    try:
        for r in reqs:
            q.offer(r)
        outs = [r.result(timeout=600) for r in reqs]
    finally:
        b.stop()
    dt = time.perf_counter() - t0
    if b.dead or b.stats["finished"] != len(reqs):
        raise AssertionError(f"batcher: {b.stats}, died: {b.death_cause!r}")
    refs = [incremental_generate(model, p[None], max_new_tokens=new,
                                 max_len=MAX_LEN)[0] for p in reqs_p]
    # the batcher prefills as incremental_generate does (batch 1) and
    # decodes in the running batch through the same kernels: every token
    # must agree
    for i, (o, r) in enumerate(zip(outs, refs)):
        if not np.array_equal(o, r):
            at = int(np.argmax(o != r)) if o.shape == r.shape else -1
            raise AssertionError(
                f"request {i} (prompt {lens[i]}): batcher and "
                f"incremental_generate disagree from position {at}")
    summary["continuous_batcher"] = {
        "requests": len(reqs), "prompt_lens": lens, "new_tokens": new,
        "s": dt, "tokens_per_s": len(reqs) * new / dt,
        "iterations": b.stats["iterations"],
        "exact_vs_incremental_generate": len(reqs),
        "pool_audit_ok": b.pool.audit() == [],
        "pages_in_use_after": b.pool.pages_in_use}
    log(f"  batcher: {len(reqs)} requests x {new} tokens in {dt:.3f}s, "
        f"{len(reqs)}/{len(reqs)} exact vs incremental_generate")
    if b.pool.audit() or b.pool.pages_in_use:
        raise AssertionError(f"page pool not clean: {b.pool.audit()}")
    return summary


def build_transformer_model(torch):
    """bench.py's default workload through the port's builder: the
    reference's headline Transformer, bf16 compute over f32 weights."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType
    from flexflow_tpu_torch.models import build_transformer

    m = FFModel(FFConfig(batch_size=TRAIN_BATCH, allow_mixed_precision=True,
                         seed=0))
    build_transformer(m, TRAIN_BATCH, TRAIN_SEQ, HIDDEN, HEADS, LAYERS)
    m.compile(SGDOptimizer(lr=0.01),
              LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              [MetricsType.METRICS_MEAN_SQUARED_ERROR])
    return m


def profile_step(torch, run):
    """Device time of one warm call of `run` by kernel family, from a
    torch.profiler trace: the kernels' summed durations (one stream, so
    they do not overlap) against the wall time of the call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in events:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    family = {"flash_fwd": 0.0, "flash_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        key = ("flash_fwd" if "flash_fwd" in name else
               "flash_bwd" if "flash_bwd" in name else
               "gemm" if re.search(r"gemm|nvjet|xmma|cutlass", name) else
               "other")
        family[key] += ms
    busy = sum(family.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  step profile: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"in {len(events)} device events; "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in family.items()))
    log("  top kernels: " + "; ".join(f"{n[:60]} {ms:.2f} ms"
                                      for n, ms in top[:5]))
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_events": len(events),
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "by_family_ms": family,
            "top_kernels_ms": {n[:80]: ms for n, ms in top}}


def _block_of(weight: str) -> int:
    """The encoder block an "op_<type>_<i>.<weight>" name belongs to (each
    block adds three ops: attention, dense, dense)."""
    return int(weight.split(".")[0].rsplit("_", 1)[1]) // 3


def check_training_counts(what, counts, want):
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def train(torch):
    """The training path. Returns the training summary, with the launch
    counts of the fit run under "launches"."""
    from flexflow_tpu_torch.kernels import build

    model = build_transformer_model(torch)
    rng = np.random.RandomState(0)
    x, y = (rng.randn(TRAIN_BATCH, TRAIN_SEQ, HIDDEN).astype(np.float32)
            for _ in range(2))
    summary = {"model": "transformer", "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "hidden": HIDDEN, "heads": HEADS,
               "blocks": LAYERS, "optimizer": "SGD lr 0.01",
               "loss": "MSE avg", "precision": "bf16 compute and grads, "
               "f32 weights"}
    # 1. fit: TRAIN_STEPS epochs of one batch on the seed's glorot
    # weights, bench.py's own init. (Rescaled to unit activations, as for
    # the oracle below, the net has no norm or residual to bound its
    # curvature and SGD at lr 0.01 diverges within two steps; the glorot
    # draws shrink the activations and keep that lr stable.)
    os.environ.pop("FF_ATTENTION_IMPL", None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model.fit(x, y, epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    text = out.getvalue()
    log("  " + text.strip().replace("\n", "\n  "))
    losses = [float(v) for v in re.findall(r"epoch \d+: loss=(\S+)", text)]
    done = re.search(r"ELAPSED TIME = (\S+)s, THROUGHPUT = (\S+) samples/s",
                     text)
    if len(losses) != TRAIN_STEPS or not done:
        raise AssertionError(f"fit printed {text!r}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fit: losses {losses} must be finite and fall")
    per = TRAIN_STEPS * LAYERS
    check_training_counts("fit", counts, {"flash_fwd": per, "flash_bwd": per,
                                          "paged_decode": 0})
    summary.update(steps=TRAIN_STEPS, losses=losses, launches=counts,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                   fit_elapsed_s_reading=float(done.group(1)),
                   fit_samples_per_s_reading=float(done.group(2)))
    # step time on the host clock, warm, the same batch
    step = model.executor.build_train_step()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.state, _ = step(model.state, [x], y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    summary["step_ms_reading"] = 1e3 * min(times)
    summary["samples_per_s_reading"] = TRAIN_BATCH / min(times)
    log(f"  fit: losses {losses}; warm step {1e3 * min(times):.2f} ms "
        f"(host clock)")
    summary["step_profile"] = profile_step(torch, lambda: step(model.state,
                                                               [x], y))

    # 2. the gradient oracle, on unit-scaled weights
    unit_scale_weights(torch, model, x)
    grad = model.executor.build_grad_step()
    runs = {}
    for impl in ("flash", "dense"):
        if impl == "dense":
            os.environ["FF_ATTENTION_IMPL"] = "dense"
        torch.cuda.synchronize()
        build.reset_launch_counts()
        runs[impl] = grad(model.params, [x], y)
        torch.cuda.synchronize()
        n = LAYERS if impl == "flash" else 0
        check_training_counts(f"grad step ({impl})", build.launch_counts,
                              {"flash_fwd": n, "flash_bwd": n})
    os.environ.pop("FF_ATTENTION_IMPL", None)
    ratios = {}
    for op, gs in runs["dense"].items():
        # per weight, over the norm of the op's whole dense gradient:
        # without residuals, attention averages the tokens until every
        # token entering a deep block is nearly the same bf16 vector, and
        # there dP - delta, and with it the q/k gradients, (nearly) vanish
        # on the dense path while the flash path's delta, taken from its
        # rounded O, leaves a residue of the same tiny size
        op_norm = sum(g.float().norm().item() ** 2 for g in gs.values()) ** 0.5
        if not op_norm > 0:
            raise AssertionError(f"{op}: no dense gradient")
        for name, gd in gs.items():
            gk = runs["flash"][op][name]
            if gk.dtype != torch.bfloat16 or gd.dtype != torch.bfloat16:
                raise AssertionError(f"{op}.{name}: gradients {gk.dtype}, "
                                     f"{gd.dtype}; bf16 expected")
            if not torch.isfinite(gk).all():
                raise AssertionError(f"{op}.{name}: non-finite gradient")
            ratios[f"{op}.{name}"] = (
                (gk.float() - gd.float()).norm().item() / op_norm)
    top = {k: v for k, v in ratios.items() if _block_of(k) == LAYERS - 1}
    worst = max(ratios, key=ratios.get)
    worst_top = max(top, key=top.get)
    med = float(np.median(list(ratios.values())))
    log(f"  gradient oracle: worst ||g_flash - g_dense|| / ||g_dense(op)|| "
        f"{ratios[worst]:.4g} at {worst} (limit {ORACLE_RTOL}); top block "
        f"{top[worst_top]:.4g} at {worst_top} (limit {ORACLE_TOP_RTOL}); "
        f"median {med:.4g} over {len(ratios)} weights")
    log("  " + json.dumps({k: round(v, 6) for k, v in ratios.items()}))
    if ratios[worst] > ORACLE_RTOL or top[worst_top] > ORACLE_TOP_RTOL:
        raise AssertionError(f"gradient oracle: {worst} {ratios[worst]}, "
                             f"top block {worst_top} {top[worst_top]}")
    summary["grad_oracle"] = {
        "worst_rel_err": ratios[worst], "worst_at": worst,
        "limit": ORACLE_RTOL, "top_block_worst_rel_err": top[worst_top],
        "top_block_worst_at": worst_top, "top_block_limit": ORACLE_TOP_RTOL,
        "median_rel_err": med, "weights": len(ratios),
        "launches_flash_run": LAYERS, "launches_dense_run": 0}
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.kernels import build

    smi = gpu_name_and_power()
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build()
    t_build = time.perf_counter() - t0
    log(f"# kernels built in {t_build:.1f}s")
    report = {"build_s": t_build, "nvidia_smi": smi,
              "ptxas": {n: build.build_log(n) for n in build.KERNEL_SOURCES}}

    log("# kernel phase")
    torch.manual_seed(0)
    kernels = [check_flash(torch), check_flash_bwd(torch), check_paged(torch)]

    log("# serving phase")
    model = build_model(torch)
    ids = np.random.RandomState(1).randint(0, VOCAB, (SLOTS, MAX_LEN))
    unit_scale_weights(torch, model, ids.astype(np.int32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    summary = serve(torch, model)
    torch.cuda.synchronize()
    serving_counts = dict(build.launch_counts)
    summary["launches"] = serving_counts
    summary["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (serving_counts["flash_fwd"] and serving_counts["paged_decode"]):
        raise AssertionError(f"a kernel of the serving path never launched: "
                             f"{serving_counts}")
    del model
    torch.cuda.empty_cache()

    log("# training phase")
    training = train(torch)

    by_phase = {"serving": serving_counts, "training": training["launches"]}
    for k in kernels:
        k["launches_by_phase"] = {p: c[k["name"]] for p, c in by_phase.items()}
        k["launches"] = sum(k["launches_by_phase"].values())
        if not k["launches"]:
            raise AssertionError(f"{k['name']} launched on no path: {by_phase}")

    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_phase", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    line = {"kernels": [{k: kr[k] for k in keys} for kr in kernels]}
    report.update(kernels=kernels, serving=summary, training=training)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"serving": summary}))
    log(json.dumps({"training": training}))
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
