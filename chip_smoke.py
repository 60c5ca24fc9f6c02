#!/usr/bin/env python3
"""Drive flexflow_tpu_torch's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (PATH or $CUDA_HOME/bin); imports nothing
of JAX. Phases, each of which must pass or the script exits non-zero:

  1. build every CUDA kernel of the package from csrc/ (one nvcc each,
     all at once) into build/kernels/;
  2. kernels: each kernel against its plain PyTorch version on the card,
     in bf16 at the shapes the serving path gives it (and at edge shapes,
     in f32 too),
     timed beside its plain version, its library counterpart where one
     exists, and its least possible time on an H100 (the bound);
  3. serving: the full-width causal LM (GPT-2 vocab 50257, width 1024, 12
     blocks of causal MHA with 16 heads of 64 + dense RELU + dense, bf16
     compute over f32 weights, max_len 512, 8 slots, 16-token pages) with
     random weights from a seed, through incremental_generate, the full
     forward (the flash kernel) as the oracle of the KV-cached logits, and
     a ContinuousBatcher answering ragged requests, each held against
     incremental_generate on its prompt. Launch counts are reset just
     before this phase and read just after it.

Prints the card's name and power limit, a `kernels` JSON line, a `serving`
JSON line and, last, {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json.
"""
import json
import os
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
    one(128, 512, 512, 64, 64, False)
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
    return {"name": "flash_fwd", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "flexflow_tpu/kernels/attention.py:183",
            "max_abs_err": worst["o"], "err_over_limit": worst["ratio"],
            "tol": TOL["flash_fwd"], "lse_max_abs_err": worst["lse"],
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_l,
            "shape": "bh=128 sq=sk=512 d=dv=64 causal bf16, L2 warm"}


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


def unit_scale_weights(torch, model, ids):
    """The model has no residuals or norms, so its glorot draws shrink the
    activations layer by layer until every output row is uniform and every
    check below is vacuous. Rescale, in graph order, each embedding table,
    attention output projection and dense kernel so that its op's output
    has unit standard deviation on `ids` (data-dependent init in the
    manner of LSUV). The weights stay random from the seed."""
    from flexflow_tpu_torch.ff_types import OperatorType as T

    ex = model.executor
    which = {T.OP_EMBEDDING: "weight", T.OP_MULTIHEAD_ATTENTION: "wo",
             T.OP_LINEAR: "kernel"}
    inp = {ex.input_pts[0].guid: torch.as_tensor(ids, device="cuda")}
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
    kernels = [check_flash(torch), check_paged(torch)]

    log("# serving phase")
    model = build_model(torch)
    ids = np.random.RandomState(1).randint(0, VOCAB, (SLOTS, MAX_LEN))
    unit_scale_weights(torch, model, ids.astype(np.int32))
    torch.cuda.synchronize()
    build.reset_launch_counts()
    summary = serve(torch, model)
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    summary["launches"] = counts
    summary["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{k: kr[k] for k in keys} for kr in kernels]}
    report.update(kernels=kernels, serving=summary)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"serving": summary}))
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
