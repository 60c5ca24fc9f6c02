#!/usr/bin/env python3
"""Warm training-step time of two checkouts of the port, on one card, in turns.

    python3 chip_step_ab.py BEFORE_DIR AFTER_DIR

Each checkout's own `flexflow_tpu_torch` and `chip_smoke.py` build and
drive the training paths of chip_smoke.py: the flagship Transformer
(batch 8, seq 512, hidden 1024, 16 heads, 12 blocks, bf16 over f32, SGD)
and BERT-base through the PyTorch frontend (batch 8, seq 512, dropout
0.1), data from seed 0. The runs go before, after, after, before, each in
a fresh process that builds its checkout's kernels, so that drift of the
card or its host falls on both sides alike. Per run and model: the warm
step on the host clock (min and median of 5 steps after 2 warm-up steps,
each ended by a synchronize) and, from a torch.profiler trace of one more
step, the device busy time, the flash kernels' device time and the idle
share. Per run, also the host time of one call of each flash wrapper
(forward, backward) at the Transformer's attention shape: 100 calls
enqueued without a synchronize (the launch queue holds them), over the
wall clock. Prints one JSON line per run, then a summary line with each
side's medians over its two runs. Needs one CUDA device and nvcc;
imports nothing of JAX.
"""
import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

STEPS, WARMUP = 5, 2
CALLS = 100


def _wrapper_host_ms(torch, bh: int, s: int, d: int) -> dict:
    """Host time of one call of each flash wrapper (bf16, non-causal)."""
    from flexflow_tpu_torch.kernels import attention as ka

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(bh, s, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = ka._flash_fwd_cuda(q, k, v, causal=False)
    out = {}
    for name, fn in (
            ("fwd", lambda: ka._flash_fwd_cuda(q, k, v, causal=False)),
            ("bwd", lambda: ka._flash_bwd_cuda(q, k, v, o, lse, do,
                                               causal=False))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        out[name] = 1e3 * (time.perf_counter() - t0) / CALLS
        torch.cuda.synchronize()
    return out


def _measure(checkout: str) -> dict:
    """Both models' warm steps through `checkout`'s own code."""
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.kernels import build

    build.build()
    out = {"checkout": checkout}
    rng = np.random.RandomState(0)
    x, y = (rng.randn(cs.TRAIN_BATCH, cs.TRAIN_SEQ, cs.HIDDEN)
            .astype(np.float32) for _ in range(2))
    models = {"transformer": (cs.build_transformer_model, (x, y), ())}
    rng = np.random.RandomState(0)
    xb, yb = (rng.randn(cs.BERT_BATCH, cs.BERT_SEQ, cs.BERT_HIDDEN)
              .astype(np.float32) for _ in range(2))
    models["bert"] = (cs.build_bert_model, (xb, yb),
                      (torch.Generator().manual_seed(1),))
    for name, (make, (xs, ys), extra) in models.items():
        model = make(torch)
        step = model.executor.build_train_step()
        times = []
        for i in range(WARMUP + STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.state, _ = step(model.state, [xs], ys, *extra)
            torch.cuda.synchronize()
            if i >= WARMUP:
                times.append(1e3 * (time.perf_counter() - t0))
        with contextlib.redirect_stdout(io.StringIO()):
            prof = cs.profile_step(torch, lambda: step(model.state, [xs], ys,
                                                       *extra))
        fam = prof["by_family_ms"]
        out[name] = {"step_ms_min": min(times),
                     "step_ms_median": statistics.median(times),
                     "step_ms": times, "device_busy_ms": prof["device_busy_ms"],
                     "flash_device_ms": fam["flash_fwd"] + fam["flash_bwd"],
                     "by_family_ms": fam, "idle_share": prof["idle_share"],
                     "profiled_wall_ms": prof["wall_ms"]}
        del model, step
        torch.cuda.empty_cache()
    out["flash_wrapper_host_ms"] = _wrapper_host_ms(
        torch, cs.TRAIN_BATCH * cs.HEADS, cs.TRAIN_SEQ, cs.HIDDEN // cs.HEADS)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--measure", action="store_true",
                    help="measure BEFORE alone in this process (internal)")
    args = ap.parse_args()
    if args.measure:
        print("AB " + json.dumps(_measure(args.before)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_step_ab: no CUDA device", file=sys.stderr)
        return 2
    runs = []
    for side, path in (("before", args.before), ("after", args.after),
                       ("after", args.after), ("before", args.before)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), path, path,
             "--measure"], capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise RuntimeError(f"{side} run of {path} failed "
                               f"(rc {proc.returncode})")
        run = dict(json.loads(lines[-1][3:]), side=side)
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {}
    for side in ("before", "after"):
        mine = [r for r in runs if r["side"] == side]
        summary[side] = {
            m: {k: statistics.median(r[m][k] for r in mine)
                for k in ("step_ms_min", "step_ms_median", "device_busy_ms",
                          "flash_device_ms", "idle_share")}
            for m in ("transformer", "bert")}
        summary[side]["flash_wrapper_host_ms"] = {
            c: statistics.median(r["flash_wrapper_host_ms"][c] for r in mine)
            for c in ("fwd", "bwd")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"summary": summary, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
