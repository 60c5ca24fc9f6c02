"""Time bf16 products on the card around tile multiples, and find the
tile quanta (search/machine_model.py TPUChipSpec.mxu_lanes and
mxu_sublanes) that explain the times.

One extent of (m, k) @ (k, n) is swept at a time, at each base of
SWEEP_BASES plus SWEEP_OFFSETS (both sides of multiples of 8 to 256),
the two others at SWEEP_FIXED. Each product is timed as search/
measure.py times an op: CUDA graphs of R and 4R calls between CUDA
events. A quanta pair is scored by the roofline the cost model prices
with (search/cost_model.py op_padded_flops): a product takes
max(2 * pad(m, sublanes) * pad(k, lanes) * pad(n, lanes) / F, bytes / B)
seconds, F and B fitted per pair for the least median relative error.
Small bases are memory-bound by nature, so the roofline, not the
FLOPs alone, is what a pair has to explain there.

Run on the card from the repo root:

    python -m flexflow_tpu_torch.search.tile_sweep [--out PATH]

It prints the per-point times and a JSON line that scores the shipped
quanta (search/machine_model.py H100_SPEC) against 1 and 1 and the best
pair, over all points and over those whose k and n are multiples of 8,
overall and per base (`analyze`); --out keeps the points and every
pair's error.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np

SWEEP_BASES = (16, 64, 128, 256, 512, 1024)
SWEEP_FIXED = 4096
SWEEP_OFFSETS = (0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
                 128, 129, 255, 256, 257)
SWEEP_QUANTA = (1, 8, 16, 32, 64, 128, 256)
_BF16_BYTES = 2
# the rate grids each pair's F and B are fitted over: quantiles of the
# points' own FLOP and byte rates
_GRID = np.linspace(0.0, 1.0, 41)
# two median errors this close are the same reading (run-to-run noise)
SAME_ERR = 1e-3


def _pad(x: int, q: int) -> int:
    return -(-x // q) * q


def roofline_errors(points, lanes: int, sublanes: int) -> np.ndarray:
    """Each point's |predicted - measured| / measured under quanta
    (lanes, sublanes), with the rates F and B that minimise the median
    error over `points` [(m, k, n, seconds)]."""
    fl = np.array([2.0 * _pad(m, sublanes) * _pad(k, lanes) * _pad(n, lanes)
                   for m, k, n, _ in points])
    by = np.array([_BF16_BYTES * (m * k + k * n + m * n)
                   for m, k, n, _ in points], dtype=float)
    t = np.array([p[3] for p in points])
    f_grid = np.quantile(fl / t, _GRID)
    b_grid = np.quantile(by / t, _GRID)
    # [F, B, point]
    pred = np.maximum(fl[None, None, :] / f_grid[:, None, None],
                      by[None, None, :] / b_grid[None, :, None])
    err = np.abs(pred - t) / t
    med = np.median(err, axis=2)
    i, j = np.unravel_index(int(np.argmin(med)), med.shape)
    return err[i, j]


def quanta_errors(points) -> dict:
    """{(lanes, sublanes): median roofline error over `points`} for
    every pair in SWEEP_QUANTA^2."""
    return {(lanes, sub): float(np.median(roofline_errors(points, lanes,
                                                          sub)))
            for lanes in SWEEP_QUANTA for sub in SWEEP_QUANTA}


def best_quanta(errs: dict) -> tuple:
    return min(errs, key=lambda q: (errs[q], q))


def _aligned(points):
    """The points whose k and n are multiples of 8: off them a product
    runs 2-7x slower on the card, a step no tile pad prices."""
    return [p for p in points if p[1] % 8 == 0 and p[2] % 8 == 0]


def analyze(by_base: dict, shipped: tuple) -> dict:
    """Score every quanta pair over `by_base` {base: [(m, k, n, s)]}, on
    all points and on the aligned ones, overall and at each base. The
    `shipped` pair explains the sweep when, in both scorings, its median
    error is below quanta 1 and 1's overall and within SAME_ERR of it or
    below at every base."""
    points = [p for pts in by_base.values() for p in pts]
    out = {"shipped": f"{shipped[0]}x{shipped[1]}"}
    ok = True
    for scoring, pick in (("all", lambda ps: ps), ("aligned", _aligned)):
        errs = quanta_errors(pick(points))
        best = best_quanta(errs)
        per_base = {}
        for base, pts in by_base.items():
            e = quanta_errors(pick(pts))
            b = best_quanta(e)
            per_base[str(base)] = {"1x1": e[(1, 1)], "shipped": e[shipped],
                                   "best": f"{b[0]}x{b[1]}",
                                   "best_err": e[b]}
            ok = ok and e[shipped] <= e[(1, 1)] + SAME_ERR
        ok = ok and errs[shipped] < errs[(1, 1)]
        out[scoring] = {
            "points": len(pick(points)),
            "median_err": {f"{q[0]}x{q[1]}": v for q, v in errs.items()},
            "1x1": errs[(1, 1)], "shipped": errs[shipped],
            "best": f"{best[0]}x{best[1]}", "best_err": errs[best],
            "per_base": per_base}
    out["shipped_explains"] = ok
    return out


def sweep(device: str = "cuda", bases=SWEEP_BASES) -> dict:
    """Time the products, then score the quanta pairs (`analyze`) with
    H100_SPEC's as the shipped pair."""
    import torch

    from ..config import resolve_device
    from .calibrate import card_name_and_power
    from .machine_model import H100_SPEC
    from .measure import OperatorMeasurer

    dev = resolve_device(device)
    name, power_limit = card_name_and_power(dev)
    print(f"tile sweep on: {name} ({power_limit})", flush=True)
    meas = OperatorMeasurer(repeats=16, device=dev)
    by_base = {}
    for base in bases:
        for axis in ("m", "k", "n"):
            for off in SWEEP_OFFSETS:
                e = base + off
                m, k, n = (e if axis == a else SWEEP_FIXED for a in "mkn")
                a = torch.randn(m, k, device=dev, dtype=torch.bfloat16)
                b = torch.randn(k, n, device=dev, dtype=torch.bfloat16)
                c = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
                reps, secs = meas._per_rep_seconds(
                    lambda: torch.matmul(a, b, out=c))
                by_base.setdefault(base, []).append((m, k, n, secs))
                print(f"  base {base} {axis}={e}: {secs * 1e6:.3f} us "
                      f"({2.0 * m * k * n / secs / 1e12:.1f} TFLOP/s, "
                      f"R={reps})", flush=True)
                del a, b, c
    shipped = (H100_SPEC.mxu_lanes, H100_SPEC.mxu_sublanes)
    return {"device": name, "power_limit": power_limit,
            "bases": list(bases), "fixed": SWEEP_FIXED,
            "points": [{"m": m, "k": k, "n": n, "us": s * 1e6}
                       for pts in by_base.values() for m, k, n, s in pts],
            **analyze(by_base, shipped)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.search.tile_sweep",
        description="Time bf16 products around tile multiples and print "
                    "which tile quanta explain them.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="also write the result's JSON here")
    args = ap.parse_args(argv)
    res = sweep(args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    summary = {k: v for k, v in res.items() if k != "points"}
    for scoring in ("all", "aligned"):
        summary[scoring] = {k: v for k, v in summary[scoring].items()
                            if k != "median_err"}
    print(json.dumps({"tile_sweep": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
