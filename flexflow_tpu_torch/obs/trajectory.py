"""Search-trajectory recorder.

The PyTorch counterpart of flexflow_tpu/obs/trajectory.py. compile()
records what the strategy search did -- every substitution candidate the
best-first loop evaluated, the DP's split decisions, and the compile
phase timings (lowering, strategy_search, executor_build) -- into a
bounded in-memory trajectory on the model (`model.search_trajectory`).

Entries are plain dicts `{"kind": ..., "t": perf_counter(), ...}`;
`limit` bounds memory (overflow counted in `dropped`).
"""
from __future__ import annotations

import time
from typing import Dict, List


class SearchTrajectory:
    """Bounded append-only record of search/compile decisions."""

    def __init__(self, limit: int = 20_000):
        self.limit = limit
        self.events: List[dict] = []
        self.dropped: Dict[str, int] = {}

    def event(self, kind: str, **fields) -> None:
        if len(self.events) >= self.limit:
            self.dropped[kind] = self.dropped.get(kind, 0) + 1
            return
        rec = {"kind": kind, "t": time.perf_counter()}
        rec.update(fields)
        self.events.append(rec)

    def phase(self, name: str, t0: float, **fields) -> None:
        """Record a completed compile phase (t0 from perf_counter())."""
        self.event("phase", name=name, t0=t0,
                   dur=time.perf_counter() - t0, **fields)

    # -- views -----------------------------------------------------------
    def of_kind(self, kind: str) -> List[dict]:
        return [e for e in self.events if e["kind"] == kind]

    def mcmc_iterations(self) -> List[dict]:
        return self.of_kind("mcmc_iter")

    def summary(self) -> dict:
        """Aggregate view for reports and the CLI."""
        mcmc = self.mcmc_iterations()
        cands = self.of_kind("xfer_candidate")
        phases = {
            e["name"]: e["dur"] for e in self.of_kind("phase")
        }
        out = {
            "events": len(self.events),
            "dropped": dict(self.dropped),
            "phases_s": phases,
            "mcmc": {
                "iterations": len(mcmc),
                "accepted": sum(1 for e in mcmc if e.get("accept")),
            },
            "substitution": {
                "candidates": len(cands),
                "improved": sum(1 for e in cands if e.get("best")),
            },
            "dp": {
                "splits": len(self.of_kind("dp_split")),
            },
        }
        ends = self.of_kind("search_end")
        if ends:
            out["final_cost"] = ends[-1].get("cost")
        return out
