"""Structural checks on a searched strategy.

The PyTorch counterpart of the JAX package's runtime/verify.py
`validate_searched_strategy` (and of runtime/elastic.py
`validate_machine_views`, which it calls): the one strategy validator
the port registers (search/__init__.py). The JAX package's differential
verifier and its static-analysis validator are not ported.
"""
from __future__ import annotations

from typing import Dict, List


def validate_machine_views(views: Dict, num_devices: int) -> List[str]:
    """Check every searched MachineView addresses only live devices --
    every device each view enumerates, not just its bounding ids (a
    strided view can step over a dead device while its first/last ids
    look fine). Returns violation strings (empty = valid)."""
    bad = []
    for guid, view in (views or {}).items():
        if view is None:
            continue
        try:
            ids = sorted(view.device_ids())
        except Exception:  # malformed view: fall back to bound arithmetic
            last = view.start_device_id + sum(
                (d - 1) * s for d, s in zip(view.dim, view.stride)
            )
            ids = [view.start_device_id, last]
        dead = [d for d in ids if d < 0 or d >= num_devices]
        if not dead:
            continue
        bad.append(
            f"op {guid}: view {view!r} addresses device"
            f"{'s' if len(dead) > 1 else ''} "
            f"{dead if len(dead) > 1 else dead[0]} of {num_devices}"
        )
    return bad


def validate_searched_strategy(graph, views, num_devices: int) -> List[str]:
    """Structural checks on a searched strategy: every MachineView must
    address only live devices, and no tensor's total parallel degree may
    exceed the device count. Registered as the strategy validator
    (search.register_strategy_validator) so compile() flags a search
    result it will demote before it is lowered."""
    problems = list(validate_machine_views(views or {}, num_devices))
    for op in getattr(graph, "ops", []) or []:
        for tensor in op.outputs:
            degree = 1
            for d in getattr(tensor, "dims", ()):
                degree *= max(1, int(getattr(d, "degree", 1)))
            if degree > num_devices:
                problems.append(
                    f"op {op.name}: output degree product {degree} exceeds "
                    f"{num_devices} device(s)"
                )
    return problems
