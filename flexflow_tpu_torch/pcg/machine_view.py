"""MachineView: which devices an operator's shards land on.

The PyTorch counterpart of flexflow_tpu/pcg/machine_view.py (reference:
MachineView / MachineResource, include/flexflow/machine_view.h:14-96):
a strided grid of device ids (start_device_id, dim[], stride[]) and the
machine slice a search subproblem may use. The strategy search
enumerates views exactly the way the reference does
(FFModel::register_all_machine_views, src/runtime/model.cc).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class MachineView:
    """A strided grid of device ids (reference: machine_view.h:14-49)."""

    device_type: str = "GPU"  # reference: GPU/CPU
    start_device_id: int = 0
    dim: Tuple[int, ...] = (1,)
    stride: Tuple[int, ...] = (1,)

    def __post_init__(self):
        # hash() is on the DP search's innermost memo-key path (tens of
        # millions of calls on a 300-op PCG) — precompute once
        object.__setattr__(self, "_hash", hash(
            (self.device_type, self.start_device_id, self.dim, self.stride)
        ))

    @property
    def ndims(self) -> int:
        return len(self.dim)

    def num_parts(self) -> int:
        n = 1
        for d in self.dim:
            n *= d
        return n

    def get_device_id(self, idx: Tuple[int, ...]) -> int:
        """Map an index-space point to a linear device id
        (reference: machine_view.h:24-33)."""
        assert len(idx) == self.ndims
        dev = self.start_device_id
        for i, p in enumerate(idx):
            dev += p * self.stride[i]
        return dev

    def device_ids(self) -> List[int]:
        ids = []

        def rec(i, base):
            if i == self.ndims:
                ids.append(base)
                return
            for p in range(self.dim[i]):
                rec(i + 1, base + p * self.stride[i])

        rec(0, self.start_device_id)
        return ids

    def hash(self) -> int:
        return self._hash

    def __repr__(self):
        return (
            f"MachineView<start={self.start_device_id} dim={list(self.dim)} "
            f"stride={list(self.stride)}>"
        )


@dataclasses.dataclass(frozen=True)
class MachineResource:
    """The machine (sub-)slice available to a search subproblem
    (reference: machine_view.h:51-60)."""

    num_nodes: int
    all_procs_per_node: int  # physical chips per node
    available_procs_per_node: int  # chips this subproblem may use
    start_gpu_id: int = 0
    start_node_id: int = 0

    def num_procs(self) -> int:
        return self.num_nodes * self.available_procs_per_node

    def is_valid_machine_view(self, view: MachineView) -> bool:
        """reference: machine_view.cc MachineResource::is_valid_machine_view.
        The local-proc window STARTS at start_gpu_id's local offset — the
        two halves of a vertical machine split must be DISJOINT device
        sets, or "concurrent" towers would silently share chips (and no
        boundary transfer or congestion could ever be priced between
        them)."""
        lo = self.start_gpu_id % self.all_procs_per_node
        for dev_id in (view.start_device_id, view.device_ids()[-1]):
            node = dev_id // self.all_procs_per_node
            local = dev_id % self.all_procs_per_node
            if node < self.start_node_id or node >= self.start_node_id + self.num_nodes:
                return False
            if local < lo or local >= lo + self.available_procs_per_node:
                return False
        return True

    def hash(self) -> int:
        return hash(
            (
                self.num_nodes,
                self.all_procs_per_node,
                self.available_procs_per_node,
                self.start_gpu_id,
                self.start_node_id,
            )
        )


def make_1d_view(start: int, degree: int, stride: int = 1) -> MachineView:
    return MachineView(start_device_id=start, dim=(degree,), stride=(stride,))


def enumerate_machine_views(num_nodes: int, procs_per_node: int) -> List[MachineView]:
    """Enumerate candidate views the way the reference pre-registers them
    (reference: FFModel::register_all_machine_views, model.cc — all 1-D views
    of every degree that evenly tiles the machine, intra- and inter-node).
    """
    total = num_nodes * procs_per_node
    views: List[MachineView] = []
    # intra-node contiguous views
    for degree in range(1, procs_per_node + 1):
        if procs_per_node % degree != 0 and degree != 1:
            pass  # reference allows any degree that fits; keep all that fit
        for start in range(0, total):
            if start % procs_per_node + degree <= procs_per_node:
                views.append(make_1d_view(start, degree, 1))
    # inter-node strided views (one proc per node run)
    for degree in range(2, num_nodes + 1):
        for start_node in range(0, num_nodes - degree + 1):
            for local in range(procs_per_node):
                views.append(
                    make_1d_view(
                        start_node * procs_per_node + local, degree, procs_per_node
                    )
                )
    # multi-node contiguous views (whole-node groups: the full-machine
    # data-parallel view lives here)
    for n in range(2, num_nodes + 1):
        degree = n * procs_per_node
        for start_node in range(0, num_nodes - n + 1):
            views.append(make_1d_view(start_node * procs_per_node, degree, 1))
    # dedupe
    seen = set()
    out = []
    for v in views:
        h = v.hash()
        if h not in seen:
            seen.add(h)
            out.append(v)
    return out
