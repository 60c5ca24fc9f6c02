"""Device mesh construction and ParallelTensor -> DTensor placements.

The PyTorch counterpart of flexflow_tpu/parallel/mesh.py. Where the JAX
package lowers a ParallelTensor to a PartitionSpec over a jax Mesh and
lets GSPMD insert the collectives, the port lowers it to DTensor
placements (`Shard(d)` / `Replicate()`, one per mesh axis) over a
`torch.distributed` DeviceMesh of one process per device, and DTensor's
sharding propagation inserts them: an op on DTensors computes the value
of the GLOBAL array, as the JAX program does.

A `Mesh` keeps JAX's named axes, size-1 axes included, so a
ParallelDim's `parallel_idx` indexes the same axis in both packages. The
DeviceMesh under it spans only the axes of size > 1 (one axis of size 1
when every axis is): DTensor enumerates its sharding strategies over the
product of the mesh's dims, so every size-1 dim multiplies the cost of
propagating each op (a matmul on a 2 x 2 x 1 x 1 x 1 mesh took seconds
where the 2 x 2 mesh takes milliseconds) and shards nothing.

A strategy may use fewer devices than the process group holds (the
JAX package's `build_mesh` leaves the surplus devices out, as a
MachineView that does not cover the machine): the port's surplus ranks
run the same program as replicas, over a leading "replica" dim of the
DeviceMesh that no tensor shards, so they compute the same values and
exchange nothing.

The ops use a few helpers where DTensor alone would not do: `like`
turns a plain tensor built over the global shape (a mask) into a
replicated DTensor, `shard_like` places a whole tensor as a DTensor is
placed, `gathered` reads a value whole, `per_shard` runs an op on local
shards through `local_map` where DTensor has no rule for it in some
torch release, and `var_mean` takes the statistics of a sharded
reduction from partial sums. Every gather of a sharded operand they
make is counted in `GATHERED`.
"""
from __future__ import annotations

import collections
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

# Canonical axis names in priority order (the JAX package's): data =
# sample dim, model = tensor parallel, seq = sequence parallel, expert =
# MoE experts, pipe = pipeline stages, fsdp = weight sharding (the batch
# shards over data AND fsdp jointly).
AXIS_NAMES = ("data", "model", "seq", "expert", "pipe", "fsdp")


def _dtensor_module():
    """torch.distributed.tensor once something imported it (every
    DTensor comes from it), else None: plain tensors need no import."""
    return sys.modules.get("torch.distributed.tensor")


def is_dtensor(t) -> bool:
    mod = _dtensor_module()
    return mod is not None and isinstance(t, mod.DTensor)


def local(t):
    """This rank's shard of a DTensor; any other value as it is."""
    return t.to_local() if is_dtensor(t) else t


def version(t) -> object:
    """The version counter that an in-place write to `t` moves. A
    DTensor's wrapper and its local tensor count apart (a write through
    one moves only its own counter, and the port writes weights both
    ways: the optimizer through the wrapper, a restore or a gathered
    update through the local tensor), so a DTensor's version is the pair.
    Raises RuntimeError for an inference tensor, which tracks none."""
    if is_dtensor(t):
        return t._version, t._local_tensor._version
    return t._version


def full(t):
    """The whole global value of a DTensor on every rank (an all-gather
    or all-reduce where it is sharded or partial); any other value as it
    is. Every host read of a mesh value goes through this (the JAX
    package's `_fetch_global`)."""
    return t.full_tensor() if is_dtensor(t) else t


def like(t: torch.Tensor, ref):
    """`t`, a plain tensor that every rank builds alike over the GLOBAL
    shape (a mask), as a replicated DTensor on `ref`'s mesh when `ref` is
    a DTensor, else as it is: an op on DTensors takes no plain operand
    but a scalar."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard_like(t: torch.Tensor, ref):
    """`t`, a whole tensor of `ref`'s global shape that every rank holds
    alike, placed as DTensor `ref` is (each rank keeps its own shard,
    sliced locally); with any other `ref`, `t` as it is."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(local(ref).device), ref.device_mesh,
                             ref.placements, src_data_rank=None)


# the calls of `per_shard` and `gathered` that gathered a sharded
# operand first ({op name: calls}); the tests read it
GATHERED: collections.Counter = collections.Counter()


def per_shard(fn, x: torch.Tensor, whole: Sequence[int], name: str, *,
              shared: Sequence[torch.Tensor] = (), n_out: int = 1,
              dropped: Sequence[int] = ()):
    """`fn(x, *shared)` for an op that some torch release's DTensor has
    no rule for (or a rule that refuses the op's arguments) and that
    computes each position of `x`'s dims outside `whole` on its own
    (pooling, a convolution over N, a per-row reduction or sort). On a
    DTensor `fn` runs on each rank's local tensors through `local_map`:
    the dims in `whole` held whole on every rank (a mesh axis that
    shards one of them is gathered first), the other dims placed as `x`
    places them; each of `shared` (a weight) held whole on every rank,
    its gradient a partial sum over the axes that shard `x`. Gathering a
    sharded operand counts `name` in GATHERED. `fn` returns `n_out`
    tensors, each without the dims in `dropped` (a reduction without
    keepdim). Without a DTensor: `fn(x, *shared)`."""
    if not is_dtensor(x):
        return fn(x, *shared)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    whole = tuple(d % x.dim() for d in whole)
    pl = [p if isinstance(p, Shard) and p.dim not in whole else Replicate()
          for p in x.placements]
    rep = [Replicate()] * len(pl)
    if any(isinstance(p, Shard) and p.dim in whole for p in x.placements) \
            or any(is_dtensor(w) and any(not isinstance(p, Replicate)
                                         for p in w.placements)
                   for w in shared):
        GATHERED[name] += 1
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    out = [Shard(p.dim - sum(d < p.dim for d in dropped))
           if isinstance(p, Shard) else p for p in pl]
    return local_map(fn, out_placements=out if n_out == 1 else (out,) * n_out,
                     in_placements=(pl,) + (rep,) * len(shared),
                     in_grad_placements=(pl,) + (grad,) * len(shared),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, *shared)


def gathered(t, name: str):
    """The whole value of `t` (`full`) for an op that needs every rank to
    see all of it, counting `name` in GATHERED where `t` is sharded."""
    from torch.distributed.tensor import Replicate

    if is_dtensor(t) and any(not isinstance(p, Replicate)
                             for p in t.placements):
        GATHERED[name] += 1
    return full(t)


def var_mean(x: torch.Tensor, dims: Sequence[int], keepdim: bool = False):
    """(var, mean) of `x` over `dims`, biased (`torch.var_mean(...,
    correction=0)`). On a DTensor that a mesh axis shards along one of
    `dims` (BatchNorm's batch under a data axis, LayerNorm's hidden dim
    under a model axis), from partial sums, as GSPMD computes JAX's
    `jnp.mean`/`jnp.var`: the mean is each rank's local sum all-reduced
    over those axes and divided by the global count, then the variance
    is the mean of (x - mean)^2 the same way (not E[x^2] - E[x]^2, which
    cancels), so only vectors of the kept dims cross ranks. Built from
    `sum` and elementwise ops alone: torch 2.11's DTensor has no rule for
    var_mean. On any other DTensor (no reduced dim sharded) torch's
    var_mean runs on each rank's local tensor through `per_shard`, which
    gathers nothing there."""
    dims = tuple(d % x.dim() for d in dims)
    if is_dtensor(x):
        from torch.distributed.tensor import Partial, Replicate, Shard

        if any(isinstance(p, Shard) and p.dim in dims
               for p in x.placements):
            count = 1
            for d in dims:
                count *= x.shape[d]
            mesh = x.device_mesh

            def mean_of(t):
                s = t.sum(dim=dims, keepdim=True)
                s = s.redistribute(mesh, [
                    Replicate() if isinstance(p, Partial) else p
                    for p in s.placements])
                return s / count

            mean = mean_of(x)
            centred = x - mean
            var = mean_of(centred * centred)
            if not keepdim:
                # a sum over the kept size-1 dims: each is its one element
                mean, var = mean.sum(dim=dims), var.sum(dim=dims)
            return var, mean
    return per_shard(
        lambda t: torch.var_mean(t, dim=dims, keepdim=keepdim, correction=0),
        x, dims, "var_mean", n_out=2, dropped=() if keepdim else dims)


def placements_for_parallel_tensor(pt, axis_names: Sequence[str],
                                   axis_sizes: Sequence[int]) -> tuple:
    """Lower ParallelTensor dims to DTensor placements, one per axis of
    `axis_names` (the JAX package's `pspec_for_parallel_tensor`, as a pure
    function of the names and sizes).

    Partitioned material dims shard over their axis (`Shard(material
    dim)`); replica dims are dropped (their axis stays `Replicate()`). A
    mesh axis is used at most once per tensor: when two dims land on the
    same axis the first keeps it and the later ones stay replicated. The
    ZeRO/FSDP batch rule: a "data" (or "expert") dim whose degree is the
    data size times the fsdp size shards over both axes jointly, data
    major (JAX's ("data", "fsdp") tuple)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(axis_names)
    sizes = dict(zip(names, axis_sizes))
    out = [Replicate() for _ in names]
    used = set()
    md = 0
    for d in pt.dims:
        if d.is_replica_dim:
            continue
        if d.degree > 1 and 0 <= d.parallel_idx < len(names) \
                and names[d.parallel_idx] not in used:
            name = names[d.parallel_idx]
            entry = (name,)
            if (name in ("data", "expert") and "fsdp" in names
                    and "fsdp" not in used
                    and d.degree != sizes[name]
                    and d.degree == sizes[name] * sizes.get("fsdp", 1)):
                entry = (name, "fsdp")
                used.add("fsdp")
            used.add(name)
            for n in entry:
                out[names.index(n)] = Shard(md)
        md += 1
    return tuple(out)


# the DeviceMesh dim of the surplus ranks' replicas (Mesh); no tensor
# shards over it
REPLICA_AXIS = "replica"


class Mesh:
    """A device mesh of named axes over the default process group, one
    device per process (the JAX package's jax.sharding.Mesh). `shape`
    maps every axis name to its size, size-1 axes kept, and `size` is
    their product, the devices the strategy uses; `device_mesh` is the
    DeviceMesh over the axes of size > 1 (`live_axes`), ranks laid out
    row-major in axis order as JAX's build_mesh lays out devices. With
    `replicas` > 1 (a group of `replicas` x `size` processes) the
    DeviceMesh has a leading REPLICA_AXIS dim of that size, first in
    `live_axes`, over which every tensor is replicated."""

    def __init__(self, axis_sizes: Dict[str, int], device_type: str,
                 replicas: int = 1):
        from torch.distributed.device_mesh import init_device_mesh

        self.axis_names: Tuple[str, ...] = tuple(axis_sizes)
        self.shape: Dict[str, int] = {k: int(v)
                                      for k, v in axis_sizes.items()}
        self.size = 1
        for v in self.shape.values():
            self.size *= v
        self.replicas = int(replicas)
        live = [(k, v) for k, v in self.shape.items() if v > 1]
        if self.replicas > 1:
            live.insert(0, (REPLICA_AXIS, self.replicas))
        live = live or [(self.axis_names[0], 1)]
        self.live_axes: Tuple[str, ...] = tuple(k for k, _ in live)
        self._live_idx = [self.axis_names.index(k) if k in self.shape
                          else None for k in self.live_axes]
        self.device_type = device_type
        self.device_mesh = init_device_mesh(
            device_type, tuple(v for _, v in live),
            mesh_dim_names=self.live_axes)

    def placements(self, pt) -> tuple:
        """The DTensor placements of a ParallelTensor on this mesh (one
        per live axis)."""
        from torch.distributed.tensor import Replicate

        full_pl = placements_for_parallel_tensor(
            pt, self.axis_names, [self.shape[k] for k in self.axis_names])
        return tuple(Replicate() if i is None else full_pl[i]
                     for i in self._live_idx)

    def dim_of(self, axis: str) -> Optional[int]:
        """The DeviceMesh dim of mesh axis `axis` (None where the axis
        has size 1 and so no dim)."""
        return (self.live_axes.index(axis)
                if axis in self.live_axes and self.shape.get(axis, 1) > 1
                else None)

    def replicate(self) -> tuple:
        from torch.distributed.tensor import Replicate

        return tuple(Replicate() for _ in self.live_axes)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def build_mesh(axis_sizes: Dict[str, int],
               device_type: Optional[str] = None) -> Mesh:
    """A Mesh of {axis name: size} over the default process group (size-1
    axes kept). The sizes must multiply to a divisor of the world size
    (one process per device): where they multiply to less, the surplus
    processes run the program as replicas (Mesh `replicas`), where JAX's
    build_mesh leaves the surplus devices out. The device type defaults
    to the group's ("cuda" under NCCL, "cpu" under gloo)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs the process group: "
                           "runtime/distributed.py init_distributed()")
    axes = dict(axis_sizes) or {"data": 1}
    n = 1
    for v in axes.values():
        n *= int(v)
    world = dist.get_world_size()
    if n > world or world % n:
        raise ValueError(f"mesh {axes} needs {n} devices; the process "
                         f"group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(axes, device_type, replicas=world // n)


def build_hybrid_mesh(ici_axes: Dict[str, int], dcn_axes: Dict[str, int],
                      device_type: Optional[str] = None) -> Mesh:
    """A Mesh of `dcn_axes` (the axes that span nodes: put data
    parallelism there) and `ici_axes` (the axes within a node), the JAX
    package's `build_hybrid_mesh`. The process group carries no slice
    topology, so this is that function's fallback: one mesh with the DCN
    axes leading, so that with ranks numbered node by node (torchrun's
    layout) a collective over an ICI axis stays within a node and only
    the DCN axes cross nodes."""
    merged = dict(dcn_axes)
    merged.update(ici_axes)
    return build_mesh({n: merged[n]
                       for n in tuple(dcn_axes) + tuple(ici_axes)},
                      device_type)


def default_data_parallel_mesh(num_devices: Optional[int] = None,
                               device_type: Optional[str] = None) -> Mesh:
    import torch.distributed as dist

    return build_mesh({"data": num_devices or dist.get_world_size()},
                      device_type)


def machine_view_to_axes(view, mesh: Mesh) -> Tuple[str, ...]:
    """Map a MachineView's dims onto mesh axis names by size (the JAX
    package's round-1 restriction: views align with the axis sizes)."""
    out = []
    for d in view.dim:
        for name, sz in mesh.shape.items():
            if sz == d and name not in out:
                out.append(name)
                break
    return tuple(out)


def distribute(t: torch.Tensor, mesh: Mesh, placements):
    """A DTensor of the whole tensor `t`, which every rank holds alike:
    each rank keeps its own shard, sliced locally (no communication)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh.device_mesh, placements,
                             src_data_rank=None)


# -- ring shifts ------------------------------------------------------------
# A hop round a ring of ranks, the JAX package's `lax.ppermute` with perm
# j -> j + step: ring attention passes K and V round the "seq" group
# (kernels/attention.py) and the GPipe schedule passes activations round
# the "pipe" group (parallel/pipeline.py). `axis` is a ProcessGroup (None:
# a group of this process alone, where a hop sends nothing).

def group_size_rank(axis) -> Tuple[int, int]:
    """(size, this process's rank) of ProcessGroup `axis` ((1, 0) for
    None)."""
    import torch.distributed as dist

    if axis is None:
        return 1, 0
    return dist.get_world_size(axis), dist.get_rank(axis)


def shift(xs, axis, step: int):
    """Every rank sends the tensors `xs` to the rank `step` places after
    it round `axis` and returns what the rank `step` places before it
    sent. With one rank the tensors come back as they are.

    Each tensor moves by one `all_to_all_single` whose splits send it
    whole to one peer and nothing to the others: the exchange rides the
    group's collective communicator, as its other collectives do (inside
    a captured train scan too), where point-to-point sends open a
    communicator for each pair of ranks."""
    import torch.distributed as dist

    n, idx = group_size_rank(axis)
    if n == 1:
        return list(xs)
    to, frm = (idx + step) % n, (idx - step) % n
    outs = []
    for x in xs:
        flat = x.contiguous().reshape(-1)
        out = torch.empty_like(flat)
        sizes = [0] * n
        send, recv = list(sizes), list(sizes)
        send[to], recv[frm] = flat.numel(), flat.numel()
        dist.all_to_all_single(out, flat, output_split_sizes=recv,
                               input_split_sizes=send, group=axis)
        outs.append(out.view(x.shape))
    return outs


class _RingShift(torch.autograd.Function):
    """One hop of tensors round the ring (`shift` by 1): the backward
    sends their cotangents one hop the other way round, the transpose of
    the exchange, as JAX's autodiff transposes `lax.ppermute`. Every rank
    of the ring must run the backward, or the ranks that do wait for it:
    the caller keeps every output in its graph."""

    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        return tuple(shift(xs, axis, 1))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *shift(gs, ctx.axis, -1))


def ring_shift(xs, axis):
    """`shift(xs, axis, 1)`, differentiable (`_RingShift`): a tuple."""
    return _RingShift.apply(axis, *xs)
