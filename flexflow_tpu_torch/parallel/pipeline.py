"""GPipe pipeline parallelism over a "pipe" mesh axis.

The PyTorch counterpart of flexflow_tpu/parallel/pipeline.py. The JAX
package runs the schedule as one SPMD program under `shard_map`; the port
runs it as each rank's own program on its local shards, inside
`local_map` (the op's DTensor values in, a DTensor out), over the
ProcessGroup of the mesh's "pipe" dim.

Schedule: GPipe, JAX's. The local batch is split into `n_micro`
micro-batches (clamped to a divisor of the local batch); for `n_micro +
n_stages - 1` ticks every stage computes its layer group on the
activation it holds, then the activations hop one rank round the pipe
ring (parallel/mesh.py `ring_shift`; its backward is the reverse hop) so
stage s+1 sees stage s's output next tick. Stage 0 injects a fresh
micro-batch each tick, the last stage collects finished micro-batches in
an output buffer that is zero on every other stage, and a sum over the
pipe group (`_PipeSum`) replicates it. Every rank computes every tick,
bubbles included, as in JAX.

The backward is autograd's reverse pipeline, and its exchanges are
collectives: every rank must run the backward of every hop, in the same
order. So each rank's graph keeps every hop's output and every tick's
output on the path to the loss, whatever its stage: the stage's choices
(inject or take the hop, collect or keep the buffer) are `_select` nodes
that pass a zero gradient to the input they did not take, where JAX's
`jnp.where` does the same. The hop after the last tick is never read, in
either package, and is not made.

`_PipeSum` all-reduces in the forward and passes the cotangent through
unchanged: JAX's `psum` of a pipe-varying buffer to a replicated value
transposes without a sum, where torch.distributed.nn's all_reduce would
sum the cotangents again and scale every gradient by the pipe degree.

The generalized path (`gpipe_pcg`) runs an arbitrary PCG cut into
stages (`PcgPipelinePlan`, balanced by `balanced_linear_partition` over
op costs): each rank runs its own stage's ops, where JAX's `lax.switch`
picks the branch by the stage index, and inter-stage tensors travel in
one flat f32 buffer padded to the widest cut; graph inputs (ints among
them) enter at stage 0 outside it. Weights are replicated over "pipe";
their gradients are summed over data and pipe after the schedule.

Bubble fraction (n_stages - 1) / (n_micro + n_stages - 1), the GPipe
figure.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from .mesh import group_size_rank, ring_shift


def scan_blocks(block_fn: Callable, stacked_params, x):
    """The one-stage path: every stacked layer in order. `stacked_params`
    ({name: tensor}) have a leading num_layers dim."""
    return _stage_apply(block_fn, stacked_params, x)


def _stage_apply(block_fn: Callable, local_params, h):
    """This stage's layer group (leaves with a leading layers dim)."""
    n = next(iter(local_params.values())).shape[0]
    for i in range(n):
        h = block_fn({k: w[i] for k, w in local_params.items()}, h)
    return h


def clamp_microbatches(n_micro: int, b_local: int) -> int:
    """JAX's clamp: the largest divisor of the local batch `b_local` that
    is at most `n_micro` (and at least 1)."""
    n_micro = max(1, min(n_micro, b_local))
    while b_local % n_micro:
        n_micro -= 1
    return n_micro


class _Select(torch.autograd.Function):
    """`a` if `take_a` else `b`, a host-side choice that keeps both in the
    graph: the one not taken gets a zero gradient, so the nodes behind it
    (a hop's backward, a collective) run on every rank alike."""

    @staticmethod
    def forward(ctx, take_a: bool, a, b):
        ctx.take_a = take_a
        return (a if take_a else b).view_as(a)

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros_like(g)
        return None, (g if ctx.take_a else zero), (zero if ctx.take_a
                                                    else g)


def _select(take_a: bool, a, b):
    return _Select.apply(bool(take_a), a, b)


class _ZeroGrads(torch.autograd.Function):
    """`out` as it is, with a zero gradient for each of `tensors`: a
    weight this rank's stage does not read still gets a gradient, a zero
    partial sum, so every rank reduces the same gradients in the same
    order after the schedule."""

    @staticmethod
    def forward(ctx, out, *tensors):
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dt, device=dev)
                     for shape, dt, dev in ctx.like))


class _PipeSum(torch.autograd.Function):
    """The sum of `x` over the pipe `group` (an all-reduce), whose
    backward passes the cotangent through unchanged (module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _check_group(group, n_stages: int) -> int:
    """This rank's stage; raises unless the pipe group has `n_stages`
    ranks (no group, or a group of another size, runs no pipeline)."""
    size, stage = group_size_rank(group)
    if group is None or size != n_stages:
        raise ValueError(
            f"a pipeline of {n_stages} stages needs a pipe process group "
            f"of {n_stages} ranks, one a stage; got "
            f"{'none' if group is None else f'{size} ranks'}")
    return stage


def gpipe_spmd(block_fn: Callable, local_params, x_local, *, n_stages: int,
               n_micro: int, group):
    """One rank's program of the GPipe schedule over stacked blocks (the
    JAX package's `gpipe_spmd` body inside shard_map): `local_params`
    ({name: tensor}) are this stage's layers (leading dim num_layers /
    n_stages), `x_local` this rank's (b_local, ...) batch, `group` the
    pipe ProcessGroup of `n_stages` ranks. Returns the output of every
    layer on `x_local`, the same on every rank of the group."""
    stage = _check_group(group, n_stages)
    last = n_stages - 1
    n_micro = clamp_microbatches(n_micro, x_local.shape[0])
    mb = x_local.shape[0] // n_micro
    mbs = x_local.reshape((n_micro, mb) + tuple(x_local.shape[1:]))
    ticks = n_micro + n_stages - 1
    x_cur = torch.zeros_like(mbs[0])
    outbuf = [torch.zeros_like(mbs[0]) for _ in range(n_micro)]
    for t in range(ticks):
        x_in = _select(stage == 0, mbs[min(t, n_micro - 1)], x_cur)
        y = _stage_apply(block_fn, local_params, x_in)
        out_idx = t - last
        oi = min(max(out_idx, 0), n_micro - 1)
        outbuf[oi] = _select(stage == last and out_idx >= 0, y, outbuf[oi])
        if t < ticks - 1:
            (x_cur,) = ring_shift((y,), group)
    out = _PipeSum.apply(torch.stack(outbuf), group)
    return out.reshape(x_local.shape)


def _placements(mesh, by_axis):
    """DTensor placements over `mesh`'s live axes: `by_axis` {axis name:
    placement}, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate

    return [by_axis.get(a, Replicate()) for a in mesh.live_axes]


def gpipe_mesh(block_fn: Callable, stacked_params, x, *, mesh,
               n_stages: int, n_micro: int, axis_name: str = "pipe",
               data_axis: str = "data"):
    """The GPipe schedule on DTensors (the JAX package's `gpipe_spmd`
    call): `stacked_params` ({name: DTensor}, leading num_layers dim) are
    held Shard(0) over `axis_name`, `x` Shard(0) over `data_axis`, each
    replicated over every other axis (JAX's in_specs P("pipe") and
    P("data")); each rank runs `gpipe_spmd` on its local shards through
    `local_map`. The output is placed as `x` is; the weights' gradients
    come out Shard(0) over the pipe axis and partial over the data axis,
    x's partial over the pipe axis (only stage 0 reads it)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    names = list(stacked_params)
    layers = stacked_params[names[0]].shape[0]
    if layers % n_stages:
        raise ValueError(f"{layers} layers not divisible into {n_stages} "
                         "stages")
    group = mesh.device_mesh.get_group(axis_name)
    x_pl = _placements(mesh, {data_axis: Shard(0)})
    x_grad = _placements(mesh, {data_axis: Shard(0), axis_name: Partial()})
    w_pl = _placements(mesh, {axis_name: Shard(0)})
    w_grad = _placements(mesh, {axis_name: Shard(0), data_axis: Partial()})

    def per_rank(x_local, *ws):
        return gpipe_spmd(block_fn, dict(zip(names, ws)), x_local,
                          n_stages=n_stages, n_micro=n_micro, group=group)

    return local_map(
        per_rank, out_placements=x_pl,
        in_placements=(x_pl,) + (w_pl,) * len(names),
        in_grad_placements=(x_grad,) + (w_grad,) * len(names),
        device_mesh=mesh.device_mesh, redistribute_inputs=True)(
            x, *(stacked_params[n] for n in names))


def scan_blocks_mesh(block_fn: Callable, stacked_params, x, *, mesh,
                     data_axis: str = "data"):
    """`scan_blocks` on DTensors without a pipe axis of the op's stages:
    each rank runs every layer on its Shard(0)-over-`data_axis` batch
    through `local_map`, the weights held whole (their gradients partial
    over the data axis)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    names = list(stacked_params)
    x_pl = _placements(mesh, {data_axis: Shard(0)})
    w_pl = _placements(mesh, {})
    w_grad = _placements(mesh, {data_axis: Partial()})

    def per_rank(x_local, *ws):
        return scan_blocks(block_fn, dict(zip(names, ws)), x_local)

    return local_map(
        per_rank, out_placements=x_pl,
        in_placements=(x_pl,) + (w_pl,) * len(names),
        in_grad_placements=(x_pl,) + (w_grad,) * len(names),
        device_mesh=mesh.device_mesh, redistribute_inputs=True)(
            x, *(stacked_params[n] for n in names))


# ---------------------------------------------------------------------------
# Generalized pipeline over an arbitrary PCG (non-uniform models, CNNs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PcgPipelinePlan:
    """Stage partition of a PCG's compute ops (contiguous in topo order)."""

    stages: List[List]  # per stage: PCGOps
    # per cut s (between stage s and s+1): [(guid, shape_wo_batch, dtype)]
    cuts: List[List[Tuple[int, Tuple[int, ...], Any]]]
    buf_elems: int  # flat f32 elems per sample, max over cuts
    out_guid: int
    out_shape: Tuple[int, ...]  # global shape
    out_dtype: Any  # torch dtype
    n_stages: int
    # parallel-op output guid -> producing compute tensor guid (identity
    # bookkeeping resolved at plan time)
    alias: dict = dataclasses.field(default_factory=dict)


def balanced_linear_partition(costs: List[float], k: int) -> List[int]:
    """Contiguous partition of `costs` into k groups minimizing the max
    group sum (the classic linear-partition DP): the cut the executor
    plans from the cost model's op costs. Returns cut indices: group j =
    ops[cut[j]:cut[j+1]]."""
    n = len(costs)
    k = min(k, n)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    inf = float("inf")
    dp = [[inf] * (k + 1) for _ in range(n + 1)]
    cut = [[0] * (k + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, min(i, k) + 1):
            for m in range(j - 1, i):
                v = max(dp[m][j - 1], prefix[i] - prefix[m])
                if v < dp[i][j]:
                    dp[i][j] = v
                    cut[i][j] = m
    bounds = [n]
    i, j = n, k
    while j > 0:
        i = cut[i][j]
        bounds.append(i)
        j -= 1
    return list(reversed(bounds))


def pipeline_ticks(n_stages: int, n_micro: int, b_local: int) -> int:
    """The schedule's tick count for a local batch of `b_local`."""
    return clamp_microbatches(n_micro or n_stages, b_local) + n_stages - 1


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def cut_buffer_elems(plan: PcgPipelinePlan) -> int:
    """f32 elements a sample of the inter-stage buffer: the widest cut,
    or the output where that is wider (the last stage sends it)."""
    return max(plan.buf_elems, _numel(plan.out_shape[1:]))


def pack_cut(vals, cut, mb: int, buf_elems: int):
    """Cut `cut`'s tensors of `vals` ({guid: (mb, ...)}) flattened into
    one (mb, buf_elems) f32 buffer, zero-padded."""
    parts = [vals[guid].float().reshape(mb, -1) for guid, _, _ in cut]
    flat = torch.cat(parts, dim=1)
    return torch.nn.functional.pad(flat, (0, buf_elems - flat.shape[1]))


def unpack_cut(buf, cut, mb: int):
    """{guid: tensor} of cut `cut` from a (mb, buf_elems) f32 buffer, each
    in its shape and dtype."""
    vals, off = {}, 0
    for guid, shp, dt in cut:
        size = _numel(shp)
        vals[guid] = buf[:, off:off + size].reshape((mb,) + tuple(shp)).to(
            dt)
        off += size
    return vals


def gpipe_pcg_local(plan: PcgPipelinePlan, stage_runners: List, params,
                    inputs_local: List, input_guids: List[int], *,
                    n_micro: int, group):
    """One rank's program of the generalized schedule: its stage's runner
    (`stage_runners[stage](params, vals, tick) -> vals`) on every tick,
    the graph inputs injected at stage 0, the cut tensors carried in a
    (micro-batch, buf_elems) f32 buffer. Returns the graph output for the
    local batch, the same on every rank of the pipe group."""
    n_stages = plan.n_stages
    stage = _check_group(group, n_stages)
    last = n_stages - 1
    b_local = inputs_local[0].shape[0]
    n_micro = clamp_microbatches(n_micro or n_stages, b_local)
    out_flat = _numel(plan.out_shape[1:])
    buf_elems = cut_buffer_elems(plan)
    mb = b_local // n_micro
    mbs = [a.reshape((n_micro, mb) + tuple(a.shape[1:]))
           for a in inputs_local]
    dev = inputs_local[0].device
    out_cut = [(plan.out_guid, plan.out_shape[1:], plan.out_dtype)]
    runner = stage_runners[stage]
    ticks = n_micro + n_stages - 1
    buf = torch.zeros((mb, buf_elems), dtype=torch.float32, device=dev)
    outbuf = [torch.zeros((mb, out_flat), dtype=torch.float32, device=dev)
              for _ in range(n_micro)]
    for t in range(ticks):
        if stage == 0:
            vals = dict(zip(input_guids,
                            [m[min(t, n_micro - 1)] for m in mbs]))
        else:
            vals = unpack_cut(buf, plan.cuts[stage - 1], mb)
        vals = runner(params, vals, t)
        y = pack_cut(vals, out_cut if stage == last else plan.cuts[stage],
                     mb, buf_elems)
        if stage == 0:
            # stage 0 reads no hop: keep the one it received in the graph
            y = _select(True, y, buf)
        out_idx = t - last
        oi = min(max(out_idx, 0), n_micro - 1)
        outbuf[oi] = _select(stage == last and out_idx >= 0,
                             y[:, :out_flat], outbuf[oi])
        if t < ticks - 1:
            (buf,) = ring_shift((y,), group)
    out = _PipeSum.apply(torch.stack(outbuf), group)
    # the weights of the other stages, and the graph inputs past stage 0
    out = _ZeroGrads.apply(out, *(t for t in list(inputs_local) + [
        w for ws in params.values() for w in ws.values()]
        if t.requires_grad))
    return out.reshape((b_local,) + tuple(plan.out_shape[1:])).to(
        plan.out_dtype)


def gpipe_pcg(plan: PcgPipelinePlan, stage_runners: List, params,
              input_arrays: List, input_guids: List[int], mesh, *,
              n_micro: int = 0, axis_name: str = "pipe",
              data_axis: str = "data"):
    """Run the planned stages as a GPipe schedule on DTensors (the JAX
    package's `gpipe_pcg`): `params` ({op: {weight: DTensor}}) held
    whole on every rank (JAX's P()), the graph inputs Shard(0) over
    `data_axis`; each rank runs `gpipe_pcg_local` through `local_map`.
    The output is Shard(0) over the data axis, replicated over the pipe
    axis; every weight's gradient comes out partial over data and pipe,
    so the step's sync sums it over both (JAX's pvary of the params)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    keys = [(op, n) for op, ws in params.items() for n in ws]
    group = mesh.device_mesh.get_group(axis_name)
    x_pl = _placements(mesh, {data_axis: Shard(0)})
    x_grad = _placements(mesh, {data_axis: Shard(0), axis_name: Partial()})
    w_pl = _placements(mesh, {})
    w_grad = _placements(mesh, {data_axis: Partial(),
                                axis_name: Partial()})
    n_in = len(input_arrays)

    def per_rank(*flat):
        local_params: Dict[str, Dict[str, torch.Tensor]] = {}
        for (op, n), w in zip(keys, flat[n_in:]):
            local_params.setdefault(op, {})[n] = w
        return gpipe_pcg_local(plan, stage_runners, local_params,
                               list(flat[:n_in]), input_guids,
                               n_micro=n_micro, group=group)

    return local_map(
        per_rank, out_placements=x_pl,
        in_placements=(x_pl,) * n_in + (w_pl,) * len(keys),
        in_grad_placements=(x_grad,) * n_in + (w_grad,) * len(keys),
        device_mesh=mesh.device_mesh, redistribute_inputs=True)(
            *input_arrays, *(params[op][n] for op, n in keys))
