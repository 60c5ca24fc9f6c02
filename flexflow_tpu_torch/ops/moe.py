"""Mixture-of-Experts operators: GroupBy, Aggregate, AggregateSpec, Cache.

The PyTorch counterpart of flexflow_tpu/ops/moe.py (reference:
src/ops/group_by.cc, aggregate.cc, aggregate_spec.cc, cache.cc). As in
the JAX package, routing is the dense dispatch/combine formulation
(GShard style): a 0/1 dispatch mask [tokens * k, experts, capacity]
turns the routing into two matrix products, which the port leaves to
torch.matmul (cuBLAS on a card) as JAX leaves its einsums to XLA. Tokens
past an expert's capacity are dropped, as the reference's fixed-size
expert buffers drop them.

The mask is built by comparison, never by one-hot encoding a slot
index: JAX's `one_hot(pos - 1)` maps both the (token, expert) pairs that
were not chosen (pos - 1 = -1) and the dropped ones (pos - 1 >=
capacity) to a zero row, where `F.one_hot` raises on the CPU and
device-asserts on a card. Clamping the index into range would route
those pairs to a real slot.

Precision follows JAX: group_by casts the mask to the input's dtype (bf16
under mixed precision); aggregate keeps it, the gate weights and the
expert outputs in f32 and casts its output to the experts' dtype.
Determinism on a card: each mask row has at most one 1, so the dispatch
and combine products and the expert gradients sum one nonzero term (any
order gives the same bits); the gate's gradient is a cuBLAS product and a
reduction, both run to run equal; the token copies for the k choices are
a broadcast (its gradient a sum over k), not `repeat_interleave`, whose
backward adds with atomics.

Load balancing: Aggregate adds the Switch Transformer's balance loss,
lambda_bal * n * sum_e f_e * P_e, through `ctx.add_aux_loss` (the
reference folds lambda_bal into the gate gradients in aggregate.cc's
backward): f_e is the share of (token, choice) pairs dispatched to e,
detached, and P_e the mean softmax probability of e over the full gate.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..ff_types import DataType, OperatorType
from .registry import WeightSpec, register_op


def _capacity(batch_tokens: int, k: int, n: int, alpha: float) -> int:
    """reference: group_by.cc max_size = (int)ceil(alpha * k / n * batch)"""
    return max(1, int(math.ceil(alpha * k / n * batch_tokens)))


def dispatch_mask(assign: torch.Tensor, n: int,
                  capacity: int) -> torch.Tensor:
    """The f32 [b * k, n, capacity] dispatch mask of the assignments
    ([b, k] expert ids): row t (token t // k's choice t % k) has a 1 at
    (its expert, its 1-based rank among that expert's rows - 1) if the
    rank is within capacity, else no 1 at all. A row's rank counts the
    rows of the whole batch before it, so on a mesh the assignments are
    gathered whole first and the mask comes back replicated."""
    from ..parallel.mesh import gathered, like

    flat = gathered(assign, "dispatch_mask").reshape(-1).long()
    onehot = flat[:, None] == torch.arange(n, device=flat.device)
    pos = torch.cumsum(onehot.int(), dim=0) * onehot  # 0: not chosen
    slots = torch.arange(1, capacity + 1, device=flat.device)
    return like((pos[..., None] == slots).float(), assign)


def dropped_share(assign: torch.Tensor, n: int, capacity: int) -> float:
    """The share of (token, choice) pairs that capacity drops."""
    mask = dispatch_mask(assign, n, capacity)
    return 1.0 - float(mask.sum()) / max(1, assign.numel())


@dataclasses.dataclass(frozen=True)
class GroupByParams:
    """reference: include/flexflow/ops/groupby_params.h"""

    n: int  # number of experts
    alpha: float = 1.0  # capacity factor


def _gb_infer(params: GroupByParams, in_shapes, in_dtypes):
    inp, assign = in_shapes  # [b, d], [b, k]
    cap = _capacity(inp[0], assign[-1], params.n, params.alpha)
    return [(cap, inp[-1])] * params.n, [in_dtypes[0]] * params.n


def _gb_forward(params: GroupByParams, w, x, ctx):
    inp, assign = x  # [b, d], [b, k]
    b, d = inp.shape[0], inp.shape[-1]
    k = assign.shape[-1]
    cap = _capacity(b, k, params.n, params.alpha)
    mask = dispatch_mask(assign, params.n, cap).to(inp.dtype)
    rep = inp[:, None, :].expand(b, k, d).reshape(b * k, d)
    # einsum("td,tnc->ncd"): [n * cap, b * k] @ [b * k, d]
    packed = (mask.reshape(b * k, params.n * cap).t() @ rep).reshape(
        params.n, cap, d)
    return [packed[e] for e in range(params.n)]


register_op(OperatorType.OP_GROUP_BY, "GroupBy", infer=_gb_infer,
            forward=_gb_forward, num_inputs=2)


@dataclasses.dataclass(frozen=True)
class AggregateParams:
    """reference: include/flexflow/ops/aggregate_params.h"""

    n: int
    lambda_bal: float = 0.0


def _agg_infer(params: AggregateParams, in_shapes, in_dtypes):
    # gate_preds [b, k], gate_assign [b, k], true_gate_assign [b, k],
    # full_gate_grads [b, n], then n expert outputs [cap, d]
    # (reference: aggregate.cc ctor, 4 + n inputs)
    return [(in_shapes[0][0], in_shapes[4][-1])], [in_dtypes[4]]


def _combine(gate_preds, gate_assign, exp_preds, n):
    """The gate-weighted sum of each token's expert outputs, f32 [b, d],
    and the f32 dispatch mask."""
    b, k = gate_preds.shape
    cap, d = exp_preds[0].shape
    stacked = torch.stack(exp_preds, dim=0).float().reshape(n * cap, d)
    mask = dispatch_mask(gate_assign, n, cap)  # [b * k, n, cap]
    combine = mask * gate_preds.reshape(-1)[:, None, None].float()
    # einsum("ncd,tnc->td"): [b * k, n * cap] @ [n * cap, d]
    per_slot = combine.reshape(b * k, n * cap) @ stacked
    return per_slot.reshape(b, k, d).sum(dim=1), mask


def _agg_forward(params: AggregateParams, w, x, ctx):
    gate_preds, gate_assign, exp_preds = x[0], x[1], x[4:]
    out, mask = _combine(gate_preds, gate_assign, exp_preds, params.n)
    if params.lambda_bal > 0.0:
        b, k = gate_preds.shape
        probs = torch.softmax(x[3].float(), dim=-1)  # the full gate [b, n]
        p_mean = probs.mean(dim=0)
        f = (mask.sum(dim=(0, 2)) / max(1, b * k)).detach()
        ctx.add_aux_loss(params.lambda_bal * params.n
                         * torch.sum(f * p_mean))
    return [out.to(exp_preds[0].dtype)]


register_op(OperatorType.OP_AGGREGATE, "Aggregate", infer=_agg_infer,
            forward=_agg_forward, num_inputs=-1)


@dataclasses.dataclass(frozen=True)
class AggregateSpecParams:
    """reference: include/flexflow/ops/aggregate_spec_params.h --
    speculative aggregation: each of a token's k expert predictions
    is kept on its own row (model.cc:2875 replicates the labels)."""

    n: int
    lambda_bal: float = 0.0


def _aggspec_infer(params: AggregateSpecParams, in_shapes, in_dtypes):
    # gate_preds [b, k], gate_assign [b, k], then n expert outputs
    b, k = in_shapes[0][0], in_shapes[0][1]
    return [(b * k, in_shapes[2][-1])], [in_dtypes[2]]


def _aggspec_forward(params: AggregateSpecParams, w, x, ctx):
    gate_assign, exp_preds = x[1], x[2:]
    cap, d = exp_preds[0].shape
    n = params.n
    stacked = torch.stack(exp_preds, dim=0).float().reshape(n * cap, d)
    mask = dispatch_mask(gate_assign, n, cap)
    out = mask.reshape(-1, n * cap) @ stacked
    return [out.to(exp_preds[0].dtype)]


register_op(OperatorType.OP_AGG_SPEC, "AggregateSpec", infer=_aggspec_infer,
            forward=_aggspec_forward, num_inputs=-1)


@dataclasses.dataclass(frozen=True)
class CacheParams:
    """reference: include/flexflow/ops/cache_params.h -- caches an input
    across batches (the MoE gating cache). The cache is an f32 buffer in
    TrainState.net_state: training passes the live input through and
    blends it into the buffer (an exponential average over ~num_batches,
    the horizon of the reference's window of num_batches snapshots);
    inference serves the cached value once it has been written."""

    num_batches: int = 1


def _cache_state(params: CacheParams, in_shapes, in_dtypes):
    # f32 whatever the input's dtype: the blend is float math, and a
    # buffer keeps its dtype across the update (a captured scan writes it
    # in place)
    return [WeightSpec("cached", tuple(in_shapes[0]), DataType.DT_FLOAT,
                       "zero"),
            WeightSpec("filled", (1,), DataType.DT_FLOAT, "zero")]


def _cache_forward_stateful(params: CacheParams, weights, state, inputs,
                            ctx):
    (x,) = inputs
    if not state:
        return [x], {}
    if ctx.training:
        alpha = 1.0 / max(1, params.num_batches)
        filled = torch.clamp(state["filled"] + 1.0, max=1.0)
        xf = x.to(state["cached"].dtype)
        cached = torch.where(state["filled"] > 0,
                             (1.0 - alpha) * state["cached"] + alpha * xf,
                             xf)
        return [x], {"cached": cached, "filled": filled}
    out = torch.where(state["filled"] > 0, state["cached"].to(x.dtype), x)
    return [out], state


register_op(OperatorType.OP_CACHE, "Cache",
            infer=lambda p, s, dt: ([s[0]], [dt[0]]),
            forward=lambda p, w, x, ctx: [x[0]],
            state_spec=_cache_state,
            forward_stateful=_cache_forward_stateful)
