"""Substitution-rule soundness lint.

The PyTorch counterpart of flexflow_tpu/analysis/substitution_lint.py.

Symbolically checks every declarative rewrite rule (TASO-style JSON,
search/substitutions/*.json) at load time instead of letting a broken
rule blow up — or silently mis-rewrite — deep inside the search:

  * interface arity: tensor refs must point backwards at existing ops,
    mapped outputs must be in range, rules need sources and outputs;
  * sharding preservation under symbolic degrees: each side of the rule
    is abstract-interpreted over a symbolic sharding state (external
    input dims are free symbols, parallel ops transform them) and every
    mapped output's src/dst states are unified — two concrete degrees
    that disagree (e.g. partition-by-2 answered by combine-by-4) make
    the rule unsound; symbol-vs-concrete differences become match-time
    preconditions, exactly how the reference's pattern matcher treats
    them;
  * required params: an AllToAll destination without scatter/gather
    dims would KeyError mid-search.

Codes: FFA401 arity/reference, FFA402 unsound sharding, FFA403
unsupported op type (warning — the loader skips these, like the
reference), FFA404 missing required param, FFA405 dead pattern output
(warning), FFA406 dst op with no param source (warning), FFA407
unsound precision substitution (bad PM_PRECISION value, or a
low-precision accumulating dst op that does not declare its
PM_ACCUM_PRECISION).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..ff_types import DataType, OperatorType
from .diagnostics import AnalysisReport, Severity

_PARALLEL_TYPES = {
    OperatorType.OP_REPARTITION,
    OperatorType.OP_COMBINE,
    OperatorType.OP_REPLICATE,
    OperatorType.OP_REDUCTION,
    OperatorType.OP_ALL_TO_ALL,
    OperatorType.OP_WEIGHT_SHARD,
}

# symbolic degree of external input k's dim d
Sym = Tuple[str, int, object]


def _sym(k: int, dim) -> Sym:
    return ("in", k, dim)


@dataclasses.dataclass
class _ShardState:
    """Sharding state of one tensor: overrides on top of a symbolic base
    (base = external-input index whose unwritten dims are free symbols;
    None = fully fresh tensor, unwritten dims unsharded)."""

    base: Optional[int] = None
    over: Dict[object, object] = dataclasses.field(default_factory=dict)
    replica: object = 1  # replica-dim degree product (int or Sym)

    def lookup(self, dim):
        if dim in self.over:
            return self.over[dim]
        if self.base is not None:
            return _sym(self.base, dim)
        return 1

    def child(self) -> "_ShardState":
        return _ShardState(self.base, dict(self.over), self.replica)


class _RuleCtx:
    def __init__(self, rule, rep: AnalysisReport):
        self.rule = rule
        self.rep = rep
        self.pre: Dict[Sym, int] = {}  # match-time preconditions

    def _name(self):
        return self.rule.name

    def error(self, code, msg, fix_hint=None):
        self.rep.add(Severity.ERROR, code, f"rule {self._name()!r}: {msg}",
                     fix_hint=fix_hint)

    def warn(self, code, msg):
        self.rep.add(Severity.WARNING, code, f"rule {self._name()!r}: {msg}")

    def require(self, val, expect: int, what: str):
        """val must equal `expect`: concrete mismatch = unsound; a symbol
        becomes a precondition (and conflicting preconditions are
        unsound)."""
        if isinstance(val, int):
            if val != expect:
                self.error("FFA402", f"{what}: requires degree {expect} but "
                                     f"the dim carries {val}")
            return
        prev = self.pre.get(val)
        if prev is not None and prev != expect:
            self.error("FFA402", f"{what}: conflicting preconditions on "
                                 f"input dim {val[1:]}: {prev} vs {expect}")
        self.pre[val] = expect


def _transform(pat, in_states: List[_ShardState], ctx: _RuleCtx,
               rank_hint: int) -> _ShardState:
    t = pat.op_type
    if not in_states:
        return _ShardState()
    st = in_states[0].child()
    p = pat.params
    if t == OperatorType.OP_REPARTITION:
        st.over[p.get("PM_PARALLEL_DIM", 0)] = p.get("PM_PARALLEL_DEGREE", 2)
        return st
    if t == OperatorType.OP_COMBINE:
        d = p.get("PM_PARALLEL_DIM", 0)
        g = p.get("PM_PARALLEL_DEGREE", 2)
        ctx.require(st.lookup(d), g, f"Combine(dim={d}, degree={g})")
        st.over[d] = 1
        return st
    if t == OperatorType.OP_REPLICATE:
        g = p.get("PM_PARALLEL_DEGREE", 2)
        if isinstance(st.replica, int):
            st.replica = st.replica * g
        return st
    if t == OperatorType.OP_REDUCTION:
        g = p.get("PM_PARALLEL_DEGREE", 2)
        if isinstance(st.replica, int):
            if st.replica % g != 0:
                ctx.error("FFA402", f"Reduction(degree={g}) but the tensor "
                                    f"carries replica degree {st.replica}")
            else:
                st.replica //= g
        return st
    if t == OperatorType.OP_WEIGHT_SHARD:
        # identity on the activation's sharding state: WeightShard moves
        # parameter STORAGE onto the fsdp axis (weight_sharding.py) and
        # never reshards the flowing tensor. Requires an explicit degree
        # >= 2 — a degree-less rule would silently build a 2-way default.
        deg = p.get("PM_PARALLEL_DEGREE")
        if not isinstance(deg, int) or deg < 2:
            ctx.error("FFA404", "WeightShard needs PM_PARALLEL_DEGREE >= 2",
                      fix_hint="add PM_PARALLEL_DEGREE to the dst op's "
                               "para list")
        return st
    if t == OperatorType.OP_ALL_TO_ALL:
        s, g = p.get("PM_SCATTER_DIM"), p.get("PM_GATHER_DIM")
        deg = p.get("PM_PARALLEL_DEGREE", 2)
        if s is None or g is None:
            ctx.error("FFA404", "AllToAll needs PM_SCATTER_DIM and "
                                "PM_GATHER_DIM",
                      fix_hint="add both dims to the dst op's para list")
            return st
        ctx.require(st.lookup(g), deg,
                    f"AllToAll gather dim {g} (degree {deg})")
        ctx.require(st.lookup(s), 1, f"AllToAll scatter dim {s}")
        st.over[g] = 1
        st.over[s] = deg
        return st
    # -- compute ops ------------------------------------------------------
    if t == OperatorType.OP_BATCHMATMUL and len(in_states) == 2:
        a, b = in_states
        n_dim, k_dim = rank_hint - 1, rank_hint - 2
        va = a.lookup(n_dim)
        if isinstance(va, int) and va > 1:
            ctx.error("FFA402", "batchmatmul lhs contraction dim "
                                f"{n_dim} partitioned {va}-way: partial "
                                "sums need an OP_REDUCTION, not plain "
                                "degree propagation")
        st = a.child()
        st.over[n_dim] = 1
        for dim, v in b.over.items():
            if dim == n_dim:
                st.over[n_dim] = v
            elif dim == k_dim:
                if isinstance(v, int) and v > 1:
                    ctx.error("FFA402", "batchmatmul rhs contraction dim "
                                        f"{k_dim} partitioned {v}-way: "
                                        "needs an OP_REDUCTION")
            else:
                st.over[dim] = v
        return st
    if t == OperatorType.OP_LINEAR:
        st.over["last"] = 1  # fresh out-channel dim (weight-owned)
        return st
    if t == OperatorType.OP_CONV2D:
        st.over[1] = 1  # fresh NCHW channel dim
        return st
    if t == OperatorType.OP_GROUP_BY:
        # expert dispatch [tokens, d] -> n x [capacity, d]: the capacity
        # dim is fresh (NOT the token dim — it must come out unsharded),
        # the hidden dim keeps the token input's sharding
        st.over[0] = 1
        return st
    if t == OperatorType.OP_AGGREGATE:
        # expert combine: the token dim follows the gate input, the
        # hidden dim follows the expert tensors, capacity disappears
        exp = in_states[4] if len(in_states) > 4 else in_states[-1]
        out = _ShardState()
        out.over[0] = in_states[0].lookup(0)
        out.over[1] = exp.lookup(1)
        return out
    if t == OperatorType.OP_TOPK:
        st.over["last"] = 1  # fresh k dim
        return st
    # rank-preserving default (activations, softmax, elementwise,
    # attention, embedding, split, noop, ...)
    return st


def _rank_hint(rule) -> int:
    """Best-effort rank for batchmatmul dim arithmetic: the largest
    concrete dim index any pattern in the rule mentions, plus one."""
    hi = 2
    for pat in rule.src_ops + rule.dst_ops:
        for key in ("PM_PARALLEL_DIM", "PM_SCATTER_DIM", "PM_GATHER_DIM"):
            v = pat.params.get(key)
            if isinstance(v, int):
                hi = max(hi, v + 1)
    return hi


def _eval_side(ops, ctx: _RuleCtx, side: str,
               rank: int) -> List[Optional[_ShardState]]:
    states: List[Optional[_ShardState]] = []
    for oi, pat in enumerate(ops):
        in_states: List[_ShardState] = []
        for ri, ref in enumerate(pat.inputs):
            if ref.ts_id < 0:
                ctx.error("FFA401", f"{side}Op[{oi}] input {ri}: negative "
                                    f"tsId {ref.ts_id}")
                in_states.append(_ShardState())
            elif ref.op_id < 0:
                in_states.append(_ShardState(base=-1 - ref.op_id))
            elif ref.op_id >= oi:
                ctx.error("FFA401", f"{side}Op[{oi}] input {ri} references "
                                    f"op {ref.op_id}, which is not defined "
                                    "yet (refs must point backwards)")
                in_states.append(_ShardState())
            elif states[ref.op_id] is None:
                in_states.append(_ShardState())
            else:
                in_states.append(states[ref.op_id])
        if pat.op_type is None:
            states.append(None)
            continue
        states.append(_transform(pat, in_states, ctx, rank))
    return states


# Valid targets for a PM_PRECISION / PM_ACCUM_PRECISION declaration: the
# float members of DataType (a rule that stamps DT_INT32 as a compute
# dtype is nonsense, and an out-of-enum int raises deep in apply_rule).
_FLOAT_DTYPES = {
    int(DataType.DT_HALF),
    int(DataType.DT_BF16),
    int(DataType.DT_FLOAT),
    int(DataType.DT_DOUBLE),
}
_LOW_PRECISION = {int(DataType.DT_HALF), int(DataType.DT_BF16)}
# ops that accumulate (matmul / attention / reductions): the JAX
# package's analysis/precision.py _ACCUMULATING
_ACCUMULATING = frozenset({
    OperatorType.OP_LINEAR, OperatorType.OP_CONV2D,
    OperatorType.OP_BATCHMATMUL, OperatorType.OP_MATMUL,
    OperatorType.OP_MULTIHEAD_ATTENTION, OperatorType.OP_AGGREGATE,
    OperatorType.OP_AGG_SPEC, OperatorType.OP_REDUCE_SUM,
    OperatorType.OP_REDUCE_MEAN, OperatorType.OP_MEAN,
    OperatorType.OP_POOL2D, OperatorType.OP_LAYERNORM,
    OperatorType.OP_BATCHNORM, OperatorType.OP_SOFTMAX,
    OperatorType.OP_REDUCTION,
})


def _lint_precision(rule, ctx: _RuleCtx) -> None:
    """FFA407: precision-rewrite soundness.

    A substitution that narrows compute precision must (a) name a real
    float dtype and (b), when the destination op accumulates (matmul /
    attention / reductions — _ACCUMULATING above), declare the accum
    dtype it keeps wide, so the FFA702 invariant survives the rewrite.
    """
    for side, ops in (("src", rule.src_ops), ("dst", rule.dst_ops)):
        for oi, pat in enumerate(ops):
            for key in ("PM_PRECISION", "PM_ACCUM_PRECISION"):
                v = pat.params.get(key)
                if v is not None and v not in _FLOAT_DTYPES:
                    ctx.error(
                        "FFA407",
                        f"{side}Op[{oi}] ({pat.type_str}): {key}={v!r} is "
                        "not a float DataType member",
                        fix_hint="use the int value of DT_HALF/DT_BF16/"
                                 "DT_FLOAT/DT_DOUBLE",
                    )
    for oi, pat in enumerate(rule.dst_ops):
        prec = pat.params.get("PM_PRECISION")
        if prec in _LOW_PRECISION and pat.op_type in _ACCUMULATING \
                and pat.params.get("PM_ACCUM_PRECISION") is None:
            ctx.error(
                "FFA407",
                f"dstOp[{oi}] ({pat.type_str}) narrows compute to "
                f"{DataType(prec).name} but declares no accumulator "
                "dtype for an accumulating op",
                fix_hint="add PM_ACCUM_PRECISION (typically DT_FLOAT) "
                         "to the dst op's para list",
            )


def lint_rule(rule) -> AnalysisReport:
    rep = AnalysisReport()
    ctx = _RuleCtx(rule, rep)
    if not rule.src_ops:
        ctx.error("FFA401", "no source pattern ops")
    if not rule.dst_ops:
        ctx.error("FFA401", "no destination ops")
    _lint_precision(rule, ctx)
    if not rule.mapped_outputs:
        # legal in the reference wire format (matches only sites whose
        # outputs have no outside consumers) but almost always a mistake
        ctx.warn("FFA405", "no mapped outputs — the rewrite can only "
                           "match ops whose outputs nobody consumes")
    if not rule.supported:
        bad = sorted({p.type_str for p in rule.src_ops + rule.dst_ops
                      if p.op_type is None})
        ctx.warn("FFA403", f"unsupported op type(s) {bad}; the loader "
                           "skips this rule")
        return rep  # cannot reason about unknown semantics
    if rep.errors:
        return rep
    # Tensor ranks are not declared in the rule schema, and batchmatmul's
    # dim roles (batch / contraction / column) depend on them. Interpret
    # charitably: a rule is sound if SOME rank makes it sound — apply_rule
    # rejects mismatched-rank sites at match time (its contraction-dim
    # guard), so only a rule broken at EVERY rank is truly unsound.
    base = _rank_hint(rule)
    has_bmm = any(p.op_type == OperatorType.OP_BATCHMATMUL
                  for p in rule.src_ops + rule.dst_ops)
    candidates = [base + k for k in range(3)] if has_bmm else [base]
    attempt = None
    for rank in candidates:
        attempt = _lint_rule_at_rank(rule, rank)
        if attempt.ok:
            break
    rep.extend(attempt)
    return rep


def _lint_rule_at_rank(rule, rank: int) -> AnalysisReport:
    rep = AnalysisReport()
    ctx = _RuleCtx(rule, rep)
    src_states = _eval_side(rule.src_ops, ctx, "src", rank)
    dst_states = _eval_side(rule.dst_ops, ctx, "dst", rank)

    # dst compute ops need a same-typed src op to inherit params from
    # (apply_rule raises KeyError at every site otherwise = dead rule)
    src_types = [p.op_type for p in rule.src_ops]
    for oi, pat in enumerate(rule.dst_ops):
        if pat.op_type in _PARALLEL_TYPES or \
                pat.op_type == OperatorType.OP_NOOP or \
                "PM_MERGE" in pat.params:
            continue
        if pat.op_type == OperatorType.OP_SPLIT and any(
                "PM_MERGE" in d.params for d in rule.dst_ops):
            continue
        if pat.op_type not in src_types:
            ctx.warn("FFA406", f"dstOp[{oi}] ({pat.type_str}) has no "
                               "source op of the same type to inherit "
                               "params from; the rule can never apply")

    # dead pattern outputs: a src output neither consumed inside the
    # pattern nor mapped restricts matching to zero-consumer sites
    consumed = {(r.op_id, r.ts_id) for p in rule.src_ops for r in p.inputs
                if r.op_id >= 0}
    mapped_src = {(s, ts) for (s, ts, _, _) in rule.mapped_outputs}
    for oi in range(len(rule.src_ops)):
        if (oi, 0) not in consumed and (oi, 0) not in mapped_src:
            ctx.warn("FFA405", f"srcOp[{oi}] output 0 is neither consumed "
                               "by the pattern nor a mapped output")

    # unify mapped outputs
    for mi, (s_op, s_ts, d_op, d_ts) in enumerate(rule.mapped_outputs):
        if not (0 <= s_op < len(rule.src_ops)):
            ctx.error("FFA401", f"mappedOutput[{mi}]: srcOpId {s_op} out "
                                f"of range ({len(rule.src_ops)} src ops)")
            continue
        if not (0 <= d_op < len(rule.dst_ops)):
            ctx.error("FFA401", f"mappedOutput[{mi}]: dstOpId {d_op} out "
                                f"of range ({len(rule.dst_ops)} dst ops)")
            continue
        ss, ds = src_states[s_op], dst_states[d_op]
        if ss is None or ds is None:
            continue
        for dim in sorted(set(ss.over) | set(ds.over), key=str):
            va, vb = ss.lookup(dim), ds.lookup(dim)
            if va == vb:
                continue
            if isinstance(va, int) and isinstance(vb, int):
                ctx.error(
                    "FFA402",
                    f"mappedOutput[{mi}] (srcOp[{s_op}] -> dstOp[{d_op}]) "
                    f"is not sharding-preserving on dim {dim}: src degree "
                    f"{va}, dst degree {vb}",
                    fix_hint="balance the partition/combine degrees on "
                             "both sides of the rule",
                )
            elif isinstance(va, int):
                ctx.require(vb, va, f"mappedOutput[{mi}] dim {dim}")
            elif isinstance(vb, int):
                ctx.require(va, vb, f"mappedOutput[{mi}] dim {dim}")
        ra, rb = ss.replica, ds.replica
        if isinstance(ra, int) and isinstance(rb, int) and ra != rb:
            ctx.error("FFA402", f"mappedOutput[{mi}]: replica degree "
                                f"{ra} (src) != {rb} (dst)")
    return rep


def lint_rules(rules) -> AnalysisReport:
    rep = AnalysisReport()
    for rule in rules:
        rep.extend(lint_rule(rule))
    return rep


def analyze_rules_path(path: str) -> AnalysisReport:
    """Lint one substitution-collection JSON file. Malformed JSON becomes
    FFA401 diagnostics rather than raising, so the CLI can report every
    file it was given."""
    from ..search.substitution_loader import (
        SubstitutionRuleError,
        load_rule_collection_from_path,
    )

    try:
        rules = load_rule_collection_from_path(path, validate=False)
    except SubstitutionRuleError as e:
        rep = AnalysisReport()
        rep.add(Severity.ERROR, "FFA401", str(e))
        return rep
    except (OSError, ValueError) as e:
        rep = AnalysisReport()
        rep.add(Severity.ERROR, "FFA401", f"{path}: {e}")
        return rep
    return lint_rules(rules)
