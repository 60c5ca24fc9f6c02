"""Declarative substitution-rule loader (TASO-style JSON).

The PyTorch counterpart of flexflow_tpu/search/substitution_loader.py
(reference: src/runtime/substitution_loader.cc +
substitutions/graph_subst_3_v2.json): rules are {srcOp[], dstOp[],
mappedOutput[]} where each Operator has a `type` string, `input` tensor refs
{opId, tsId} (opId = -1-k means rule input k), and `para` key/value
constraints (PM_PARALLEL_DIM / PM_PARALLEL_DEGREE / ...). The same JSON files
the reference ships load here (--substitution-json).

Application (reference: GraphXfer::run, substitution.cc:596): brute-force
subgraph match of the source pattern (patterns are tiny), parameter
constraint checks, then rewrite — dst parallel ops are built from their
`para` values, dst compute ops inherit the params of their matched source
op of the same type.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Dict, Iterator, List, Optional, Tuple

from ..ff_types import ActiMode, DataType, OperatorType
from ..parallel.parallel_ops import (
    AllToAllParams,
    CombineParams,
    ReductionParams,
    ReplicateParams,
    RepartitionParams,
)
from ..pcg.graph import Graph
from ..pcg.op import PCGOp
from ..pcg.parallel_tensor import ParallelDim, ParallelTensor
from .substitution import Substitution, copy_graph, _consumers

# reference op-type strings (substitution_loader.h NLOHMANN enum maps) →
# our OperatorType. Only types we can execute are mapped; rules touching
# unmapped types are reported unsupported.
_TYPE_MAP = {
    "OP_PARTITION": OperatorType.OP_REPARTITION,
    "OP_REPARTITION": OperatorType.OP_REPARTITION,
    "OP_COMBINE": OperatorType.OP_COMBINE,
    "OP_REPLICATE": OperatorType.OP_REPLICATE,
    "OP_REDUCE": OperatorType.OP_REDUCTION,
    "OP_REDUCTION": OperatorType.OP_REDUCTION,
    "OP_LINEAR": OperatorType.OP_LINEAR,
    "OP_CONV2D": OperatorType.OP_CONV2D,
    "OP_RELU": OperatorType.OP_RELU,
    "OP_GELU": OperatorType.OP_GELU,
    "OP_SIGMOID": OperatorType.OP_SIGMOID,
    "OP_TANH": OperatorType.OP_TANH,
    "OP_SOFTMAX": OperatorType.OP_SOFTMAX,
    "OP_EW_ADD": OperatorType.OP_EW_ADD,
    "OP_EW_MUL": OperatorType.OP_EW_MUL,
    "OP_MATMUL": OperatorType.OP_BATCHMATMUL,
    "OP_BATCHMATMUL": OperatorType.OP_BATCHMATMUL,
    "OP_CONCAT": OperatorType.OP_CONCAT,
    "OP_SPLIT": OperatorType.OP_SPLIT,
    "OP_RESHAPE": OperatorType.OP_RESHAPE,
    "OP_TRANSPOSE": OperatorType.OP_TRANSPOSE,
    "OP_DROPOUT": OperatorType.OP_DROPOUT,
    "OP_MULTIHEAD_ATTENTION": OperatorType.OP_MULTIHEAD_ATTENTION,
    "OP_EMBEDDING": OperatorType.OP_EMBEDDING,
    "OP_POOL2D_MAX": OperatorType.OP_POOL2D,
    "OP_POOL2D_AVG": OperatorType.OP_POOL2D,
    "OP_FLAT": OperatorType.OP_FLAT,
    "OP_NOOP": OperatorType.OP_NOOP,
    "OP_ALLTOALL": OperatorType.OP_ALL_TO_ALL,
    "OP_ALL_TO_ALL": OperatorType.OP_ALL_TO_ALL,
    "OP_WEIGHT_SHARD": OperatorType.OP_WEIGHT_SHARD,
    # MoE routing ops (workload zoo: expert-parallel rewrite rules)
    "OP_GROUP_BY": OperatorType.OP_GROUP_BY,
    "OP_GROUPBY": OperatorType.OP_GROUP_BY,
    "OP_AGGREGATE": OperatorType.OP_AGGREGATE,
    "OP_TOPK": OperatorType.OP_TOPK,
    "OP_TOP_K": OperatorType.OP_TOPK,
}

_PARALLEL_TYPES = {
    OperatorType.OP_REPARTITION,
    OperatorType.OP_COMBINE,
    OperatorType.OP_REPLICATE,
    OperatorType.OP_REDUCTION,
    OperatorType.OP_ALL_TO_ALL,
    OperatorType.OP_WEIGHT_SHARD,
}

# Ops whose params carry a fusable `activation` field (reference: cuDNN
# epilogue fusion, conv_2d.cc/linear.cc fused activation). PM_ACTI on a
# src pattern constrains it; PM_ACTI on a dst op sets it.
_ACTIVATION_TYPES = {
    OperatorType.OP_LINEAR,
    OperatorType.OP_CONV2D,
}
# activation-op type -> the ActiMode a fusion rule folds it into
ACTI_OF_OP = {
    OperatorType.OP_RELU: ActiMode.AC_MODE_RELU,
    OperatorType.OP_GELU: ActiMode.AC_MODE_GELU,
    OperatorType.OP_SIGMOID: ActiMode.AC_MODE_SIGMOID,
    OperatorType.OP_TANH: ActiMode.AC_MODE_TANH,
}


class SubstitutionRuleError(ValueError):
    """A substitution rule is malformed or unsound, detected at LOAD time
    (the alternative is a KeyError or a silent mis-rewrite deep inside
    the search). Carries the rule name and the offending field."""

    def __init__(self, rule: str, field: str, message: str):
        self.rule = rule
        self.field = field
        super().__init__(f"substitution rule {rule!r}, {field}: {message}")


@dataclasses.dataclass
class TensorRef:
    """reference: substitution_loader.h Tensor{opId, tsId}"""

    op_id: int  # >=0: pattern op index; <0: rule input (-1 - input_idx)
    ts_id: int


@dataclasses.dataclass
class OpPattern:
    """reference: substitution_loader.h Operator"""

    type_str: str
    op_type: Optional[OperatorType]
    inputs: List[TensorRef]
    params: Dict[str, int]


@dataclasses.dataclass
class Rule:
    """reference: substitution_loader.h Rule"""

    name: str
    src_ops: List[OpPattern]
    dst_ops: List[OpPattern]
    mapped_outputs: List[Tuple[int, int, int, int]]  # (srcOpId, srcTsId, dstOpId, dstTsId)

    @property
    def supported(self) -> bool:
        return all(p.op_type is not None for p in self.src_ops + self.dst_ops)


def _parse_op(d: dict, rule: str, where: str) -> OpPattern:
    if not isinstance(d, dict):
        raise SubstitutionRuleError(rule, where, f"operator is {type(d).__name__}, "
                                                "expected an object")
    if not isinstance(d.get("type"), str):
        raise SubstitutionRuleError(rule, f"{where}.type",
                                    "missing or non-string op type")
    inputs = []
    for i, t in enumerate(d.get("input", [])):
        for key in ("opId", "tsId"):
            if not isinstance(t, dict) or not isinstance(t.get(key), int):
                raise SubstitutionRuleError(
                    rule, f"{where}.input[{i}].{key}",
                    "missing or non-integer tensor ref field")
        inputs.append(TensorRef(t["opId"], t["tsId"]))
    params = {}
    for i, p in enumerate(d.get("para", [])):
        if not isinstance(p, dict) or not isinstance(p.get("key"), str) \
                or not isinstance(p.get("value"), int):
            raise SubstitutionRuleError(
                rule, f"{where}.para[{i}]",
                "parameter entries need a string 'key' and integer 'value'")
        params[p["key"]] = p["value"]
    return OpPattern(
        type_str=d["type"],
        op_type=_TYPE_MAP.get(d["type"]),
        inputs=inputs,
        params=params,
    )


def load_rule_collection(obj: dict, validate: bool = True) -> List[Rule]:
    """reference: substitution_loader.cc load_rule_collection.

    With `validate=True` (the default) every rule is structurally parsed
    AND symbolically vetted by the analyzer's substitution lint
    (analysis/substitution_lint.py); malformed or unsound rules raise a
    typed SubstitutionRuleError naming the rule and the offending field,
    instead of failing deep inside the search. Rules with unsupported op
    types load fine and are skipped later, like the reference."""
    rules = []
    for r in obj.get("rule", []):
        name = r.get("name", f"rule_{len(rules)}")
        if not isinstance(name, str):
            raise SubstitutionRuleError(str(name), "name",
                                        "rule name must be a string")
        mapped = []
        for i, m in enumerate(r.get("mappedOutput", [])):
            for key in ("srcOpId", "srcTsId", "dstOpId", "dstTsId"):
                if not isinstance(m, dict) or not isinstance(m.get(key), int):
                    raise SubstitutionRuleError(
                        name, f"mappedOutput[{i}].{key}",
                        "missing or non-integer mapped-output field")
            mapped.append((m["srcOpId"], m["srcTsId"], m["dstOpId"],
                           m["dstTsId"]))
        rules.append(
            Rule(
                name=name,
                src_ops=[_parse_op(o, name, f"srcOp[{i}]")
                         for i, o in enumerate(r.get("srcOp", []))],
                dst_ops=[_parse_op(o, name, f"dstOp[{i}]")
                         for i, o in enumerate(r.get("dstOp", []))],
                mapped_outputs=mapped,
            )
        )
    if validate:
        from ..analysis.substitution_lint import lint_rule

        for rule in rules:
            errs = lint_rule(rule).errors
            if errs:
                raise SubstitutionRuleError(rule.name, errs[0].code,
                                            errs[0].message)
    return rules


def load_rule_collection_from_path(path: str, validate: bool = True
                                   ) -> List[Rule]:
    """reference: substitution_loader.cc load_rule_collection_from_path"""
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            raise SubstitutionRuleError(path, "json", str(e)) from e
    return load_rule_collection(obj, validate=validate)


def default_rules_path() -> str:
    """The shipped rule collection: a copy of the JAX package's (made by
    its tools/generate_substitutions.py; reference analog:
    substitutions/graph_subst_3_v2.json)."""
    import os

    return os.path.join(os.path.dirname(__file__), "substitutions",
                        "graph_subst_tpu_v1.json")


def zoo_rules_path() -> str:
    """Workload-zoo expert-routing rules (the JAX package's): loaded
    alongside the default collection. The capacity-factor rewrite
    (moe_capacity_v1.json, same directory) is NOT loaded by default —
    it changes numerics (token dropping) and must be opted into via
    --substitution-json."""
    import os

    return os.path.join(os.path.dirname(__file__), "substitutions",
                        "graph_subst_zoo_v1.json")


def moe_capacity_rules_path() -> str:
    """The opt-in capacity-factor rewrite collection (token-dropping <->
    dropless). Not loaded by default — see zoo_rules_path."""
    import os

    return os.path.join(os.path.dirname(__file__), "substitutions",
                        "moe_capacity_v1.json")


# ---------------------------------------------------------------------------
# rule application
# ---------------------------------------------------------------------------

_PARALLEL_DEGREE_ATTR = {
    OperatorType.OP_REPARTITION: "repartition_degree",
    OperatorType.OP_COMBINE: "combine_degree",
    OperatorType.OP_REPLICATE: "replicate_degree",
    OperatorType.OP_REDUCTION: "reduction_degree",
    OperatorType.OP_ALL_TO_ALL: "degree",
    OperatorType.OP_WEIGHT_SHARD: "shard_degree",
}
_PARALLEL_DIM_ATTR = {
    OperatorType.OP_REPARTITION: "repartition_dim",
    OperatorType.OP_COMBINE: "combine_dim",
    OperatorType.OP_REPLICATE: "replicate_dim",
    OperatorType.OP_REDUCTION: "reduction_dim",
    OperatorType.OP_ALL_TO_ALL: "scatter_dim",
    # OP_WEIGHT_SHARD has no dim attribute: it shards weight storage,
    # not an activation dim (a PM_PARALLEL_DIM constraint never matches)
}


def _op_matches(op: PCGOp, pat: OpPattern) -> bool:
    if op.op_type != pat.op_type:
        return False
    # parameter constraints the pattern pins down. BOTH degree and dim
    # must match for parallel ops: an elision rule for
    # combine(dim0)->partition(dim0) must not fire on combine(dim0)->
    # partition(dim1), which is a real reshard, not an identity.
    if op.op_type in _PARALLEL_TYPES:
        deg = pat.params.get("PM_PARALLEL_DEGREE")
        if deg is not None and getattr(
                op.params, _PARALLEL_DEGREE_ATTR[op.op_type]) != deg:
            return False
        dim = pat.params.get("PM_PARALLEL_DIM")
        dim_attr = _PARALLEL_DIM_ATTR.get(op.op_type)
        if dim is not None and (
                dim_attr is None or getattr(op.params, dim_attr) != dim):
            return False
    acti = pat.params.get("PM_ACTI")
    if acti is not None:
        # fusion-rule guard: only fuse into an op whose epilogue slot is
        # free (AC_MODE_NONE) — and never match an op lacking the field
        cur = getattr(op.params, "activation", None)
        if cur is None or int(cur) != acti:
            return False
    capx = pat.params.get("PM_CAPACITY_FACTOR_X100")
    if capx is not None:
        # capacity-factor rewrite guard (token-dropping <-> dropless):
        # pin the src group_by to one declared alpha so the rewrite and
        # its inverse don't ping-pong on the same site
        alpha = getattr(op.params, "alpha", None)
        if alpha is None or round(alpha * 100) != capx:
            return False
    prec = pat.params.get("PM_PRECISION")
    if prec is not None:
        # precision-rewrite guard (analysis/precision.py): the src
        # pattern pins the op's OUTPUT effective dtype (value = the
        # DataType enum member), so a quantizing rule fires only on ops
        # still computing at the dtype it demotes — and its inverse
        # can't ping-pong on the same site
        if not op.outputs:
            return False
        t = op.outputs[0]
        eff = t.compute_dtype if t.compute_dtype is not None \
            else t.data_type
        if int(eff) != prec:
            return False
    return True


def _match_pattern(graph: Graph, rule: Rule) -> Iterator[Dict[int, PCGOp]]:
    """Yield {pattern op index -> graph op} assignments satisfying types,
    connectivity, and shared-input constraints."""
    prod = graph.producers()
    cands: List[List[PCGOp]] = []
    for pat in rule.src_ops:
        cands.append([op for op in graph.ops if _op_matches(op, pat)])
        if not cands[-1]:
            return
    for combo in itertools.product(*cands):
        if len({op.guid for op in combo}) != len(combo):
            continue
        assign = dict(enumerate(combo))
        # connectivity: pattern input (opId>=0) must be produced by the
        # assigned op at the right output index; rule inputs (opId<0) must
        # be consistent across uses
        ext_inputs: Dict[int, int] = {}  # rule-input id -> tensor guid
        ok = True
        for pi, pat in enumerate(rule.src_ops):
            op = assign[pi]
            if len(pat.inputs) > len(op.inputs):
                ok = False
                break
            for slot, ref in enumerate(pat.inputs):
                t = op.inputs[slot]
                if ref.op_id >= 0:
                    p = prod.get(t.guid)
                    if p is None or p[0] is not assign.get(ref.op_id) or p[1] != ref.ts_id:
                        ok = False
                        break
                else:
                    key = ref.op_id * 1000 + ref.ts_id
                    if key in ext_inputs and ext_inputs[key] != t.guid:
                        ok = False
                        break
                    ext_inputs[key] = t.guid
            if not ok:
                break
        if ok:
            yield assign


def _build_parallel_params(op_type: OperatorType, para: Dict[str, int]):
    dim = para.get("PM_PARALLEL_DIM", 0)
    deg = para.get("PM_PARALLEL_DEGREE", 2)
    if op_type == OperatorType.OP_REPARTITION:
        return RepartitionParams(dim, deg)
    if op_type == OperatorType.OP_COMBINE:
        return CombineParams(dim, deg)
    if op_type == OperatorType.OP_REPLICATE:
        return ReplicateParams(dim, deg)
    if op_type == OperatorType.OP_REDUCTION:
        return ReductionParams(dim, deg)
    if op_type == OperatorType.OP_ALL_TO_ALL:
        return AllToAllParams(
            scatter_dim=para["PM_SCATTER_DIM"],
            gather_dim=para["PM_GATHER_DIM"],
            degree=deg,
        )
    if op_type == OperatorType.OP_WEIGHT_SHARD:
        from ..parallel.weight_sharding import WeightShardParams

        return WeightShardParams(shard_degree=deg)
    raise ValueError(op_type)


def apply_rule(graph: Graph, rule: Rule) -> Iterator[Graph]:
    """Apply one declarative rule everywhere it matches, yielding rewritten
    graphs (reference: GraphXfer::run building a new graph per match)."""
    if not rule.supported:
        return
    mapped_src = {(s_op, s_ts) for (s_op, s_ts, _, _) in rule.mapped_outputs}
    for assign in _match_pattern(graph, rule):
        # interior outputs of matched ops (not in mappedOutput) must have
        # no consumers OUTSIDE the match — removing their producer would
        # otherwise orphan a live tensor (reference: GraphXfer::run's
        # mapped-output completeness check, substitution.cc:596)
        matched_guids0 = {op.guid for op in assign.values()}
        escaped = False
        for pi, op in assign.items():
            for ts, t in enumerate(op.outputs):
                if (pi, ts) in mapped_src:
                    continue
                if any(c.guid not in matched_guids0
                       for c, _ in _consumers(graph, t)):
                    escaped = True
                    break
            if escaped:
                break
        if escaped:
            continue
        g2, tmap = copy_graph(graph)
        matched = {i: next(o for o in g2.ops if o.name == assign[i].name)
                   for i in assign}
        # resolve rule-external inputs from the matched subgraph
        def resolve_ext(ref: TensorRef) -> ParallelTensor:
            # pattern semantics: opId = -1 - k is the k-th external input;
            # find it on any matched op that referenced it
            for pi, pat in enumerate(rule.src_ops):
                for slot, r in enumerate(pat.inputs):
                    if (r.op_id, r.ts_id) == (ref.op_id, ref.ts_id):
                        return matched[pi].inputs[slot]
            raise KeyError(ref)

        # build dst ops in order
        new_ops: List[PCGOp] = []
        used_src: set = set()
        merge_sizes: List[int] = []  # out_channels of PM_MERGE'd src ops

        def params_from_matched(op_type: OperatorType):
            for pi, pat in enumerate(rule.src_ops):
                if pat.op_type == op_type and pi not in used_src:
                    used_src.add(pi)
                    return matched[pi].params, matched[pi]
            return None, None

        try:
            for dpat in rule.dst_ops:
                ins: List[ParallelTensor] = []
                for ref in dpat.inputs:
                    if ref.op_id < 0:
                        ins.append(resolve_ext(ref))
                    else:
                        ins.append(new_ops[ref.op_id].outputs[ref.ts_id])
                fresh_weights = False
                if dpat.op_type in _PARALLEL_TYPES:
                    params = _build_parallel_params(dpat.op_type, dpat.params)
                    src_params_op = None
                elif dpat.op_type == OperatorType.OP_NOOP:
                    # structural rules (e.g. combine->partition elision)
                    # synthesize identity NOOPs with no source to inherit
                    from ..ops.tensor_ops import NoOpParams

                    params, src_params_op = NoOpParams(), None
                elif "PM_MERGE" in dpat.params:
                    # merge-parallel-ops rewrite (TASO's merge_group_convs /
                    # merge two matmuls into one — reference:
                    # substitutions/graph_subst_3_v2.json merge rules):
                    # N matched src ops of this type sharing one input
                    # become ONE op with summed out_channels; weights are
                    # rebuilt fresh at the merged shape (substitutions run
                    # before weight materialization, as in the reference
                    # where the PCG is rewritten pre-allocation).
                    n = dpat.params["PM_MERGE"]
                    parts = []
                    for _ in range(n):
                        p, o = params_from_matched(dpat.op_type)
                        if p is None:
                            raise KeyError(f"merge needs {n} {dpat.op_type}")
                        parts.append((p, o))
                    # merged kernels rebuild weights fresh from initializer
                    # specs: firing on an already-materialized graph would
                    # silently discard trained values — hard error, not a
                    # skipped site (see executor.init_params)
                    if getattr(g2, "weights_materialized", False) or \
                            getattr(graph, "weights_materialized", False):
                        raise MergeAfterMaterializationError(
                            "PM_MERGE rule applied to a graph whose weights "
                            "were already materialized; merge substitutions "
                            "must run pre-materialization (before "
                            "executor.init_params)"
                        )
                    # _attach_fresh_weights inherits initializer kinds from
                    # the FIRST source op only; if the sources disagree
                    # (e.g. zeros- vs glorot-init bias) the merged init
                    # would mis-initialize the second slice — reject
                    if any(_init_kinds(o) != _init_kinds(parts[0][1])
                           for _, o in parts[1:]):
                        raise ValueError(
                            "merge: source ops' initializer kinds differ"
                        )
                    base = dataclasses.replace(parts[0][0], out_channels=0)
                    if any(dataclasses.replace(p, out_channels=0) != base
                           for p, _ in parts[1:]):
                        raise ValueError("merge: op params differ beyond "
                                         "out_channels")
                    merge_sizes[:] = [p.out_channels for p, _ in parts]
                    params = dataclasses.replace(
                        parts[0][0], out_channels=sum(merge_sizes))
                    src_params_op = parts[0][1]
                    fresh_weights = True
                else:
                    params, src_params_op = params_from_matched(dpat.op_type)
                    if params is None:
                        if dpat.op_type == OperatorType.OP_SPLIT \
                                and merge_sizes:
                            # the un-merge tail of a PM_MERGE rule: restore
                            # the original per-op output channels
                            from ..ops.tensor_ops import SplitParams

                            params = SplitParams(
                                sizes=tuple(merge_sizes),
                                axis=dpat.params.get("PM_AXIS", -1),
                            )
                        else:
                            raise KeyError(
                                f"no source op to inherit {dpat.op_type}")
                acti = dpat.params.get("PM_ACTI")
                if acti is not None and \
                        dpat.op_type in _ACTIVATION_TYPES:
                    # epilogue fusion: fold the matched activation op into
                    # the producer's fused-activation slot
                    params = dataclasses.replace(
                        params, activation=ActiMode(acti))
                capx = dpat.params.get("PM_CAPACITY_FACTOR_X100")
                if capx is not None and \
                        dpat.op_type == OperatorType.OP_GROUP_BY:
                    # capacity-factor rewrite: the dst dispatch re-declares
                    # alpha (int x100 — the wire format is integer-only);
                    # output shape inference below re-derives the capacity
                    params = dataclasses.replace(params,
                                                 alpha=capx / 100.0)
                # a compute op rebuilt from one source op (its params and
                # weights inherited) is that op resharded: it keeps the
                # source's name, which the executor keys its weights by
                # and a stored strategy's replay and the verifier match
                # ops by (a merge builds a new op and a new name)
                keep_name = (src_params_op is not None and not fresh_weights
                             and dpat.op_type not in _PARALLEL_TYPES)
                nop = PCGOp(dpat.op_type, params, ins,
                            name=src_params_op.name if keep_name else "")
                # infer output shape
                outs = _infer_outputs(nop, src_params_op)
                for t in outs:
                    t.owner_op = nop
                    nop.outputs.append(t)
                # PM_PRECISION / PM_ACCUM_PRECISION on a dst op stamp the
                # precision annotation (values = DataType enum members)
                # the FFA7xx pass and verify's drift-budget tolerances
                # then audit; FFA407 vets the declaration at load time
                prec = dpat.params.get("PM_PRECISION")
                accp = dpat.params.get("PM_ACCUM_PRECISION")
                if prec is not None or accp is not None:
                    for t in nop.outputs:
                        if prec is not None:
                            t.compute_dtype = DataType(prec)
                        if accp is not None:
                            t.accum_dtype = DataType(accp)
                if fresh_weights:
                    _attach_fresh_weights(nop, src_params_op)
                elif src_params_op is not None:
                    nop.weights = list(src_params_op.weights)
                    nop.weight_names = list(src_params_op.weight_names)
                    nop.weight_tags = list(getattr(src_params_op, "weight_tags", []))
                    nop.initializers = dict(src_params_op.initializers)
                # PM_PARALLEL_DEGREE on a dst COMPUTE op shards its
                # "head"-tagged weight dims (attribute parallelism as a
                # declarative rule — reference substitution.cc:1764
                # create_partition_attention_combine, expressed in JSON)
                deg = dpat.params.get("PM_PARALLEL_DEGREE")
                if deg and dpat.op_type not in _PARALLEL_TYPES:
                    sharded = False
                    for w, tags in zip(nop.weights,
                                       getattr(nop, "weight_tags", [])):
                        for i, tag in enumerate(tags):
                            if tag == "head" and w.dims[i].size % deg == 0 \
                                    and w.dims[i].degree == 1:
                                w.dims[i].degree = deg
                                sharded = True
                    if not sharded:
                        raise ValueError(
                            "PM_PARALLEL_DEGREE on a compute op needs a "
                            "divisible, unsharded head-tagged weight dim"
                        )
                if nop.op_type == OperatorType.OP_WEIGHT_SHARD:
                    # a dst WeightShard shards its PRODUCER's weights
                    # (FSDP/ZeRO — parallel/weight_sharding.py); a site
                    # whose producer carries no shardable weights is
                    # inapplicable, like any other failed constraint
                    from ..parallel.weight_sharding import shard_op_weights

                    target = ins[0].owner_op if ins else None
                    if target is None or not getattr(target, "weights", None):
                        raise ValueError(
                            "weight_shard dst: input has no weight-carrying "
                            "producer"
                        )
                    shard_op_weights(target, nop.params.shard_degree)
                new_ops.append(nop)
        except MergeAfterMaterializationError:
            raise  # a caller bug, not an inapplicable site — surface it
        except Exception:  # fflint: disable=FFL002 — inapplicable match site
            continue

        # rewire mapped outputs: consumers of src outputs now read dst
        ok = True
        for (s_op, s_ts, d_op, d_ts) in rule.mapped_outputs:
            try:
                old_t = matched[s_op].outputs[s_ts]
                new_t = new_ops[d_op].outputs[d_ts]
            except (KeyError, IndexError):
                ok = False
                break
            for op, i in _consumers(g2, old_t):
                op.inputs[i] = new_t
        if not ok:
            continue
        # drop matched src ops, add dst ops
        matched_guids = {m.guid for m in matched.values()}
        g2.ops = [o for o in g2.ops if o.guid not in matched_guids]
        for nop in new_ops:
            g2.add_op(nop)
        g2._producer_cache = None
        if g2.check_correctness():
            yield g2


class MergeAfterMaterializationError(AssertionError):
    """A PM_MERGE substitution fired on a graph whose weights were already
    materialized (executor.init_params sets graph.weights_materialized) —
    the merged op's fresh-built weights would discard trained values."""


def _init_kinds(op: Optional[PCGOp]) -> dict:
    """Initializer KIND per weight name (string spec or initializer class
    name) — merge compatibility is about the kind, not the instance."""
    if op is None:
        return {}
    return {
        name: (v if isinstance(v, str) else type(v).__name__)
        for name, v in getattr(op, "initializers", {}).items()
    }


def _attach_fresh_weights(op: PCGOp, init_src: Optional[PCGOp]) -> None:
    """Build weights at the op's own (post-rewrite) shape from the
    registry spec — used by merge rewrites, whose merged kernel has no
    single source weight to inherit (lowering.py does the same for
    freshly lowered layers). Initializer kinds carry over from the first
    merged source op so e.g. a zeros-init bias stays zeros-init."""
    from ..ops.registry import get_op_def

    d = get_op_def(op.op_type)
    in_shapes = [t.material_shape() for t in op.inputs]
    in_dtypes = [t.data_type for t in op.inputs]
    op.weights, op.weight_names, op.weight_tags = [], [], []
    op.initializers = {}
    src_inits = init_src.initializers if init_src is not None else {}
    for spec in d.weights(op.params, in_shapes, in_dtypes):
        wpt = ParallelTensor(
            dims=[ParallelDim(size=s, degree=1) for s in spec.shape],
            data_type=spec.dtype,
            owner_op=op,
            create_gradients=True,
        )
        op.weights.append(wpt)
        op.weight_names.append(spec.name)
        op.weight_tags.append(spec.parallel_dim_tags)
        op.initializers[spec.name] = src_inits.get(spec.name, spec.initializer)


def _infer_outputs(op: PCGOp, src_op: Optional[PCGOp]) -> List[ParallelTensor]:
    from ..ops.registry import get_op_def

    if op.op_type in _PARALLEL_TYPES:
        # shape preserved; degree bookkeeping on the affected dim
        in_t = op.inputs[0]
        dims = [dataclasses.replace(d) for d in in_t.dims]
        p = op.params
        if op.op_type == OperatorType.OP_REPARTITION:
            dims[p.repartition_dim].degree = p.repartition_degree
        elif op.op_type == OperatorType.OP_COMBINE:
            dims[p.combine_dim].degree = 1
        elif op.op_type == OperatorType.OP_REDUCTION:
            if dims and dims[0].is_replica_dim:
                dims = dims[1:]
        elif op.op_type == OperatorType.OP_ALL_TO_ALL:
            # one collective replaces a combine(gather_dim)+partition
            # (scatter_dim) reshard pair: the gathered dim must enter at
            # exactly `degree`, the scattered dim unsharded and divisible
            g, s, d = p.gather_dim, p.scatter_dim, p.degree
            if dims[g].degree != d or dims[s].degree != 1 \
                    or dims[s].size % d != 0:
                raise ValueError("all_to_all: dims not resharddable")
            dims[g].degree = 1
            dims[s].degree = d
        # parallel ops move shards, never change numerics: the precision
        # flow carries straight through the reshard
        return [ParallelTensor(dims=dims, data_type=in_t.data_type,
                               compute_dtype=in_t.compute_dtype)]
    d = get_op_def(op.op_type)
    shapes, dtypes = d.infer(
        op.params,
        [t.material_shape() for t in op.inputs],
        [t.data_type for t in op.inputs],
    )
    outs = [
        ParallelTensor(
            dims=[ParallelDim(size=s, degree=1) for s in shape], data_type=dt
        )
        for shape, dt in zip(shapes, dtypes)
    ]
    # Propagate input partition degrees to outputs (reference: each op's
    # ParallelDimMappingRecords, operator.h:22-49). Without this a rule's
    # partition/compute/combine sandwich is cosmetic: the DP only grants
    # an op multi-part machine views when its OUTPUT degree says so
    # (dp_search.valid_views keys off get_total_degree).
    t = op.op_type
    ins = op.inputs
    for out in outs:
        if t == OperatorType.OP_BATCHMATMUL and len(ins) == 2:
            a, b = ins
            # a partitioned contraction dim is a PARTIAL SUM needing
            # OP_REDUCTION — degree propagation can't express it, and
            # silently dropping the degree lets the search mis-price the
            # candidate (e.g. a "batch" rule matched against a rank-2
            # matmul, where rhs dim 0 IS the contraction dim). Raising
            # here makes apply_rule skip the match site.
            if a.dims[-1].degree > 1 or b.dims[-2].degree > 1:
                raise ValueError(
                    "batchmatmul contraction dim partitioned: needs an "
                    "OP_REDUCTION rewrite, not degree propagation"
                )
            # (..., m, k) x (..., k, n): batch+m dims follow a, n follows b
            for i in range(len(out.dims) - 1):
                if i < len(a.dims) - 1:
                    out.dims[i].degree = a.dims[i].degree
            out.dims[-1].degree = b.dims[-1].degree
        elif t == OperatorType.OP_LINEAR and ins:
            for i in range(len(out.dims) - 1):
                if i < len(ins[0].dims):
                    out.dims[i].degree = ins[0].dims[i].degree
        elif t == OperatorType.OP_GROUP_BY and ins:
            # expert dispatch: the fresh capacity dim is unsharded (it is
            # not the token dim — the rank-preserving default below would
            # wrongly carry the token degree onto it); the hidden dim
            # follows the token input
            if len(out.dims) >= 2 and len(ins[0].dims) >= 2:
                out.dims[-1].degree = ins[0].dims[-1].degree
        elif t == OperatorType.OP_AGGREGATE and len(ins) >= 5:
            # expert combine: token dim follows the gate input, hidden dim
            # follows the expert tensors; the capacity dim disappears
            out.dims[0].degree = ins[0].dims[0].degree
            out.dims[-1].degree = ins[4].dims[-1].degree
        elif t == OperatorType.OP_TOPK and ins:
            # the fresh k dim stays unsharded; token dims follow the input
            for i in range(len(out.dims) - 1):
                if i < len(ins[0].dims):
                    out.dims[i].degree = ins[0].dims[i].degree
        elif ins and len(ins[0].dims) == len(out.dims):
            # rank-preserving (elementwise / softmax / activations):
            # positionwise carry-over from the first input
            for i in range(len(out.dims)):
                out.dims[i].degree = ins[0].dims[i].degree
    return outs


def rules_to_substitutions(rules: List[Rule]) -> List[Substitution]:
    """Wrap loaded rules as Substitution objects for the best-first search
    (skips unsupported rules, like the reference skips unknown op types)."""
    subs = []
    for rule in rules:
        if not rule.supported:
            continue

        def make_apply(r):
            def apply(graph: Graph) -> Iterator[Graph]:
                yield from apply_rule(graph, r)

            return apply

        subs.append(Substitution(f"json:{rule.name}", make_apply(rule)))
    return subs
