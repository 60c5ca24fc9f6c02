"""The static analyzers of flexflow_tpu_torch (analysis/, utils/) against
the JAX package's, on the CPU.

The same graphs go through both packages' passes: the zoo's models
lowered at small sizes (the flagship Transformer at 2 blocks of width 64,
BERT imported through PyTorchModel, AlexNet at 67x67, DLRM, the MoE
Transformer), the 8-simulated-worker search winner of the small
Transformer (the JAX package's tile quanta on the chip spec, as in
tests/test_torch_port_search.py), and the JAX tests' planted faults.

Tolerances: the passes are host Python over the same integers and floats
in the same order in both packages, so diagnostics must match as
multisets of (code, severity, op name) — planted faults, whose ops the
tests build directly and whose names carry per-package guids, by (code,
severity) — and byte and precision estimates must be equal exactly.
"""
import collections
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu.analysis as janalysis
import flexflow_tpu.search as jsearch
import flexflow_tpu_torch as tff
import flexflow_tpu_torch.analysis as tanalysis
import flexflow_tpu_torch.search as tsearch
from flexflow_tpu.analysis import collectives as jcoll
from flexflow_tpu.analysis import schedule as jsched
from flexflow_tpu.frontends.torch import PyTorchModel as JPyTorchModel
from flexflow_tpu.models import alexnet as jalex
from flexflow_tpu.models import dlrm as jdlrm
from flexflow_tpu.models import transformer as jtransformer
from flexflow_tpu.models import zoo as jzoo
from flexflow_tpu.ops import elementwise as jew
from flexflow_tpu.ops import linear as jlin
from flexflow_tpu.ops import softmax as jsoft
from flexflow_tpu.parallel import parallel_ops as jpar
from flexflow_tpu.pcg import graph as jgraph
from flexflow_tpu.pcg import lowering as jlowering
from flexflow_tpu.pcg import machine_view as jmv
from flexflow_tpu.pcg import op as jop
from flexflow_tpu.pcg import parallel_tensor as jpt
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.utils import debug as jdebug
from flexflow_tpu.utils import graph_utils as jgu
from flexflow_tpu_torch.analysis import collectives as tcoll
from flexflow_tpu_torch.analysis import schedule as tsched
from flexflow_tpu_torch.frontends.torch import PyTorchModel
from flexflow_tpu_torch.models import BertEncoder
from flexflow_tpu_torch.models import alexnet as talex
from flexflow_tpu_torch.models import dlrm as tdlrm
from flexflow_tpu_torch.models import transformer as ttransformer
from flexflow_tpu_torch.models import zoo as tzoo
from flexflow_tpu_torch.ops import elementwise as tew
from flexflow_tpu_torch.ops import linear as tlin
from flexflow_tpu_torch.ops import softmax as tsoft
from flexflow_tpu_torch.parallel import parallel_ops as tpar
from flexflow_tpu_torch.pcg import graph as tgraph
from flexflow_tpu_torch.pcg import lowering as tlowering
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.pcg import op as top
from flexflow_tpu_torch.pcg import parallel_tensor as tpt
from flexflow_tpu_torch.utils import debug as tdebug
from flexflow_tpu_torch.utils import graph_utils as tgu

MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"
HBM = 1 << 30
PORT_DIR = pathlib.Path(__file__).resolve().parent.parent / "flexflow_tpu_torch"

# one namespace per package: the same test code builds in either
NS = {
    "jax": types.SimpleNamespace(
        ff=jff, an=janalysis, search=jsearch, Graph=jgraph.Graph,
        PCGOp=jop.PCGOp, pt=jpt, mv=jmv, lin=jlin, ew=jew, soft=jsoft,
        par=jpar, low=jlowering, coll=jcoll, sched=jsched),
    "port": types.SimpleNamespace(
        ff=tff, an=tanalysis, search=tsearch, Graph=tgraph.Graph,
        PCGOp=top.PCGOp, pt=tpt, mv=tmv, lin=tlin, ew=tew, soft=tsoft,
        par=tpar, low=tlowering, coll=tcoll, sched=tsched),
}


@pytest.fixture(autouse=True)
def _no_jax_calibration(monkeypatch):
    """The JAX side prices with the analytic roofline alone, as the port
    does (its shipped fit is a measurement of its own chip)."""
    monkeypatch.setattr(jcm, "load_default_calibration", lambda: None)


def _cfg(ns, **kw):
    if ns.ff is tff:
        return tff.FFConfig(device="cpu", **kw)
    cfg = jff.FFConfig()
    cfg.workersPerNode = 1
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _machine(ns, workers=1):
    """The JAX package's machine (its chip's tile quanta) in both."""
    return ns.search.MachineModel(num_nodes=1, workers_per_node=workers)


def _cost_model(ns, workers=1, **kw):
    if ns.ff is jff:
        kw.setdefault("calibration", False)
    return ns.search.CostModel(_machine(ns, workers), **kw)


# ----------------------------------------------------------------------
# the zoo, lowered in both packages
# ----------------------------------------------------------------------
def _transformer(ns, m):
    (jtransformer if ns.ff is jff else ttransformer).build_transformer(
        m, 4, 16, 64, 4, 2)


def _alexnet(ns, m):
    (jalex if ns.ff is jff else talex).build_alexnet(
        m, 2, num_classes=10, height=67, width=67)


def _dlrm(ns, m):
    (jdlrm if ns.ff is jff else tdlrm).build_dlrm(
        m, 16, embedding_sizes=(100,) * 2, mlp_bot=(16, 32),
        mlp_top=(32, 2))


def _moe_transformer(ns, m):
    (jzoo if ns.ff is jff else tzoo).build_moe_transformer(
        m, 4, num_experts=4, top_k=2, capacity_factor=1.2, lambda_bal=0.04,
        seq_length=16, hidden_size=64, num_heads=4, num_layers=2)


def _bert(ns, m):
    import torch

    torch.manual_seed(0)
    module = BertEncoder(2, 64, 4, 128, 0.1, 0.1)
    x = m.create_tensor((2, 16, 64), ns.ff.DataType.DT_FLOAT)
    (JPyTorchModel if ns.ff is jff else PyTorchModel)(module).torch_to_ff(
        m, [x])


ZOO = {"transformer": _transformer, "bert": _bert, "alexnet": _alexnet,
       "dlrm": _dlrm, "moe_transformer": _moe_transformer}


def _lowered(ns, name, mixed=False):
    m = ns.ff.FFModel(_cfg(ns, batch_size=4))
    ZOO[name](ns, m)
    g = ns.low.layers_to_pcg(m.layers)[0]
    ns.an.annotate_graph_precision(
        g, compute_dtype=ns.ff.DataType.DT_BF16 if mixed else None)
    return g


def _diag_set(rep, names=True):
    """(code, severity, op name) multiset; the names of ops a rewrite
    built carry their guid, which counts per package: it is masked."""
    return collections.Counter(
        (d.code, d.severity.name)
        + ((re.sub(r"_\d{6,}$", "_<guid>", d.op_name),) if names else ())
        for d in rep)


def _both(fn):
    return fn(NS["jax"]), fn(NS["port"])


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("name", sorted(ZOO))
def test_analyze_graph_on_the_zoo_matches_jax(name, mixed):
    def run(ns):
        g = _lowered(ns, name, mixed)
        return ns.an.analyze_graph(
            g, num_devices=1, hbm_bytes=HBM,
            optimizer=ns.ff.SGDOptimizer(lr=0.01, momentum=0.9),
            grad_bytes_ratio=0.5 if mixed else 1.0,
            cost_model=_cost_model(ns),
            grad_dtype=ns.ff.DataType.DT_BF16 if mixed else None)

    jrep, trep = _both(run)
    assert _diag_set(trep) == _diag_set(jrep)
    assert [d.message for d in trep] == [d.message for d in jrep]


@pytest.mark.parametrize("name", ["transformer", "dlrm", "moe_transformer"])
def test_estimates_and_precision_annotation_match_jax(name):
    def run(ns):
        g = _lowered(ns, name, mixed=True)
        flow = [(t.compute_dtype and t.compute_dtype.name,
                 t.accum_dtype and t.accum_dtype.name)
                for op in g.topo_order() for t in op.outputs]
        mem = ns.an.estimate_per_device_bytes(
            g, None, 1, optimizer=ns.ff.AdamOptimizer(),
            grad_bytes_ratio=0.5)
        coll = [(r["op"], r["kind"], r["bytes"], r["parts"])
                for r in ns.coll.estimate_collective_bytes(g)]
        total, per_op = ns.an.estimate_drift(g)
        # by op name: guids count per package
        names = {op.guid: op.name for op in g.ops}
        drift = (total, {names[k]: v for k, v in per_op.items()})
        return flow, mem, coll, drift

    (jflow, jmem, jcoll_, jdrift), (tflow, tmem, tcoll_, tdrift) = _both(run)
    assert tflow == jflow
    assert tmem == jmem
    assert tcoll_ == jcoll_
    assert tdrift == jdrift


def _machine_file(tmp_path, workers):
    p = tmp_path / f"machine_{workers}.cfg"
    p.write_text(f"num_nodes = 1\nnum_gpus_per_node = {workers}\n"
                 "intra_node_bandwidth = 90e9\ninter_node_bandwidth = 25e9\n")
    return str(p)


def _searched_pair(tmp_path, workers=8, budget=4, mixed=False):
    out = []
    for ns in (NS["jax"], NS["port"]):
        m = ns.ff.FFModel(_cfg(
            ns, batch_size=8, search_budget=budget,
            allow_mixed_precision=mixed,
            machine_model_file=_machine_file(tmp_path, workers)))
        (jtransformer if ns.ff is jff else ttransformer).build_transformer(
            m, 8, 64, 128, 8, 2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m.compile(ns.ff.SGDOptimizer(lr=0.01),
                      getattr(ns.ff.LossType, MSE))
        out.append(m)
    return out


def _lint_events(traj):
    return [(e["kind"], e["errors"], e["warnings"], e["codes"])
            for e in traj.events if e["kind"] in ("perf_lint",
                                                  "precision_lint")]


def test_eight_worker_winner_analyzes_like_jax(tmp_path):
    """The 8-simulated-worker winner (the JAX package's quanta on the
    chip spec): every pass over the searched views, the compile's lint
    events, and the validator hook."""
    jm, tm = _searched_pair(tmp_path)

    def run(ns, m):
        return ns.an.analyze_graph(
            m.graph, views=m.searched_views, num_devices=8, hbm_bytes=HBM,
            optimizer=m.optimizer, cost_model=m._build_cost_model())

    jrep, trep = run(NS["jax"], jm), run(NS["port"], tm)
    assert _diag_set(trep) == _diag_set(jrep)
    assert _lint_events(tm.search_trajectory) == \
        _lint_events(jm.search_trajectory)
    assert [k for k, *_ in _lint_events(tm.search_trajectory)] == \
        ["perf_lint", "precision_lint"]
    def masked(v):
        return [re.sub(r"\d{6,}", "<guid>", s) for s in v]

    assert masked(tanalysis.strategy_violations(
        tm.graph, tm.searched_views, 8)) == masked(
        janalysis.strategy_violations(jm.graph, jm.searched_views, 8))


def test_a_wider_winner_is_judged_against_its_machine():
    """A winner searched for 8 H100s with 4-part views, demoted onto the
    one device: analyze_model judges the views against the machine they
    address (no FFA205), where the one live device would flag them, and
    fit(lint="error") trains it."""
    m = tff.FFModel(tff.FFConfig(batch_size=32, device="cpu",
                                 search_budget=2, search_num_workers=8,
                                 allow_mixed_precision=True))
    ttransformer.build_transformer(m, 32, 256, 512, 8, 1)
    with pytest.warns(UserWarning, match="structural validation"):
        m.compile(tff.SGDOptimizer(lr=0.01), getattr(tff.LossType, MSE))
    assert max(v.num_parts() for v in m.searched_views.values()) > 1
    assert tanalysis.analyze_model(m).ok
    live = tanalysis.analyze_graph(m.graph, views=m.searched_views,
                                   num_devices=1)
    assert live.by_code("FFA205")
    assert m.lint_events["compile"]["perf_lint"]["errors"] == 0
    x = np.random.RandomState(0).randn(32, 256, 512).astype(np.float32)
    m.fit(x, x, verbose=False, lint="error")


def test_compile_lint_events_under_mixed_precision_match_jax(tmp_path):
    jm, tm = _searched_pair(tmp_path, workers=4, budget=2, mixed=True)
    assert _lint_events(tm.search_trajectory) == \
        _lint_events(jm.search_trajectory)


def test_compile_decode_lint_events_match_jax(tmp_path):
    """compile_decode lints its winner under objective="decode" and the
    precision pass, recording both events, as the JAX package does."""
    out = []
    for ns in (NS["jax"], NS["port"]):
        m = ns.ff.FFModel(_cfg(
            ns, batch_size=2, search_budget=2,
            machine_model_file=_machine_file(tmp_path, 4)))
        x = m.create_tensor((2, 8), ns.ff.DataType.DT_INT32)
        t = m.embedding(x, 64, 32, ns.ff.AggrMode.AGGR_MODE_NONE)
        t = m.multihead_attention(t, t, t, 32, 4, causal=True)
        t = m.dense(t, 64)
        m.softmax(t)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m.compile(ns.ff.SGDOptimizer(lr=0.01),
                      ns.ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
            m.compile_decode()
        out.append(m)
    jm, tm = out
    assert _lint_events(tm.decode_trajectory) == \
        _lint_events(jm.decode_trajectory)
    assert [k for k, *_ in _lint_events(tm.decode_trajectory)] == \
        ["perf_lint", "precision_lint"]


# ----------------------------------------------------------------------
# the JAX tests' planted faults, built in both packages
# ----------------------------------------------------------------------
def _pt(ns, sizes, degrees=None, replicas=None, dtype=None):
    return ns.pt.ParallelTensor(
        dims=ns.pt.make_dims(sizes, degrees, replicas),
        data_type=dtype or ns.ff.DataType.DT_FLOAT)


def _add(ns, g, op_type, params, inputs, out, view=None):
    op = ns.PCGOp(getattr(ns.ff.OperatorType, op_type), params, inputs)
    out.owner_op = op
    op.outputs.append(out)
    op.machine_view = view
    g.add_op(op)
    return op


def _view(ns, start, n):
    return ns.mv.MachineView(start_device_id=start, dim=(n,), stride=(1,))


def _relu(ns):
    return ns.ew.ElementUnaryParams(op_type=ns.ff.OperatorType.OP_RELU)


def _weight(ns, op, sizes, degrees=None):
    w = _pt(ns, sizes, degrees)
    w.owner_op = op
    op.weights.append(w)
    op.weight_names.append("kernel")
    return w


def fault_dangling(ns):
    g = ns.Graph()
    h = _pt(ns, [8, 16])
    prod = _add(ns, g, "OP_LINEAR", ns.lin.LinearParams(16), [_pt(ns, [8, 4])],
                h)
    _add(ns, g, "OP_RELU", _relu(ns), [h], _pt(ns, [8, 16]))
    g.ops = [op for op in g.ops if op is not prod]
    g._producer_cache = None
    return g, {"passes": ("structure",)}


def fault_bad_dims(ns):
    g = ns.Graph()
    _add(ns, g, "OP_RELU", _relu(ns), [_pt(ns, [8, 4])],
         _pt(ns, [8, 9], [1, 2]))
    return g, {"passes": ("structure",)}


def fault_cycle(ns):
    g = ns.Graph()
    a, b = _pt(ns, [8, 4]), _pt(ns, [8, 4])
    _add(ns, g, "OP_RELU", _relu(ns), [b], a)
    _add(ns, g, "OP_RELU", _relu(ns), [a], b)
    return g, {"passes": ("structure",)}


def fault_declared_shape(ns):
    g = ns.Graph()
    _add(ns, g, "OP_LINEAR", ns.lin.LinearParams(16), [_pt(ns, [8, 4])],
         _pt(ns, [8, 32]))
    return g, {"passes": ("structure", "sharding")}


def fault_degree_product(ns):
    g = ns.Graph()
    _add(ns, g, "OP_RELU", _relu(ns), [_pt(ns, [32, 16], [8, 2])],
         _pt(ns, [32, 16], [8, 2]))
    return g, {"num_devices": 8}


def fault_dropped_shard(ns):
    g = ns.Graph()
    _add(ns, g, "OP_RELU", _relu(ns), [_pt(ns, [32, 16], [4, 1])],
         _pt(ns, [32, 16]))
    return g, {"passes": ("structure", "sharding")}


def fault_combine_bookkeeping(ns):
    g = ns.Graph()
    _add(ns, g, "OP_COMBINE",
         ns.par.CombineParams(combine_dim=0, combine_degree=2),
         [_pt(ns, [32, 16])], _pt(ns, [32, 16], [2, 1]))
    return g, {"passes": ("structure", "sharding")}


def fault_reduction_axis(ns):
    g = ns.Graph()
    x = ns.pt.ParallelTensor(dims=[
        ns.pt.ParallelDim(size=2, degree=2, is_replica_dim=True),
        ns.pt.ParallelDim(size=32, degree=1),
        ns.pt.ParallelDim(size=16, degree=1)])
    _add(ns, g, "OP_REDUCTION",
         ns.par.ReductionParams(reduction_dim=1, reduction_degree=2), [x],
         _pt(ns, [32, 16]))
    return g, {"passes": ("structure", "collectives")}


def fault_softmax_axis(ns):
    g = ns.Graph()
    _add(ns, g, "OP_SOFTMAX", ns.soft.SoftmaxParams(dim=0),
         [_pt(ns, [32, 3], [4, 1])], _pt(ns, [32, 3], [4, 1]))
    return g, {"passes": ("structure", "collectives")}


def fault_collective_order(ns):
    g = ns.Graph()
    src = _pt(ns, [32, 16])
    _add(ns, g, "OP_RELU", _relu(ns), [_pt(ns, [32, 16])], src,
         view=_view(ns, 0, 1))
    _add(ns, g, "OP_REPARTITION",
         ns.par.RepartitionParams(repartition_dim=0, repartition_degree=4),
         [src], _pt(ns, [32, 16], [4, 1]), view=_view(ns, 0, 4))
    _add(ns, g, "OP_REPARTITION",
         ns.par.RepartitionParams(repartition_dim=1, repartition_degree=4),
         [src], _pt(ns, [32, 16], [1, 4]), view=_view(ns, 2, 4))
    return g, {"num_devices": 8, "passes": ("structure", "collectives")}


def fault_view_transition(ns):
    g = ns.Graph()
    h = _pt(ns, [32, 16], [2, 1])
    _add(ns, g, "OP_RELU", _relu(ns), [_pt(ns, [32, 16], [2, 1])], h,
         view=_view(ns, 0, 2))
    _add(ns, g, "OP_RELU", _relu(ns), [h], _pt(ns, [32, 16], [4, 1]),
         view=_view(ns, 0, 4))
    return g, {"passes": ("structure", "collectives")}


def fault_dead_devices(ns):
    g = ns.Graph()
    _add(ns, g, "OP_RELU", _relu(ns), [_pt(ns, [32, 16], [4, 1])],
         _pt(ns, [32, 16], [4, 1]), view=_view(ns, 6, 4))
    return g, {"num_devices": 8, "passes": ("structure", "collectives")}


def fault_bf16_accumulation(ns):
    g = ns.Graph()
    h = _pt(ns, [8, 32])
    _add(ns, g, "OP_LINEAR", ns.lin.LinearParams(32), [_pt(ns, [8, 256])], h)
    h.compute_dtype = ns.ff.DataType.DT_BF16
    h.accum_dtype = None
    return g, {"passes": ("structure", "precision"), "drift_budget": 1e9}


def fault_memory_budget(ns):
    g = ns.Graph()
    op = _add(ns, g, "OP_LINEAR", ns.lin.LinearParams(4096),
              [_pt(ns, [64, 1024])], _pt(ns, [64, 4096]),
              view=_view(ns, 0, 1))
    _weight(ns, op, [1024, 4096])
    return g, {"num_devices": 8, "hbm_bytes": 32 << 20,
               "optimizer": ns.ff.AdamOptimizer(), "passes": ("memory",)}


def fault_padded_shard(ns):
    g = ns.Graph()
    op = _add(ns, g, "OP_LINEAR", ns.lin.LinearParams(256),
              [_pt(ns, [32, 512])], _pt(ns, [32, 256], [1, 4]))
    _weight(ns, op, [512, 256], [1, 4])
    return g, {"passes": ("perf",), "cost_model": _cost_model(ns)}


FAULTS = {f.__name__[6:]: f for f in (
    fault_dangling, fault_bad_dims, fault_cycle, fault_declared_shape,
    fault_degree_product, fault_dropped_shard, fault_combine_bookkeeping,
    fault_reduction_axis, fault_softmax_axis, fault_collective_order,
    fault_view_transition, fault_dead_devices, fault_bf16_accumulation,
    fault_memory_budget, fault_padded_shard)}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_planted_faults_give_jax_codes(name):
    def run(ns):
        g, kw = FAULTS[name](ns)
        return ns.an.analyze_graph(g, **kw)

    jrep, trep = _both(run)
    assert not jrep.ok or jrep.by_code("FFA503")
    assert _diag_set(trep, names=False) == _diag_set(jrep, names=False)
    assert [bool(d.fix_hint) for d in trep] == [bool(d.fix_hint)
                                                for d in jrep]


def _row_padded_shard(ns):
    """A Linear whose 12 rows are split 4 ways: 3-row shards, which JAX's
    sublane quantum (8) pads and the H100's (1) does not."""
    g = ns.Graph()
    op = _add(ns, g, "OP_LINEAR", ns.lin.LinearParams(256),
              [_pt(ns, [12, 512], [4, 1])], _pt(ns, [12, 256], [4, 1]))
    _weight(ns, op, [512, 256])
    return g


def test_padding_lint_reads_the_cost_models_quanta():
    """The port's FFA503 reads the audited chip's tile quanta: JAX's fire
    on a column-split shard (above) and on a row-split one; the H100
    spec's (128 lanes, 1 sublane, from the tile sweep on the card) fire
    on the column split only, and a lint without a machine takes the
    H100's."""
    ns = NS["port"]
    g, _ = fault_padded_shard(ns)
    rows = _row_padded_shard(ns)
    h100 = tsearch.CostModel(tsearch.h100_machine(1, 1))
    assert tanalysis.perf_diagnostics(g, cost_model=h100).by_code("FFA503")
    assert tanalysis.perf_diagnostics(g).by_code("FFA503")
    assert tanalysis.perf_diagnostics(
        g, cost_model=_cost_model(ns)).by_code("FFA503")
    assert not tanalysis.perf_diagnostics(
        rows, cost_model=h100).by_code("FFA503")
    assert not tanalysis.perf_diagnostics(rows).by_code("FFA503")
    assert tanalysis.perf_diagnostics(
        rows, cost_model=_cost_model(ns)).by_code("FFA503")


# ----------------------------------------------------------------------
# the overlap schedule's pure functions (FFA502)
# ----------------------------------------------------------------------
def _schedule(ns, tied=False):
    g = ns.Graph()
    h = _pt(ns, [32, 64], [4, 1])
    op1 = _add(ns, g, "OP_LINEAR", ns.lin.LinearParams(64),
               [_pt(ns, [32, 64], [4, 1])], h, view=_view(ns, 0, 4))
    w = _weight(ns, op1, [64, 64])
    op2 = _add(ns, g, "OP_LINEAR", ns.lin.LinearParams(64), [h],
               _pt(ns, [32, 64], [4, 1]), view=_view(ns, 0, 4))
    if tied:
        op2.weights.append(w)
        op2.weight_names.append("kernel")
    else:
        _weight(ns, op2, [64, 64])
    return op1, op2, ns.sched.build_overlap_schedule(
        g, {(op1.name, "kernel"), (op2.name, "kernel")} if not tied
        else {(op2.name, "kernel")})


@pytest.mark.parametrize("defect", ["clean", "update_early", "unfenced",
                                    "tied", "dangling"])
def test_overlap_schedule_races_match_jax(defect):
    def run(ns):
        op1, op2, sched = _schedule(ns, tied=defect == "tied")
        if defect == "update_early":
            sched = sched.replace(f"update:{op1.name}.kernel", after=())
        elif defect == "unfenced":
            sched = sched.replace("step_end", after=())
        elif defect == "dangling":
            sched = ns.sched.OverlapSchedule([
                ns.sched.ScheduleTask(name="a", kind="backward",
                                      writes=("g",)),
                ns.sched.ScheduleTask(name="b", kind="update", reads=("g",),
                                      after=("ghost",))])
        kinds = sorted(t.kind for t in sched)
        return kinds, ns.an.schedule_race_diagnostics(sched)

    (jk, jrep), (tk, trep) = _both(run)
    assert tk == jk
    assert _diag_set(trep, names=False) == _diag_set(jrep, names=False)
    assert (defect == "clean") == trep.ok


def test_the_executor_has_no_overlap_schedule():
    m = tff.FFModel(tff.FFConfig(batch_size=4, device="cpu"))
    ttransformer.build_transformer(m, 4, 8, 32, 4, 1)
    m.compile(tff.SGDOptimizer(lr=0.01), getattr(tff.LossType, MSE))
    assert m.executor.overlap_schedule() is None
    rep = tanalysis.analyze_model(m)
    assert rep.ok and rep.codes() == ["FFA302"]
    assert "76293.9 MiB" in rep.by_code("FFA302")[0].message  # 80e9 bytes
    m.config.device_mem = 1 << 10
    assert tanalysis.analyze_model(m).by_code("FFA301")


# ----------------------------------------------------------------------
# fit(lint=...)
# ----------------------------------------------------------------------
def _lint_pair():
    out = []
    for ns in (NS["jax"], NS["port"]):
        m = ns.ff.FFModel(_cfg(ns, batch_size=8, allow_mixed_precision=True))
        x = m.create_tensor((8, 4), ns.ff.DataType.DT_FLOAT)
        t = m.dense(x, 16, ns.ff.ActiMode.AC_MODE_RELU)
        t = m.dense(t, 3)
        m.softmax(t)
        m.compile(ns.ff.SGDOptimizer(lr=0.1),
                  ns.ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [])
        out.append(m)
    return out


def _seed_accum_defect(m):
    """A bf16 matmul output with no fp32 accumulator (FFA702): visible to
    the analyzer on one device, harmless to the step."""
    lin = next(op for op in m.graph.ops
               if op.op_type.name == "OP_LINEAR")
    lin.outputs[0].accum_dtype = None


def _lint_data():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 4).astype(np.float32),
            rng.randint(0, 3, (16, 1)).astype(np.int32))


def test_fit_lint_error_raises_like_jax():
    x, y = _lint_data()
    for m in _lint_pair():
        _seed_accum_defect(m)
        an = janalysis if isinstance(m, jff.FFModel) else tanalysis
        with pytest.raises(an.StaticAnalysisError) as ei:
            m.fit(x, y, epochs=1, verbose=False, lint="error")
        assert [d.code for d in ei.value.report.errors] == ["FFA702"]
        step = m.state.step
        assert int(step) == 0


def test_fit_lint_warn_clean_and_bad_value_like_jax():
    x, y = _lint_data()
    for m in _lint_pair():
        m.fit(x, y, epochs=1, verbose=False, lint="error")  # clean
        _seed_accum_defect(m)
        with pytest.warns(UserWarning, match="FFA702"):
            m.fit(x, y, epochs=1, verbose=False, lint="warn")
        with pytest.raises(ValueError, match="lint"):
            m.fit(x, y, epochs=1, verbose=False, lint="loud")


def test_validator_hook_is_registered():
    names = [f.__name__ for f in tsearch._STRATEGY_VALIDATORS]
    assert names == ["_default_structural_validator",
                     "_static_analysis_validator"]


# ----------------------------------------------------------------------
# the CLI and the utilities
# ----------------------------------------------------------------------
@pytest.mark.parametrize("argv", [[], ["model", "--device", "cpu", "--json"]])
def test_analysis_cli(argv):
    r = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.analysis"] + argv,
        capture_output=True, text=True, cwd=PORT_DIR.parent, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stdout + r.stderr
    if "--json" in argv:
        doc = json.loads(r.stdout)
        assert doc["errors"] == 0 and doc["num_devices"] == 1
        assert {d["code"] for d in doc["diagnostics"]} == {"FFA302"}
    else:
        assert "0 error(s)" in r.stdout


def test_graph_utils_match_jax():
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (0, 4)]
    nodes = list(range(5))
    succ = {n: [b for a, b in edges if a == n] for n in nodes}
    topo = {n: n for n in nodes}
    jdom, tdom = jgu.dominators(nodes, succ, 0), tgu.dominators(nodes, succ, 0)
    assert tdom == jdom
    assert tgu.post_dominators(nodes, succ, 4) == \
        jgu.post_dominators(nodes, succ, 4)
    assert [tgu.imm_dominator(tdom, n, topo) for n in nodes] == \
        [jgu.imm_dominator(jdom, n, topo) for n in nodes]
    assert tgu.transitive_reduction(nodes, set(edges)) == \
        jgu.transitive_reduction(nodes, set(edges)) == \
        set(edges) - {(0, 4)}
    dj, dt = jgu.DisjointSet(), tgu.DisjointSet()
    for a, b in [(1, 2), (3, 4), (2, 4)]:
        dj.union(a, b)
        dt.union(a, b)
    assert [dt.find(i) == dt.find(1) for i in range(6)] == \
        [dj.find(i) == dj.find(1) for i in range(6)]


def test_debug_printers_match_jax():
    import torch

    jg, tg = _lowered(NS["jax"], "transformer"), _lowered(NS["port"],
                                                           "transformer")
    strip = (lambda s: "".join(c for c in s if not c.isdigit()))
    assert strip(tdebug.format_graph(tg)) == strip(jdebug.format_graph(jg))
    v = tmv.MachineView(start_device_id=0, dim=(4,), stride=(1,))
    # the same view, the port's device type named for its card
    assert tdebug.format_machine_view(v) == jdebug.format_machine_view(
        jmv.MachineView(start_device_id=0, dim=(4,), stride=(1,))
    ).replace("TPU", "GPU")
    a = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    assert tdebug.summarize_array(torch.from_numpy(a), "a") == \
        jdebug.summarize_array(a, "a")
    assert "dtype=float32" in tdebug.summarize_array(
        torch.from_numpy(a).bfloat16(), "b")


def test_new_modules_and_chip_smoke_import_no_jax():
    """The slice's modules import neither jax nor the JAX package, and
    chip_smoke.py has no import of either."""
    code = ("import sys, flexflow_tpu_torch.analysis,"
            " flexflow_tpu_torch.analysis.__main__,"
            " flexflow_tpu_torch.obs.explain,"
            " flexflow_tpu_torch.obs.calibration,"
            " flexflow_tpu_torch.obs.step_profile,"
            " flexflow_tpu_torch.runtime.profiler,"
            " flexflow_tpu_torch.utils.debug,"
            " flexflow_tpu_torch.utils.graph_utils;"
            " bad = sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'flexflow_tpu.')) or m == 'flexflow_tpu');"
            " print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=PORT_DIR.parent, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stdout + r.stderr
    src = (PORT_DIR.parent / "chip_smoke.py").read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(?:jax|flexflow_tpu)\b(?!_torch)"
                     r".*$", src, re.M)
    assert not bad, bad
