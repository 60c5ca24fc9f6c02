"""The strategy search of flexflow_tpu_torch against the JAX package's.

The same graphs are built in both packages (the flagship Transformer at
batch 8, seq 64, hidden 128, 8 heads, 2 blocks; test_search.py's MLP,
attention block, diamond and DLRM) and go through both packages' machine
views, cost model, substitutions, DP and best-first search, compile with
a search, strategy files and training of the winner.

Tolerances: costs are the same float arithmetic in the same order in
both packages (host Python on the same values), so they agree to
rel 1e-12 (a few ulps, for a sum reassociated nowhere); views and op
sequences must be equal. Trained weights: rtol 1e-5, atol 1e-6, the
limit of test_torch_port_train.py (XLA and torch sum the products in
other orders). The JAX side's shipped calibration (a fit of its own
chip) is switched off, as the port applies none.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import flexflow_tpu as jff
import flexflow_tpu.search as jsearch
import flexflow_tpu_torch as tff
import flexflow_tpu_torch.search as tsearch
from flexflow_tpu.models.dlrm import build_dlrm as jdlrm
from flexflow_tpu.models.transformer import build_transformer as jtransformer
from flexflow_tpu.pcg import lowering as jlowering
from flexflow_tpu.pcg import machine_view as jmv
from flexflow_tpu.runtime import strategy_io as jsio
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.search import substitution as jsub
from flexflow_tpu.search import substitution_loader as jloader
from flexflow_tpu_torch.models import build_dlrm as tdlrm
from flexflow_tpu_torch.models import build_transformer as ttransformer
from flexflow_tpu_torch.pcg import lowering as tlowering
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.runtime import strategy_io as tsio
from flexflow_tpu_torch.runtime.weights import params_from_numpy
from flexflow_tpu_torch.search import substitution as tsub
from flexflow_tpu_torch.search import substitution_loader as tloader
from flexflow_tpu_torch.search.measure import OperatorMeasurer

COST_RTOL = 1e-12
RTOL, ATOL = 1e-5, 1e-6
BATCH, SEQ, HIDDEN, HEADS, LAYERS = 8, 64, 128, 8, 2
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"
PORT_DIR = pathlib.Path(__file__).resolve().parent.parent / "flexflow_tpu_torch"


@pytest.fixture(autouse=True)
def _no_jax_calibration(monkeypatch):
    """The JAX side prices with the analytic roofline alone, as the port
    does (the shipped fit is a measurement of the JAX package's chip)."""
    monkeypatch.setattr(jcm, "load_default_calibration", lambda: None)


def _cfg(pkg, **kw):
    if pkg is tff:
        return tff.FFConfig(device="cpu", **kw)
    cfg = jff.FFConfig()
    cfg.workersPerNode = 1   # one device: the winner is demoted, as in the port
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _lower(pkg, m):
    low = jlowering if pkg is jff else tlowering
    return low.layers_to_pcg(m.layers)[0]


def transformer_model(pkg, **cfg):
    m = pkg.FFModel(_cfg(pkg, batch_size=BATCH, **cfg))
    (jtransformer if pkg is jff else ttransformer)(
        m, BATCH, SEQ, HIDDEN, HEADS, LAYERS)
    return m


def dlrm_model(pkg, **cfg):
    m = pkg.FFModel(_cfg(pkg, batch_size=64, **cfg))
    (jdlrm if pkg is jff else tdlrm)(
        m, 64, embedding_sizes=(1000,) * 2, mlp_bot=(16, 32),
        mlp_top=(32, 2))
    return m


def mlp_model(pkg):
    m = pkg.FFModel(_cfg(pkg))
    x = m.create_tensor((64, 512), pkg.DataType.DT_FLOAT)
    t = m.dense(x, 1024, pkg.ActiMode.AC_MODE_RELU)
    m.dense(t, 256)
    return m


def attention_block_model(pkg):
    m = pkg.FFModel(_cfg(pkg))
    x = m.create_tensor((8, 64, 128), pkg.DataType.DT_FLOAT)
    t = m.multihead_attention(x, x, x, 128, 8)
    t = m.dense(t, 128, pkg.ActiMode.AC_MODE_RELU)
    m.dense(t, 128)
    return m


def diamond_model(pkg):
    """test_search.py's inception block: a connected diamond with no
    bottleneck (the DP's fallback path)."""
    m = pkg.FFModel(_cfg(pkg))
    x = m.create_tensor((32, 64), pkg.DataType.DT_FLOAT)
    d1, d2, d3 = (m.dense(x, 48) for _ in range(3))
    m.add(m.add(d1, d2), d3)
    return m


GRAPHS = {"transformer": transformer_model, "dlrm": dlrm_model,
          "mlp": mlp_model, "attention_block": attention_block_model,
          "diamond": diamond_model}


def _graphs(name, partition=None):
    """The named graph lowered in both packages, optionally after the
    first partition_batch(degree) rewrite."""
    out = []
    for pkg, sub in ((jff, jsub), (tff, tsub)):
        g = _lower(pkg, GRAPHS[name](pkg))
        if partition:
            g = next(iter(sub.partition_batch(partition).apply(g)))
        out.append(g)
    return out


def _view_key(v):
    return (v.start_device_id, tuple(v.dim), tuple(v.stride))


def _machines(workers=4):
    return (jsearch.MachineModel(num_nodes=1, workers_per_node=workers),
            tsearch.MachineModel(num_nodes=1, workers_per_node=workers))


def _resources(workers=4, nodes=1):
    return (jmv.MachineResource(nodes, workers, workers),
            tmv.MachineResource(nodes, workers, workers))


def _views_by_position(graph, views):
    """The views by their op's topo position; ops the lowering to one
    device took out of the graph (weight-shard nodes) by None."""
    pos = {op.guid: i for i, op in enumerate(graph.topo_order())}
    return sorted(((pos.get(g, -1), _view_key(v)) for g, v in views.items()))


def _op_types(graph):
    return [op.op_type.name for op in graph.topo_order()]


# -- machine views -------------------------------------------------------------

@pytest.mark.parametrize("nodes,procs", [(1, 1), (1, 4), (1, 8), (2, 4),
                                         (4, 2), (3, 3)])
def test_enumerate_machine_views_match_jax(nodes, procs):
    jv = jmv.enumerate_machine_views(nodes, procs)
    tv = tmv.enumerate_machine_views(nodes, procs)
    assert [_view_key(v) for v in tv] == [_view_key(v) for v in jv]
    assert [v.device_ids() for v in tv] == [v.device_ids() for v in jv]
    assert [v.num_parts() for v in tv] == [v.num_parts() for v in jv]
    for half in range(1, procs + 1):
        jr = jmv.MachineResource(nodes, procs, half, start_gpu_id=procs - half)
        tr = tmv.MachineResource(nodes, procs, half, start_gpu_id=procs - half)
        assert ([tr.is_valid_machine_view(v) for v in tv]
                == [jr.is_valid_machine_view(v) for v in jv])
        assert tr.num_procs() == jr.num_procs()


def test_machine_model_defaults_and_file_match_jax(tmp_path):
    """MachineModel() and parse_machine_config read the same in both
    packages; the port's H100 machine has the card's published numbers."""
    assert (dataclasses.asdict(tsearch.MachineModel())
            == {**dataclasses.asdict(jsearch.MachineModel()),
                "chip": {**dataclasses.asdict(jsearch.MachineModel().chip),
                         "mxu_lanes": 128, "mxu_sublanes": 8}})
    p = tmp_path / "m.cfg"
    p.write_text("num_nodes = 2\nnum_gpus_per_node = 4\n"
                 "intra_node_bandwidth = 3e11\ninter_node_bandwidth = 2e10\n"
                 "peak_flops_bf16 = 5e14\nhbm_bandwidth = 2e12\n"
                 "device_mem = 40000000000\n")
    jm, tm = jsearch.parse_machine_config(str(p)), \
        tsearch.parse_machine_config(str(p))
    for f in ("num_nodes", "workers_per_node", "ici_bandwidth",
              "dcn_bandwidth", "ici_latency", "dcn_latency"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert dataclasses.asdict(tm.chip) == {**dataclasses.asdict(jm.chip),
                                           "mxu_lanes": 128,
                                           "mxu_sublanes": 8}
    h = tsearch.h100_machine(1, 8)
    assert (h.chip.peak_flops_bf16, h.chip.hbm_bandwidth,
            h.chip.hbm_capacity, h.ici_bandwidth, h.dcn_bandwidth) == \
        (989e12, 3.35e12, 80 * 10 ** 9, 450e9, 50e9)
    assert (h.chip.mxu_lanes, h.chip.mxu_sublanes) == (1, 1)
    assert h.num_workers == 8


def test_graph_structure_matches_jax():
    """Edges, the correctness gate, the dot export and the hash's
    dedup behave as JAX's on the same graphs."""
    for name in ("transformer", "diamond", "dlrm"):
        jg, tg = _graphs(name, 2)
        for jo, to in zip(jg.topo_order(), tg.topo_order()):
            assert [(e.src_idx, e.dst_idx) for e in tg.in_edges(to)] == \
                [(e.src_idx, e.dst_idx) for e in jg.in_edges(jo)]
            assert len(tg.out_edges(to)) == len(jg.out_edges(jo))
            assert to.is_parallel_op == jo.is_parallel_op
        assert tg.check_correctness() and jg.check_correctness()
        assert len(tg.export_dot().splitlines()) == \
            len(jg.export_dot().splitlines())
        again = _graphs(name, 2)[1]
        assert again.hash() == tg.hash() != _graphs(name)[1].hash()
    # a dangling input fails the gate in both
    for g in _graphs("mlp"):
        g.ops = g.ops[1:]
        g._producer_cache = None
        assert not g.check_correctness()


@pytest.mark.parametrize("pass_,degree", [
    ("apply_data_parallel", 1), ("apply_data_parallel", 2),
    ("apply_tensor_parallel", 1), ("apply_tensor_parallel", 4),
    ("apply_sequence_parallel", 2), ("apply_expert_parallel", 2),
    ("apply_weight_sharding", 2)])
def test_manual_strategies_and_the_lowering_match_jax(pass_, degree):
    """The manual passes set the degrees JAX's set, and assign_mesh_axes
    demotes them to the same axes on 1 and on 4 devices."""
    from flexflow_tpu.parallel import strategies as jst
    from flexflow_tpu_torch.parallel import strategies as tst

    for ndev in (1, 4):
        degs = []
        for mod, g in zip((jst, tst), _graphs("transformer")):
            getattr(mod, pass_)(g, degree, axis_idx=1)
            before = [[d.degree for d in t.dims] for op in g.topo_order()
                      for t in op.outputs + op.weights]
            axes = mod.assign_mesh_axes(g, ndev)
            degs.append((before, axes, _op_types(g),
                         [[d.degree for d in t.dims]
                          for op in g.topo_order()
                          for t in op.outputs + op.weights]))
        assert degs[1] == degs[0]
        if ndev == 1:
            assert all(d == 1 for t in degs[1][3] for d in t)


# -- the cost model --------------------------------------------------------------

def _metrics(cm):
    return (cm.forward_time, cm.backward_time, cm.sync_time,
            cm.hidden_sync_time, cm.inputs_memory, cm.outputs_memory,
            cm.weights_memory)


@pytest.mark.parametrize("name,partition", [
    ("transformer", None), ("transformer", 2), ("transformer", 4),
    ("dlrm", None), ("dlrm", 4), ("mlp", 2), ("diamond", 2)])
@pytest.mark.parametrize("bf16", [True, False])
def test_measure_operator_cost_matches_jax(name, partition, bf16):
    jg, tg = _graphs(name, partition)
    jmach, tmach = _machines(4)
    jc = jsearch.CostModel(jmach, bf16=bf16, calibration=False)
    tc = tsearch.CostModel(tmach, bf16=bf16, calibration=False)
    jops, tops = jg.topo_order(), tg.topo_order()
    assert _op_types(jg) == _op_types(tg)
    checked = 0
    for jo, to in zip(jops, tops):
        for deg in (1, 2, 4):
            for start in range(0, 4, deg):
                jv = jmv.MachineView(start_device_id=start, dim=(deg,))
                tv = tmv.MachineView(start_device_id=start, dim=(deg,))
                jm, tm = jc.measure_operator_cost(jo, jv), \
                    tc.measure_operator_cost(to, tv)
                np.testing.assert_allclose(_metrics(tm), _metrics(jm),
                                           rtol=COST_RTOL, err_msg=to.name)
                np.testing.assert_allclose(tc.parallel_op_cost(to, tv),
                                           jc.parallel_op_cost(jo, jv),
                                           rtol=COST_RTOL)
                for jt, tt in zip(jo.outputs, to.outputs):
                    for src in (0, 1):
                        jsrc = jmv.MachineView(start_device_id=src)
                        tsrc = tmv.MachineView(start_device_id=src)
                        np.testing.assert_allclose(
                            tc.estimate_xfer_cost(tt, tsrc, tv),
                            jc.estimate_xfer_cost(jt, jsrc, jv),
                            rtol=COST_RTOL)
                checked += 1
    assert checked >= len(tops) * 7


def test_calibration_dict_applies_like_jax():
    """No calibration by default in the port; a dict applies through the
    JAX package's validator and changes the cost as JAX's does."""
    cal = {"mxu_efficiency": 0.4, "hbm_efficiency": 0.7,
           "op_class": {"OP_LINEAR": {"mxu_efficiency": 0.3,
                                      "bwd_over_fwd": 2.5}}}
    jg, tg = _graphs("mlp")
    jmach, tmach = _machines(4)
    assert tsearch.CostModel(tmach).calibration is None
    jc = jsearch.CostModel(jmach, calibration=cal)
    tc = tsearch.CostModel(tmach, calibration=cal)
    v = (jmv.MachineView(), tmv.MachineView())
    for jo, to in zip(jg.topo_order(), tg.topo_order()):
        np.testing.assert_allclose(
            _metrics(tc.measure_operator_cost(to, v[1])),
            _metrics(jc.measure_operator_cost(jo, v[0])), rtol=COST_RTOL)
    with pytest.raises(ValueError, match="outside"):
        tsearch.CostModel(tmach, calibration={"mxu_efficiency": 0.0})


# -- substitutions -----------------------------------------------------------------

@pytest.mark.parametrize("degrees", [[1], [2], [2, 4], [2, 4, 8]])
def test_generate_all_pcg_xfers_match_jax(degrees):
    for jcfg, tcfg in ((None, None), (jff.FFConfig(),
                                      tff.FFConfig(device="cpu"))):
        assert ([x.name for x in tsub.generate_all_pcg_xfers(degrees, tcfg)]
                == [x.name for x in jsub.generate_all_pcg_xfers(degrees,
                                                                jcfg)])


@pytest.mark.parametrize("fname", ["graph_subst_tpu_v1.json",
                                   "graph_subst_zoo_v1.json",
                                   "moe_capacity_v1.json"])
def test_rule_collections_match_jax(fname):
    jp = pathlib.Path(jloader.default_rules_path()).parent / fname
    tp = pathlib.Path(tloader.default_rules_path()).parent / fname
    assert tp.read_bytes() == jp.read_bytes()
    jr = jloader.load_rule_collection_from_path(str(jp))
    tr = tloader.load_rule_collection_from_path(str(tp))
    assert [r.name for r in tr] == [r.name for r in jr]
    assert [r.supported for r in tr] == [r.supported for r in jr]
    assert ([s.name for s in tloader.rules_to_substitutions(tr)]
            == [s.name for s in jloader.rules_to_substitutions(jr)])
    assert tloader.zoo_rules_path().endswith("graph_subst_zoo_v1.json")


def test_rule_lint_rejects_an_unsound_rule_like_jax():
    """The loader lints every rule (analysis/substitution_lint.py): a
    partition by 2 answered by a combine by 4 is unsound in both."""
    rule = {"name": "bad", "srcOp": [
        {"type": "OP_LINEAR", "input": [{"opId": -1, "tsId": 0}],
         "para": []}],
        "dstOp": [
            {"type": "OP_PARTITION", "input": [{"opId": -1, "tsId": 0}],
             "para": [{"key": "PM_PARALLEL_DIM", "value": 0},
                      {"key": "PM_PARALLEL_DEGREE", "value": 2}]},
            {"type": "OP_LINEAR", "input": [{"opId": 0, "tsId": 0}],
             "para": []},
            {"type": "OP_COMBINE", "input": [{"opId": 1, "tsId": 0}],
             "para": [{"key": "PM_PARALLEL_DIM", "value": 0},
                      {"key": "PM_PARALLEL_DEGREE", "value": 4}]}],
        "mappedOutput": [{"srcOpId": 0, "srcTsId": 0, "dstOpId": 2,
                          "dstTsId": 0}]}
    errs = []
    for loader in (jloader, tloader):
        with pytest.raises(loader.SubstitutionRuleError) as e:
            loader.load_rule_collection({"rule": [rule]})
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -- the DP and the best-first search ----------------------------------------------------

def _shipped_xfers(sub, loader, degrees):
    xs = sub.generate_all_pcg_xfers(degrees)
    for p in (loader.default_rules_path(), loader.zoo_rules_path()):
        xs = xs + loader.rules_to_substitutions(
            loader.load_rule_collection_from_path(p))
    return xs


@pytest.mark.parametrize("name,nodes", [
    ("transformer", 1), ("dlrm", 1), ("mlp", 1), ("attention_block", 1),
    ("diamond", 1), ("transformer", 2), ("dlrm", 2)])
def test_dp_and_graph_optimize_match_jax(name, nodes):
    """On 1 node of 4 workers, and on 2 nodes of 2 with the
    survivability penalty compile() sets on a multi-node machine."""
    jg, tg = _graphs(name)
    workers = 4 // nodes
    jmach = jsearch.MachineModel(num_nodes=nodes, workers_per_node=workers)
    tmach = tsearch.MachineModel(num_nodes=nodes, workers_per_node=workers)
    jres, tres = _resources(workers, nodes)
    pen = 0.25 if nodes > 1 else 0.0
    jc = jsearch.CostModel(jmach, calibration=False,
                           survivability_penalty=pen)
    tc = tsearch.CostModel(tmach, calibration=False,
                           survivability_penalty=pen)
    # the DP alone, on the lowering and on a batch-partitioned graph
    for jgr, tgr in ((jg, tg), _graphs(name, 2)):
        jr = jsearch.SearchHelper(jc).graph_cost(jgr, jres)
        tr = tsearch.SearchHelper(tc).graph_cost(tgr, tres)
        np.testing.assert_allclose(tr.cost, jr.cost, rtol=COST_RTOL)
        assert _views_by_position(tgr, tr.views) == \
            _views_by_position(jgr, jr.views)
    # the best-first search over every xfer and the shipped rules
    jbest, jr = jsearch.GraphSearchHelper(
        jsearch.SearchHelper(jc), _shipped_xfers(jsub, jloader, [2, 4]),
        budget=3).graph_optimize(jg, jres)
    tbest, tr = tsearch.GraphSearchHelper(
        tsearch.SearchHelper(tc), _shipped_xfers(tsub, tloader, [2, 4]),
        budget=3).graph_optimize(tg, tres)
    np.testing.assert_allclose(tr.cost, jr.cost, rtol=COST_RTOL)
    assert _op_types(tbest) == _op_types(jbest)
    assert _views_by_position(tbest, tr.views) == \
        _views_by_position(jbest, jr.views)
    assert [[d.degree for d in t.dims] for op in tbest.topo_order()
            for t in op.outputs + op.weights] == \
        [[d.degree for d in t.dims] for op in jbest.topo_order()
         for t in op.outputs + op.weights]


def _fake_measure(op, view):
    """A fixed stand-in for the device: a time from the op's type, its
    shard volume and its view's parts alone."""
    vol = sum(int(np.prod([d.size // d.degree for d in t.dims
                           if not d.is_replica_dim])) for t in op.inputs)
    base = (1 + op.op_type.value % 7) * 1e-9 * vol
    return base / (1 + 0.5 * view.num_parts()), 2.5 * base


def test_fake_measure_fn_gives_the_same_winner():
    jg, tg = _graphs("transformer")
    jmach, tmach = _machines(4)
    jres, tres = _resources(4)
    jc = jsearch.CostModel(jmach, calibration=False)
    tc = tsearch.CostModel(tmach, calibration=False)
    jc.measure_fn = tc.measure_fn = _fake_measure
    jbest, jr = jsearch.GraphSearchHelper(
        jsearch.SearchHelper(jc), jsub.generate_all_pcg_xfers([2, 4]),
        budget=4).graph_optimize(jg, jres)
    tbest, tr = tsearch.GraphSearchHelper(
        tsearch.SearchHelper(tc), tsub.generate_all_pcg_xfers([2, 4]),
        budget=4).graph_optimize(tg, tres)
    np.testing.assert_allclose(tr.cost, jr.cost, rtol=COST_RTOL)
    assert _op_types(tbest) == _op_types(jbest)
    assert _views_by_position(tbest, tr.views) == \
        _views_by_position(jbest, jr.views)
    assert tc.measured_hits > 0 and len(tc.measured) == len(jc.measured)


# -- compile with a search ---------------------------------------------------------

def _machine_file(tmp_path, workers):
    """1 node of `workers` devices, in the GPU-era spellings both parsers
    read."""
    p = tmp_path / f"machine_{workers}.cfg"
    p.write_text(f"num_nodes = 1\nnum_gpus_per_node = {workers}\n"
                 "intra_node_bandwidth = 90e9\ninter_node_bandwidth = 25e9\n")
    return str(p)


def _one_rule_file(tmp_path):
    """A collection of one shipped rule: the first that partitions a
    Linear's batch."""
    src = json.loads(pathlib.Path(tloader.default_rules_path()).read_text())
    rule = next(r for r in src["rule"]
                if any(o["type"] == "OP_LINEAR" for o in r["srcOp"]))
    p = tmp_path / "one_rule.json"
    p.write_text(json.dumps({"rule": [rule]}))
    return str(p)


def _compiled_pair(builder, **cfg):
    out = []
    for pkg in (jff, tff):
        m = builder(pkg, **cfg)
        loss = (getattr(pkg.LossType, MSE) if builder is transformer_model
                else pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        m.compile(pkg.SGDOptimizer(lr=0.01), loss)
        out.append(m)
    return out


@pytest.mark.parametrize("model", ["transformer", "dlrm"])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("rules", ["shipped", "one_rule"])
def test_compile_search_matches_jax(tmp_path, model, workers, rules):
    builder = {"transformer": transformer_model, "dlrm": dlrm_model}[model]
    cfg = {"search_budget": 4,
           "machine_model_file": _machine_file(tmp_path, workers)}
    if rules == "one_rule":
        cfg["substitution_json_path"] = _one_rule_file(tmp_path)
    jm, tm = _compiled_pair(builder, **cfg)
    np.testing.assert_allclose(tm.searched_cost, jm.searched_cost,
                               rtol=COST_RTOL)
    assert _op_types(tm.graph) == _op_types(jm.graph)
    assert _views_by_position(tm.graph, tm.searched_views) == \
        _views_by_position(jm.graph, jm.searched_views)
    # demoted to the one device both run on
    assert all(d.degree == 1 or d.is_replica_dim for op in tm.graph.ops
               for t in op.outputs + op.weights for d in t.dims)
    phases = [e["name"] for e in tm.search_trajectory.of_kind("phase")]
    assert phases[:3] == ["lowering", "strategy_search", "executor_build"]
    assert tm.search_trajectory.of_kind("search_end")


def test_search_num_workers_searches_a_bigger_machine():
    """search_num_workers: the H100 machine of that many workers (at a
    width where splitting pays on H100s: batch 32, seq 256, hidden 512);
    the winner's views address devices the one device lacks, the
    validator says so, and the winner is demoted and trains."""
    m = tff.FFModel(_cfg(tff, batch_size=32, search_budget=2,
                         search_num_workers=8))
    ttransformer(m, 32, 256, 512, 8, 1)
    with pytest.warns(UserWarning, match="structural validation"):
        m.compile(tff.SGDOptimizer(lr=0.01), getattr(tff.LossType, MSE))
    assert m.search_cost_model.machine.num_workers == 8
    assert m.search_cost_model.machine.chip.peak_flops_bf16 == 989e12
    assert max(v.num_parts() for v in m.searched_views.values()) > 1
    assert m.searched_axes == {"data": 1, "model": 1}
    assert all(d.degree == 1 for op in m.graph.ops
               for t in op.outputs + op.weights for d in t.dims)
    x = np.random.RandomState(0).randn(32, 256, 512).astype(np.float32)
    m.fit(x, x, epochs=1, verbose=False)


@pytest.mark.parametrize("model", ["transformer", "dlrm"])
def test_searched_model_trains_like_jax(tmp_path, model):
    builder = {"transformer": transformer_model, "dlrm": dlrm_model}[model]
    jm, tm = _compiled_pair(builder, search_budget=4,
                            machine_model_file=_machine_file(tmp_path, 4))
    assert _op_types(tm.graph) == _op_types(jm.graph)
    params_from_numpy(tm, {op: {n: np.asarray(a, np.float32)
                                for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    rng = np.random.RandomState(3)
    if model == "transformer":
        xs = [rng.randn(2 * BATCH, SEQ, HIDDEN).astype(np.float32)]
        y = rng.randn(2 * BATCH, SEQ, HIDDEN).astype(np.float32)
        bs = BATCH
    else:
        xs = [rng.randint(0, 1000, (128, 1)).astype(np.int32)
              for _ in range(2)] + [rng.rand(128, 16).astype(np.float32)]
        y = rng.randint(0, 2, (128, 1)).astype(np.int32)
        bs = 64
    jm.fit(xs, y, batch_size=bs, epochs=1, verbose=False)
    tm.fit(xs, y, batch_size=bs, epochs=1, verbose=False)
    j = {op: {n: np.asarray(a, np.float32) for n, a in ws.items()}
         for op, ws in jm.state.params.items()}
    assert set(tm.params) == set(j)
    for op, ws in tm.params.items():
        for n, w in ws.items():
            np.testing.assert_allclose(w.float().numpy(), j[op][n],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{op}.{n}")


def test_compile_records_phases_and_only_data_parallel_skips_search():
    m = transformer_model(tff, search_budget=2, only_data_parallel=True)
    m.compile(tff.SGDOptimizer(lr=0.01), getattr(tff.LossType, MSE))
    assert m.searched_cost is None and m.strategy_provenance == {
        "source": "manual"}
    names = [e["name"] for e in m.search_trajectory.of_kind("phase")]
    assert names == ["lowering", "executor_build", "init_state"]


# -- strategy files ------------------------------------------------------------------

def test_strategy_files_move_both_ways(tmp_path):
    """A strategy the port exports is read by JAX's import_strategy and
    applies to a fresh JAX lowering; one JAX exports is read by the
    port's, with the same records."""
    jg, tg = _graphs("transformer")
    jmach, tmach = _machines(4)
    jres, tres = _resources(4)
    jbest, jr = jsearch.GraphSearchHelper(
        jsearch.SearchHelper(jsearch.CostModel(jmach, calibration=False)),
        jsub.generate_all_pcg_xfers([2, 4]), budget=3).graph_optimize(jg, jres)
    tbest, tr = tsearch.GraphSearchHelper(
        tsearch.SearchHelper(tsearch.CostModel(tmach, calibration=False)),
        tsub.generate_all_pcg_xfers([2, 4]), budget=3).graph_optimize(tg, tres)
    tpath, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tsio.export_strategy(tbest, tr, tpath)
    jsio.export_strategy(jbest, jr, jpath)
    from_port = jsio.import_strategy(tpath)
    from_jax = tsio.import_strategy(jpath)
    assert tsio.SCHEMA_VERSION == jsio.SCHEMA_VERSION

    def strip(recs):
        # names of inserted parallel ops and layer guids come from
        # process-wide counters; the rest must agree
        return [{k: v for k, v in r.items() if k not in ("name",
                                                         "layer_guid")}
                for r in recs.values()]

    assert strip(from_port) == strip(from_jax)
    assert strip(tsio.import_strategy(tpath)) == strip(from_port)
    # each applies to a fresh lowering of the other package (by name:
    # compute ops keep their layer names)
    for io, pkg, recs in ((jsio, jff, from_port), (tsio, tff, from_jax)):
        fresh = _lower(pkg, transformer_model(pkg))
        unmatched = io.apply_imported_strategy(fresh, recs, num_devices=4)
        assert all(not n.startswith(("op_multihead", "op_linear"))
                   for n in unmatched)
        assert [[d.degree for d in t.dims] for op in fresh.topo_order()
                for t in op.outputs] == \
            [degs for r in recs.values() for degs in r["output_degrees"]
             if r["op_type"] in ("OP_MULTIHEAD_ATTENTION", "OP_LINEAR")]


def test_export_strategy_flag_writes_what_import_reads(tmp_path):
    path = str(tmp_path / "s.json")
    m = transformer_model(tff, search_budget=2, export_strategy_file=path,
                          machine_model_file=_machine_file(tmp_path, 4))
    m.compile(tff.SGDOptimizer(lr=0.01), getattr(tff.LossType, MSE))
    recs = tsio.import_strategy(path)
    # the winner before the lowering to one device took its weight-shard
    # nodes out
    assert len(recs) == len(m.searched_views) >= len(m.graph.ops)
    assert json.loads(pathlib.Path(path).read_text())["cost"] == \
        pytest.approx(m.searched_cost, rel=COST_RTOL)
    assert jsio.import_strategy(path).keys() == recs.keys()


# -- flags and what is not ported --------------------------------------------------

_SEARCH_FLAGS = [
    ["--alpha", "1.5"], ["--search-alpha", "0.75"], ["--only-data-parallel"],
    ["--enable-parameter-parallel"], ["--enable-attribute-parallel"],
    ["--search-num-nodes", "2"], ["--search-num-workers", "8"],
    ["--measured-search"], ["--measured-cache", "c.json"],
    ["--export", "s.json"], ["--export-strategy", "t.json"],
    ["--machine-model-file", "m.cfg"], ["--substitution-json", "r.json"],
    ["--budget", "4", "--alpha", "x"],
]


@pytest.mark.parametrize("argv", _SEARCH_FLAGS, ids=" ".join)
def test_search_flags_parse_to_jax_fields(argv):
    t, j = tff.FFConfig(device="cpu"), jff.FFConfig()
    t0 = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    j0 = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    t.parse_args(argv)
    j.parse_args(argv)
    changed = {k for k in t0 if getattr(t, k) != t0[k]}
    assert changed, argv
    assert changed == {k for k in j0 if getattr(j, k) != j0[k]}
    for k in changed:
        assert getattr(t, k) == getattr(j, k), k
    # the new fields start at JAX's defaults
    for k in ("search_alpha", "only_data_parallel", "search_num_nodes",
              "search_num_workers", "measure_operator_costs",
              "measured_cache_path", "export_strategy_file",
              "machine_model_file", "substitution_json_path",
              "enable_parameter_parallel", "enable_attribute_parallel"):
        assert t0[k] == j0[k], k


@pytest.mark.parametrize("flag,what", [
    ("--memory-search", "memory-aware search"),
    ("--machine-model-version", "topology-aware machine model"),
    ("--import-strategy", "strategy import")])
def test_unported_search_flags_raise_naming_what_is_missing(flag, what):
    with pytest.raises(NotImplementedError, match=what):
        tff.FFConfig(device="cpu").parse_args([flag, "1"])


def test_unported_search_arguments_raise(tmp_path):
    m = transformer_model(tff, search_budget=1)
    with pytest.raises(NotImplementedError, match="calibration"):
        m.compile(tff.SGDOptimizer(), getattr(tff.LossType, MSE),
                  calibration={"mxu_efficiency": 0.5})
    with pytest.raises(NotImplementedError, match="artifact store"):
        m.compile(tff.SGDOptimizer(), getattr(tff.LossType, MSE),
                  artifact_store=object())
    topo = tmp_path / "topo.cfg"
    topo.write_text("num_nodes = 1\nnum_gpus_per_node = 4\n"
                    "topology_dims = 2x2\n")
    with pytest.raises(NotImplementedError, match="topology-aware"):
        tsearch.parse_machine_config(str(topo))
    # a device too small for the winner: the pipeline and memory-aware
    # searches that would look further are not ported
    small = tmp_path / "small.cfg"
    small.write_text("num_nodes = 1\nnum_gpus_per_node = 4\n"
                     "device_mem = 100000\n")
    m = transformer_model(tff, search_budget=1, machine_model_file=str(small))
    with pytest.raises(NotImplementedError, match="pipeline search"):
        m.compile(tff.SGDOptimizer(), getattr(tff.LossType, MSE))


# -- the measurer --------------------------------------------------------------------

def test_measurer_runs_on_cpu_and_caches(tmp_path):
    tg, = _graphs("attention_block")[1:]
    ops = tg.topo_order()
    cache = str(tmp_path / "measured.json")
    meas = OperatorMeasurer(repeats=2, device="cpu", cache_path=cache)
    view = tmv.MachineView()
    times = [meas(op, view) for op in ops]
    assert all(f > 0 and b > 0 for f, b in times)
    assert [meas(op, view) for op in ops] == times   # cache hits
    assert not meas.fallbacks
    rec = meas.measurements[next(iter(meas.measurements))]
    assert rec.fwd_bytes > 0 and rec.total_s >= rec.fwd_s
    # a new measurer reads the disk cache without measuring
    again = OperatorMeasurer(repeats=2, device="cpu", cache_path=cache)
    again._measure = None
    assert [again(op, view) for op in ops] == times
    # per-shard: a head-partitioned attention op is timed at its shard,
    # as many shards as a device of the view runs
    hg = next(iter(tsub.partition_attention_combine(2).apply(tg)))
    mha = next(o for o in hg.topo_order()
               if o.op_type.name == "OP_MULTIHEAD_ATTENTION")
    for parts, per_device in ((2, 1), (1, 2)):
        view = tmv.MachineView(dim=(parts,))
        f, b = meas(mha, view)
        rec = meas.measurements[meas.key_of(mha, view)]
        assert f > 0 and b > 0 and not meas.fallbacks
        assert rec.shards_per_device == per_device
        assert rec.weight_shapes[0] == (128, HEADS // 2, 128 // HEADS)
    # and with its queries split too: 2 x 2 shards over 2 devices
    both = next(iter(tsub.partition_batch(2).apply(hg)))
    mha2 = next(o for o in both.topo_order()
                if o.op_type.name == "OP_MULTIHEAD_ATTENTION")
    view = tmv.MachineView(dim=(2,))
    meas(mha2, view)
    rec = meas.measurements[meas.key_of(mha2, view)]
    assert rec.shard_shapes[0][0] == 4 and rec.shards_per_device == 2


def test_measured_search_compile_trains_on_cpu():
    m = transformer_model(tff, search_budget=2, measure_operator_costs=True,
                          search_num_workers=2)
    with pytest.warns(UserWarning):
        m.compile(tff.SGDOptimizer(lr=0.01), getattr(tff.LossType, MSE))
    assert m.searched_cost > 0
    cm = m.search_cost_model
    assert cm.measured_hits > 0 and not m.measurer.fallbacks
    assert len(m.measurer.measurements) == len(cm.measured)
    # every compute op of the winner was priced from a measurement
    table = m.searched_op_costs
    assert [e["op_type"] for e in table] == \
        ["OP_MULTIHEAD_ATTENTION", "OP_LINEAR", "OP_LINEAR"] * LAYERS
    assert all(e["measured"] and e["measurement"] is not None
               and e["fwd_s"] == e["measurement"].fwd_s for e in table)
    assert all(e["analytic_fwd_s"] > 0 for e in table)
    x = np.random.RandomState(0).randn(BATCH, SEQ, HIDDEN).astype(np.float32)
    m.fit(x, x, epochs=1, verbose=False)


# -- the executor on a searched graph ----------------------------------------------------

def test_parallel_ops_are_the_identity_and_take_no_seed_index():
    """A graph with the search's parallel ops runs on one device like the
    lowering it came from: every parallel op passes its input on, and
    the compute indices (the dropout seeds) skip them."""
    from flexflow_tpu_torch.parallel import parallel_ops
    from flexflow_tpu_torch.parallel.executor import PCGExecutor

    def build():
        m = tff.FFModel(_cfg(tff, batch_size=4))
        x = m.create_tensor((4, 16, 32), tff.DataType.DT_FLOAT)
        t = m.multihead_attention(x, x, x, 32, 4, dropout=0.25)
        t = m.dropout(t, 0.3)
        m.dense(t, 32)
        return _lower(tff, m)

    plain = build()
    rewritten = next(iter(tsub.reduce_linear_partition(2).apply(build())))
    assert any(op.is_parallel_op for op in rewritten.ops)
    outs = []
    for g in (plain, rewritten):
        ex = PCGExecutor(g, torch.device("cpu"), seed=5)
        params = ex.init_params()
        x = torch.as_tensor(np.random.RandomState(1).randn(4, 16, 32),
                            dtype=torch.float32)
        vals = ex.apply(params, {ex.input_pts[0].guid: x}, training=True,
                        rng=11)
        outs.append((ex.drawing_ops, vals[ex.logits_pt.guid]))
    assert outs[0][0] == outs[1][0]
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=0, atol=0)
    # a Reduction whose input carries the partial copies sums them
    red = next(o for o in next(iter(
        tsub.reduce_linear_partition(2).apply(_graphs("mlp")[1]))).ops
        if o.op_type.name == "OP_REDUCTION")
    parts = torch.ones(2, 64, 256)
    assert torch.equal(parallel_ops.execute(red, [parts])[0],
                       torch.full((64, 256), 2.0))
    one = parts[0]
    assert parallel_ops.execute(red, [one])[0] is one


def test_search_modules_import_no_jax():
    code = ("import sys, flexflow_tpu_torch.search,"
            " flexflow_tpu_torch.search.measure,"
            " flexflow_tpu_torch.search.substitution_loader,"
            " flexflow_tpu_torch.search.memory_optimization,"
            " flexflow_tpu_torch.analysis.substitution_lint,"
            " flexflow_tpu_torch.runtime.strategy_io,"
            " flexflow_tpu_torch.runtime.verify,"
            " flexflow_tpu_torch.parallel.strategies;"
            " bad = sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'flexflow_tpu.')) or m == 'flexflow_tpu');"
            " print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=PORT_DIR.parent, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for sub in ("search", "analysis", "obs", "utils"):
        files = list((PORT_DIR / sub).rglob("*.py"))
        assert files, sub
        for p in files:
            text = p.read_text()
            assert "import jax" not in text and "flexflow_tpu." not in text, p
