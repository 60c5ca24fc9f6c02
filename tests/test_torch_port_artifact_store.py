"""The strategy artifact store of flexflow_tpu_torch
(runtime/artifact_store.py) and compile(artifact_store=) against the JAX
package's.

Parity: graph_fingerprint and key_id are the same hex strings for the
same model in both packages; strategy_payload writes the same JSON for
the same search winner (search-inserted ops, whose names carry a
process-global id, compared by topological position; the cost to rel
1e-12, the same float arithmetic); an entry the JAX package's store
wrote is read by the port's store, and its strategy replays onto the
port's lowering to the same views and degrees. Then the JAX package's
store tests (tests/test_artifact_store.py), ported: the envelope round
trip, stale and corrupt entries (truncated, bit-flipped, not JSON, a
newer schema), the two-writer race, LRU eviction, stale temporaries,
compile's miss-then-hit with no search and bit-equal training,
corrupt, stale and unreplayable entries degrading to a fresh search,
the FaultInjector sites, the counters and the quarantine sets.
"""
import json
import os
import threading
import time

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
from flexflow_tpu.runtime import artifact_store as jas
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu_torch import obs
from flexflow_tpu_torch.models import build_dlrm as tdlrm
from flexflow_tpu_torch.models import build_transformer as ttransformer
from flexflow_tpu_torch.parallel.executor import _tensors
from flexflow_tpu_torch.pcg import lowering as tlowering
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.runtime import artifact_store as tas
from flexflow_tpu_torch.runtime.artifact_store import (
    ArtifactCorruptionError,
    ArtifactStore,
    make_key,
)
from flexflow_tpu_torch.runtime.resilience import FaultInjector

COST_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _no_jax_calibration(monkeypatch):
    monkeypatch.setattr(jcm, "load_default_calibration", lambda: None)


def _jcfg(**kw):
    cfg = jff.FFConfig()
    cfg.workersPerNode = 1
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _models(name):
    """The named model built in both packages (uncompiled)."""
    out = []
    for pkg in (jff, tff):
        cfg = (_jcfg(batch_size=8) if pkg is jff
               else tff.FFConfig(device="cpu", batch_size=8))
        m = pkg.FFModel(cfg)
        if name == "transformer":
            (jtransformer if pkg is jff else ttransformer)(m, 8, 32, 64, 4, 2)
        elif name == "dlrm":
            (jdlrm if pkg is jff else tdlrm)(
                m, 8, embedding_sizes=(1000,) * 2, mlp_bot=(16, 32),
                mlp_top=(32, 2))
        else:
            x = m.create_tensor((8, 4), pkg.DataType.DT_FLOAT)
            t = m.dense(x, 16, pkg.ActiMode.AC_MODE_RELU)
            m.softmax(m.dense(t, 3))
        out.append(m)
    return out


def _lowered(name):
    jm, tm = _models(name)
    return (jlowering.layers_to_pcg(jm.layers)[0],
            tlowering.layers_to_pcg(tm.layers)[0])


def _searched(name, workers=4):
    """Both packages' best-first search winners over the lowering, on 1
    node of `workers` (the generated xfers), with their views."""
    jg, tg = _lowered(name)
    degrees = [d for d in (2, 4, 8) if d <= workers]
    out = []
    for pkg, mv, g in ((jsearch, jmv, jg), (tsearch, tmv, tg)):
        cm = pkg.CostModel(pkg.MachineModel(num_nodes=1,
                                            workers_per_node=workers),
                           calibration=False)
        best, r = pkg.GraphSearchHelper(
            pkg.SearchHelper(cm), pkg.generate_all_pcg_xfers(degrees),
            budget=3).graph_optimize(g, mv.MachineResource(1, workers,
                                                           workers))
        out.append((best, r))
    return out


def _views_by_position(graph, views):
    pos = {op.guid: i for i, op in enumerate(graph.topo_order())}
    return sorted((pos.get(g, -1), v.start_device_id, tuple(v.dim),
                   tuple(v.stride)) for g, v in views.items())


def _normalized(payload, fresh_names):
    """A payload with the names of search-inserted ops (not in the fresh
    lowering: their names carry a process-global id) replaced by their
    topological position, and without the cost (compared apart)."""
    rename = {n["name"]: f"#{i}" for i, n in enumerate(payload["nodes"])
              if n["name"] not in fresh_names}
    nodes = []
    for n in payload["nodes"]:
        n = dict(n, name=rename.get(n["name"], n["name"]))
        n["inputs"] = [[k, rename.get(a, a) if k == "node" else a, b]
                       for k, a, b in n["inputs"]]
        nodes.append(n)
    return dict(payload, nodes=nodes, cost=None)


# -- parity -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["transformer", "dlrm", "mlp"])
def test_fingerprints_and_keys_match_jax(name):
    jg, tg = _lowered(name)
    assert tas.graph_fingerprint(tg) == jas.graph_fingerprint(jg)
    topo = {"num_devices": 1, "platform": "gpu",
            "device_kinds": ["NVIDIA H100 80GB HBM3"]}
    assert tas.topology_digest(topo) == jas.topology_digest(topo)
    table = {("OP_LINEAR", (8, 4)): (1e-5, 2e-5)}
    glb = {"overlap_efficiency": 0.8}
    for t, g in ((None, None), (table, None), (table, glb)):
        assert tas.calibration_fingerprint(t, g) == \
            jas.calibration_fingerprint(t, g)
    parts = {"graph": tas.graph_fingerprint(tg),
             "topology": tas.topology_digest(topo),
             "calibration": "none"}
    for obj, n in (("train", 1), ("decode", 8)):
        tk = tas.make_key(objective=obj, num_devices=n, **parts)
        jk = jas.make_key(objective=obj, num_devices=n, **parts)
        assert tk == jk and tas.key_id(tk) == jas.key_id(jk)


@pytest.mark.parametrize("name", ["transformer", "dlrm"])
def test_strategy_payload_matches_jax(name):
    (jb, jr), (tb, tr) = _searched(name)
    assert _views_by_position(tb, tr.views) == _views_by_position(jb, jr.views)
    fresh = {op.name for op in _lowered(name)[1].ops}
    jp = jas.strategy_payload(jb, jr.views, cost=jr.cost,
                              mesh_axes={"data": 4}, provenance={"w": 1})
    tp = tas.strategy_payload(tb, tr.views, cost=tr.cost,
                              mesh_axes={"data": 4}, provenance={"w": 1})
    np.testing.assert_allclose(tp["cost"], jp["cost"], rtol=COST_RTOL)
    assert json.dumps(_normalized(tp, fresh), sort_keys=True) == \
        json.dumps(_normalized(jp, fresh), sort_keys=True)
    if name == "dlrm":   # its winner inserts parallel ops: they ride along
        assert any(n["params"] for n in tp["nodes"])


@pytest.mark.parametrize("name", ["transformer", "dlrm"])
def test_jax_written_entry_replays_in_the_port(tmp_path, name):
    """An entry the JAX package's store wrote is read back by the port's
    store, and its strategy rebuilds onto the port's fresh lowering with
    the JAX winner's views, op types and per-dim sharding."""
    (jb, jr), (tb, tr) = _searched(name)
    key = make_key(graph=jas.graph_fingerprint(_lowered(name)[0]),
                   topology="t", calibration="none", num_devices=4)
    jas.ArtifactStore(str(tmp_path)).put(key, jas.strategy_payload(
        jb, jr.views, cost=jr.cost, mesh_axes={"data": 4}))
    store = ArtifactStore(str(tmp_path))
    payload = store.get(key)
    assert store.counts == {"hit": 1}
    fresh = _lowered(name)[1]
    g2, views, axes, cost = tas.replay_strategy(fresh, payload,
                                                num_devices=4)
    assert axes == {"data": 4} and cost == jr.cost
    assert _views_by_position(g2, views) == _views_by_position(jb, jr.views)
    assert [op.op_type.name for op in g2.topo_order()] == \
        [op.op_type.name for op in jb.topo_order()]
    assert [[(d.size, d.degree, d.parallel_idx, d.is_replica_dim)
             for d in t.dims] for op in g2.topo_order()
            for t in op.outputs + op.weights] == \
        [[(d.size, d.degree, d.parallel_idx, d.is_replica_dim)
          for d in t.dims] for op in jb.topo_order()
         for t in op.outputs + op.weights]


# -- the store (tests/test_artifact_store.py, ported) -------------------------------

def small_model(store=None, budget=20, hidden=16, batch=32, workers=4):
    m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=batch,
                                 search_budget=budget,
                                 search_num_workers=workers))
    x = m.create_tensor((batch, 4), tff.DataType.DT_FLOAT)
    t = m.dense(x, hidden, tff.ActiMode.AC_MODE_RELU)
    t = m.dense(t, 3)
    m.softmax(t)
    import warnings

    with warnings.catch_warnings():
        # the 4-worker winner's views address devices the one device
        # lacks: compile says so before it demotes them
        warnings.filterwarnings("ignore", message="searched strategy failed")
        m.compile(tff.SGDOptimizer(lr=0.1, momentum=0.9),
                  tff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  [tff.MetricsType.METRICS_ACCURACY], artifact_store=store)
    return m


def dataset(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = rng.randint(0, 3, (n, 1)).astype(np.int32)
    return x, y


def count_searches(monkeypatch):
    calls = []
    orig = tff.FFModel._run_strategy_search

    def spy(self, ndev):
        calls.append(ndev)
        return orig(self, ndev)

    monkeypatch.setattr(tff.FFModel, "_run_strategy_search", spy)
    return calls


def _key():
    return make_key(graph="g", topology="t", calibration="c", num_devices=8)


def test_round_trip(tmp_path):
    st = ArtifactStore(str(tmp_path))
    k = _key()
    assert st.get(k) is None
    st.put(k, {"kind": "strategy", "ops": [], "mesh_axes": {"data": 8}})
    assert st.get(k)["mesh_axes"] == {"data": 8}
    k2 = make_key(graph="g", topology="t", calibration="OTHER",
                  num_devices=8)
    assert st.get(k2) is None
    assert st.get(k) is not None
    assert st.counts == {"miss": 2, "put": 1, "hit": 2}


def test_fingerprint_mismatch_rejected(tmp_path):
    st = ArtifactStore(str(tmp_path))
    k = _key()
    path = st.put(k, {"payload": True})
    env = json.load(open(path))
    env["key"]["graph"] = "someone-else"
    json.dump(env, open(path, "w"))
    assert st.get(k) is None
    assert not os.path.exists(path)
    assert os.listdir(st.quarantine_dir)
    assert st.counts["stale"] == 1


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "not_json"])
def test_corrupt_entry_typed_error(tmp_path, damage):
    st = ArtifactStore(str(tmp_path))
    k = _key()
    path = st.put(k, {"ops": list(range(50))})
    if damage == "truncate":
        with open(path, "r+b") as f:
            f.truncate(40)
    elif damage == "bitflip":
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0x40
        open(path, "wb").write(bytes(raw))
    else:
        open(path, "w").write("definitely { not json")
    with pytest.raises(ArtifactCorruptionError):
        st.get(k)
    assert not os.path.exists(path)
    assert st.get(k) is None


def test_newer_schema_rejected(tmp_path):
    st = ArtifactStore(str(tmp_path))
    k = _key()
    path = st.put(k, {"x": 1})
    env = json.load(open(path))
    env["schema"] = 999
    json.dump(env, open(path, "w"))
    with pytest.raises(ArtifactCorruptionError, match="schema"):
        st.get(k)


def test_concurrent_two_writer_race(tmp_path):
    """Writers racing to populate one key end with ONE intact entry."""
    st = ArtifactStore(str(tmp_path))
    k = _key()
    errors = []

    def writer(i):
        try:
            for j in range(10):
                st.put(k, {"writer": i, "round": j,
                           "bulk": ["x" * 50] * 20})
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    got = st.get(k)
    assert got is not None and got["round"] == 9
    assert not [n for n in os.listdir(st.entries_dir) if ".tmp-" in n]


def test_lru_eviction(tmp_path):
    st = ArtifactStore(str(tmp_path), max_entries=3)
    keys = [make_key(graph=f"g{i}", topology="t", calibration="c",
                     num_devices=8) for i in range(5)]
    for i, k in enumerate(keys):
        st.put(k, {"i": i})
        time.sleep(0.01)
        if i == 2:
            st.get(keys[0])
            time.sleep(0.01)
    assert len(st.entries()) == 3
    assert st.get(keys[0]) is not None
    assert st.get(keys[1]) is None
    assert st.counts["evict"] == 2


def test_clean_stale_tmp_on_open(tmp_path):
    st = ArtifactStore(str(tmp_path))
    k = _key()
    st.put(k, {"x": 1})
    litter = os.path.join(st.entries_dir, "abc.json.tmp-999-1")
    open(litter, "w").write("half-written")
    st2 = ArtifactStore(str(tmp_path))
    assert not os.path.exists(litter)
    assert st2.get(k) is not None


def test_executable_cache_is_unavailable(tmp_path, caplog):
    """PyTorch has no executables to store: asked for, the leg logs why
    and reports False (the JAX package's "unavailable" leg)."""
    import logging

    with caplog.at_level(logging.INFO,
                         logger="flexflow_tpu_torch.runtime.artifact_store"):
        st = ArtifactStore(str(tmp_path), executable_cache=True)
    assert st.executable_cache_enabled is False
    assert "strategy-only" in caplog.text
    assert not os.path.exists(os.path.join(str(tmp_path), "xla_cache"))


def _state_tensors(m):
    return _tensors((m.state.params, m.state.opt_state))


def test_compile_miss_then_hit_skips_search(tmp_path, monkeypatch):
    st = ArtifactStore(str(tmp_path))
    m1 = small_model(st)
    assert m1.strategy_provenance == {"source": "search",
                                      "cause": "cache_miss"}
    assert len(st.entries()) == 1
    calls = count_searches(monkeypatch)
    m2 = small_model(st)
    assert calls == []
    assert m2.strategy_provenance["source"] == "artifact_cache"
    assert m2.strategy_provenance["key"] == m1._artifact_key
    assert "strategy_search" not in m2.compile_phase_s
    assert not m2.search_trajectory.of_kind("search_begin")
    assert _views_by_position(m2.graph, m2.searched_views) == \
        _views_by_position(m1.graph, m1.searched_views)

    def sharding(m):
        return {op.name: [[(d.size, d.degree, d.parallel_idx,
                            d.is_replica_dim) for d in t.dims]
                          for t in list(op.outputs) + list(op.weights)]
                for op in m.graph.ops}

    # the replay is faithful, and demoted to the one device exactly as
    # the search's winner was
    assert sharding(m1) == sharding(m2)
    assert m1.searched_axes == m2.searched_axes
    x, y = dataset()
    m1.fit(x, y, epochs=1, verbose=False)
    m2.fit(x, y, epochs=1, verbose=False)
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(m1),
                                                 _state_tensors(m2)))


def test_a_resharded_compute_op_keeps_its_name_and_replays(tmp_path,
                                                           monkeypatch):
    """On the default machine (h100_machine(), the card's tile quanta)
    small_model's winner reshards its first Linear through a rewrite
    that rebuilds the op; the rebuilt op keeps the lowering's name, so
    the executor's weights, the stored winner's replay and a second
    compile's hit all find it."""
    st = ArtifactStore(str(tmp_path))
    m1 = small_model(st)
    resharded = [op for op in m1.graph.topo_order()
                 if op.op_type.name == "OP_LINEAR"
                 and op.inputs[0].owner_op is not None
                 and op.inputs[0].owner_op.op_type.name == "OP_REPARTITION"]
    assert [op.name for op in resharded] == ["op_linear_0"]
    compute = sorted(op.name for op in m1.graph.ops if not op.is_parallel_op)
    assert compute == ["op_linear_0", "op_linear_1", "op_softmax_2"]
    assert sorted(m1.params) == ["op_linear_0", "op_linear_1"]
    calls = count_searches(monkeypatch)
    m2 = small_model(st)
    assert calls == []
    assert m2.strategy_provenance["source"] == "artifact_cache"
    assert st.counts.get("stale", 0) == 0
    assert _views_by_position(m2.graph, m2.searched_views) == \
        _views_by_position(m1.graph, m1.searched_views)


def test_ambient_store_is_picked_up(tmp_path):
    st = ArtifactStore(str(tmp_path))
    assert tas.get_ambient() is None
    with st.ambient() as s:
        assert tas.get_ambient() is s
        m = small_model()
    assert tas.get_ambient() is None
    assert m.artifact_store is st and st.counts == {"miss": 1, "put": 1}
    # a recompile of the same model reuses the store it attached
    m.compile(tff.SGDOptimizer(lr=0.1, momentum=0.9),
              tff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    assert m.strategy_provenance["source"] == "artifact_cache"


def test_payload_schema_mismatch_degrades_stale(tmp_path, monkeypatch):
    st = ArtifactStore(str(tmp_path))
    m1 = small_model(st)
    payload = st.get(m1._artifact_key)
    payload["strategy_schema"] = payload["strategy_schema"] - 1
    st.put(m1._artifact_key, payload)
    calls = count_searches(monkeypatch)
    with pytest.warns(UserWarning, match="could not be replayed"):
        m2 = small_model(st)
    assert len(calls) == 1 and m2.strategy_provenance["source"] == "search"
    assert st.counts["stale"] == 1


def test_compile_corrupt_entry_falls_back_to_search(tmp_path, monkeypatch):
    st = ArtifactStore(str(tmp_path))
    small_model(st)
    [entry] = st.entries()
    path = os.path.join(st.entries_dir, entry)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x10
    open(path, "wb").write(bytes(raw))
    calls = count_searches(monkeypatch)
    m = small_model(st)
    assert len(calls) == 1
    assert m.strategy_provenance == {"source": "search",
                                     "cause": "cache_corrupt"}
    assert len(st.entries()) == 1
    calls.clear()
    m2 = small_model(st)
    assert calls == [] and m2.strategy_provenance["source"] == \
        "artifact_cache"


def test_compile_unreplayable_entry_degrades_stale(tmp_path, monkeypatch):
    """An intact entry naming another model's compute ops is quarantined
    as stale; compile re-lowers and searches afresh, and trains."""
    st = ArtifactStore(str(tmp_path))
    m1 = small_model(st)
    payload = {
        "kind": "strategy",
        "strategy_schema": tas.STRATEGY_PAYLOAD_SCHEMA,
        "cost": 1.0, "mesh_axes": {"data": 1},
        "inputs": [[[32, 1, -1, 0, None], [4, 1, -1, 0, None]]],
        "nodes": [{"name": "op_from_another_model_0",
                   "op_type": "OP_LINEAR", "params": None,
                   "inputs": [["input", 0, 0]],
                   "outputs": [{"dtype": "DT_FLOAT",
                                "dims": [[32, 1, -1, 0, None],
                                         [4, 1, -1, 0, None]]}],
                   "weights": [], "machine_view": None}],
        "provenance": {},
    }
    st.put(m1._artifact_key, payload)
    calls = count_searches(monkeypatch)
    with pytest.warns(UserWarning, match="could not be replayed"):
        m2 = small_model(st)
    assert len(calls) == 1
    assert m2.strategy_provenance["source"] == "search"
    x, y = dataset()
    m2.fit(x, y, epochs=1, verbose=False)
    assert m2.state.step == 2


def test_fault_injection_sites(tmp_path):
    fi = FaultInjector()
    st = ArtifactStore(str(tmp_path), fault_injector=fi)
    k = _key()
    st.put(k, {"x": 1})
    fi.inject("artifact_stale")
    assert st.get(k) is None
    st.put(k, {"x": 2})
    fi.inject("artifact_corruption")
    with pytest.raises(ArtifactCorruptionError, match="injected"):
        st.get(k)
    assert st.get(k) is None
    assert fi.fired == {"artifact_stale": 1, "artifact_corruption": 1}


def test_compile_survives_injected_corruption(tmp_path, monkeypatch):
    fi = FaultInjector()
    st = ArtifactStore(str(tmp_path), fault_injector=fi)
    m1 = small_model(st)
    fi.inject("artifact_corruption")
    calls = count_searches(monkeypatch)
    m = small_model(st)
    assert len(calls) == 1
    assert m.strategy_provenance["cause"] == "cache_corrupt"
    assert _views_by_position(m.graph, m.searched_views) == \
        _views_by_position(m1.graph, m1.searched_views)


def test_a_broken_store_never_fails_the_compile(tmp_path):
    class Broken:
        def get(self, key):
            raise OSError("disk gone")

        def put(self, key, payload):
            raise OSError("disk gone")

    with pytest.warns(UserWarning, match="lookup failed"):
        m = small_model(Broken())
    assert m.strategy_provenance == {"source": "search",
                                     "cause": "cache_corrupt"}


def test_metrics_counted(tmp_path):
    with obs.session(obs.TelemetryConfig(dir=str(tmp_path / "tel"),
                                         flight_recorder=False,
                                         anomaly_detection=False)) as tel:
        st = ArtifactStore(str(tmp_path / "st"))
        k = _key()
        st.get(k)
        st.put(k, {"x": 1})
        st.get(k)
        st.note_stale(k, "replay failed")
        for event, expect in [("miss", 1), ("put", 1), ("hit", 1),
                              ("stale", 1)]:
            c = tel.metrics.counter("ff_artifact_cache_total", "",
                                    event=event)
            assert c.value == expect, event
    events = obs.read_events_jsonl(str(tmp_path / "tel" / "events.jsonl"))[0]
    assert [e["args"]["event"] for e in events
            if e["name"] == "artifact_cache"] == ["miss", "put", "hit",
                                                  "stale"]


def test_quarantine_set_round_trip(tmp_path):
    st = ArtifactStore(str(tmp_path))
    assert st.load_quarantine("scope") == set()
    st.add_quarantine("scope", {"aaa", "bbb"})
    st.add_quarantine("scope", {"ccc"})
    assert ArtifactStore(str(tmp_path)).load_quarantine("scope") == \
        {"aaa", "bbb", "ccc"}
    assert st.load_quarantine("other") == set()
    # a corrupt quarantine file degrades to the empty set, counted
    path = os.path.join(st.quarantine_dir, "scope.q.json")
    open(path, "w").write("{ not json")
    assert st.load_quarantine("scope") == set()
    assert st.counts["corrupt"] == 1
