"""The MCMC search and its task-graph simulator (Python and native), the
native data loader, the topology-aware machine model and the
memory-aware search of flexflow_tpu_torch against the JAX package's.

The same graphs are built in both packages (the flagship Transformer at
batch 8, seq 32, hidden 64, 4 heads, 2 blocks; an MLP; AlexNet at 67x67;
DLRM with two 1000-row tables) and go through both packages' simulators,
annealers, machine models and searches.

Tolerances: the simulation, the machine models and the searches are the
same host arithmetic in the same order in both packages (Python over the
same values; the native annealers compile one C++ source), so costs
agree to rel 1e-12 (a few ulps); views, paths, hop counts, lambdas,
bytes and batch orders must be equal. The JAX side's shipped calibration
(a fit of its own chip) is off (`calibration=False`), as the port applies
none.
"""
import dataclasses
import pathlib
import random
import subprocess
import sys
import warnings

import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu.search as jsearch
import flexflow_tpu_torch as tff
import flexflow_tpu_torch.search as tsearch
from flexflow_tpu import native as jnative
from flexflow_tpu.models.alexnet import build_alexnet as jalexnet
from flexflow_tpu.models.dlrm import build_dlrm as jdlrm
from flexflow_tpu.models.transformer import build_transformer as jtransformer
from flexflow_tpu.pcg import lowering as jlowering
from flexflow_tpu.pcg import machine_view as jmv
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.search import memory_optimization as jmem
from flexflow_tpu.search import network as jnet
from flexflow_tpu.search import substitution as jsub
from flexflow_tpu_torch import native as tnative
from flexflow_tpu_torch.models import build_alexnet as talexnet
from flexflow_tpu_torch.models import build_dlrm as tdlrm
from flexflow_tpu_torch.models import build_transformer as ttransformer
from flexflow_tpu_torch.obs.trajectory import SearchTrajectory
from flexflow_tpu_torch.pcg import lowering as tlowering
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.search import memory_optimization as tmem
from flexflow_tpu_torch.search import network as tnet
from flexflow_tpu_torch.search import substitution as tsub

COST_RTOL = 1e-12
REPO = pathlib.Path(__file__).resolve().parent.parent
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"


@pytest.fixture(autouse=True)
def _no_jax_calibration(monkeypatch):
    """compile() on the JAX side prices with the analytic roofline alone,
    as the port does."""
    monkeypatch.setattr(jcm, "load_default_calibration", lambda: None)


def _cfg(pkg, **kw):
    if pkg is tff:
        return tff.FFConfig(device="cpu", **kw)
    cfg = jff.FFConfig()
    cfg.workersPerNode = 1
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def transformer_model(pkg, **cfg):
    m = pkg.FFModel(_cfg(pkg, batch_size=8, **cfg))
    (jtransformer if pkg is jff else ttransformer)(m, 8, 32, 64, 4, 2)
    return m


def mlp_model(pkg):
    m = pkg.FFModel(_cfg(pkg))
    x = m.create_tensor((64, 256), pkg.DataType.DT_FLOAT)
    t = m.dense(x, 512, pkg.ActiMode.AC_MODE_RELU)
    m.dense(t, 128)
    return m


def alexnet_model(pkg):
    m = pkg.FFModel(_cfg(pkg, batch_size=8))
    (jalexnet if pkg is jff else talexnet)(m, 8, 10, 67, 67)
    return m


def dlrm_model(pkg):
    m = pkg.FFModel(_cfg(pkg, batch_size=64))
    (jdlrm if pkg is jff else tdlrm)(
        m, 64, embedding_sizes=(1000,) * 2, mlp_bot=(16, 32),
        mlp_top=(32, 2))
    return m


GRAPHS = {"transformer": transformer_model, "mlp": mlp_model,
          "alexnet": alexnet_model, "dlrm": dlrm_model}


def _graphs(name, partition=None):
    out = []
    for pkg, low, sub in ((jff, jlowering, jsub), (tff, tlowering, tsub)):
        g = low.layers_to_pcg(GRAPHS[name](pkg).layers)[0]
        if partition:
            g = next(iter(sub.partition_batch(partition).apply(g)))
        out.append(g)
    return out


def _view_key(v):
    return (v.start_device_id, tuple(v.dim), tuple(v.stride))


def _views_by_position(graph, views):
    pos = {op.guid: i for i, op in enumerate(graph.topo_order())}
    return sorted((pos.get(g, -1), _view_key(v)) for g, v in views.items())


def _op_types(graph):
    return [op.op_type.name for op in graph.topo_order()]


def _machines(kind, workers=8, nodes=1):
    if kind == "flat":
        return (jsearch.MachineModel(num_nodes=nodes,
                                     workers_per_node=workers),
                tsearch.MachineModel(num_nodes=nodes,
                                     workers_per_node=workers))
    dims = {8: (2, 4), 4: (2, 2)}[workers]
    return tuple(pkg.TopologyAwareMachineModel(
        num_nodes=nodes, workers_per_node=workers,
        topology=pkg.TorusTopology(dims=dims)) for pkg in (jnet, tnet))


def _cost_models(kind, workers=8, nodes=1, **kw):
    jm, tm = _machines(kind, workers, nodes)
    return (jsearch.CostModel(jm, calibration=False, **kw),
            tsearch.CostModel(tm, calibration=False, **kw))


def _random_views(mc, graph, seed):
    """One valid view per op, drawn by index from the op's candidates with
    a seeded generator (the candidates are in the same order in both
    packages, so both draw the same assignment)."""
    rng = random.Random(seed)
    machine = mc.cost_model.machine
    return {op.guid: rng.choice(mc._valid_views(op, machine))
            for op in graph.topo_order()}


# -- simulate_runtime -----------------------------------------------------------

@pytest.mark.parametrize("name", ["transformer", "mlp", "alexnet", "dlrm"])
@pytest.mark.parametrize("machine", ["flat", "topology"])
@pytest.mark.parametrize("overlap", [False, True])
def test_simulate_runtime_matches_jax(name, machine, overlap):
    """The data-parallel start and a random assignment, on the lowering
    and on a batch-partitioned graph."""
    jc, tc = _cost_models(machine, overlap_backward_update=overlap)
    for jg, tg in (_graphs(name), _graphs(name, 4)):
        assert _op_types(jg) == _op_types(tg)
        jmc, tmc = jsearch.MCMCSearch(jc), tsearch.MCMCSearch(tc)
        for jv, tv in ((jmc.data_parallel_start(jg),
                        tmc.data_parallel_start(tg)),
                       (_random_views(jmc, jg, 7), _random_views(tmc, tg, 7))):
            assert _views_by_position(tg, tv) == _views_by_position(jg, jv)
            np.testing.assert_allclose(
                tsearch.simulate_runtime(tg, tv, tc),
                jsearch.simulate_runtime(jg, jv, jc), rtol=COST_RTOL)


# -- the annealers ----------------------------------------------------------------

@pytest.mark.parametrize("name,partition", [("transformer", 4), ("mlp", None),
                                            ("dlrm", 4)])
@pytest.mark.parametrize("machine", ["flat", "topology"])
def test_python_annealer_matches_jax(name, partition, machine):
    jg, tg = _graphs(name, partition)
    jc, tc = _cost_models(machine)
    jv, jcost = jsearch.MCMCSearch(jc, seed=3).optimize(
        jg, budget=40, use_native=False)
    traj = SearchTrajectory()
    tv, tcost = tsearch.MCMCSearch(tc, seed=3, trajectory=traj).optimize(
        tg, budget=40, use_native=False)
    np.testing.assert_allclose(tcost, jcost, rtol=COST_RTOL)
    assert _views_by_position(tg, tv) == _views_by_position(jg, jv)
    assert len(traj.of_kind("mcmc_iter")) == 40
    assert not traj.of_kind("mcmc_native")


@pytest.mark.parametrize("name,partition", [("transformer", 4), ("mlp", None),
                                            ("alexnet", 2)])
def test_native_annealer_matches_jax(name, partition):
    """Each package's own library, built from the same C++ source, fed
    the same flattened problem and the same seed."""
    assert jnative.available() and tnative.available()
    jg, tg = _graphs(name, partition)
    jc, tc = _cost_models("flat")
    jmc = jsearch.MCMCSearch(jc, seed=5)
    traj = SearchTrajectory()
    tmc = tsearch.MCMCSearch(tc, seed=5, trajectory=traj)
    jstart = _random_views(jmc, jg, 11)
    tstart = _random_views(tmc, tg, 11)
    jv, jcost = jmc.optimize(jg, budget=300, start=jstart, use_native=True)
    tv, tcost = tmc.optimize(tg, budget=300, start=tstart, use_native=True)
    np.testing.assert_allclose(tcost, jcost, rtol=COST_RTOL)
    assert _views_by_position(tg, tv) == _views_by_position(jg, jv)
    assert [e["cost"] for e in traj.of_kind("mcmc_native")] == [tcost]
    assert not traj.of_kind("mcmc_iter")
    # the native simulator agrees with the Python oracle on the best
    np.testing.assert_allclose(tsearch.simulate_runtime(tg, tv, tc), tcost,
                               rtol=1e-6)


def test_native_falls_back_to_python_without_the_library(monkeypatch):
    """No toolchain: optimize() runs the Python annealer (its own events),
    as the JAX package's does."""
    tg = _graphs("mlp")[1]
    tc = _cost_models("flat")[1]
    monkeypatch.setattr(tnative, "available", lambda: False)
    traj = SearchTrajectory()
    want = tsearch.MCMCSearch(tc, seed=1).optimize(tg, budget=20,
                                                   use_native=False)
    got = tsearch.MCMCSearch(tc, seed=1, trajectory=traj).optimize(
        tg, budget=20, use_native=True)
    assert got[1] == want[1]
    assert len(traj.of_kind("mcmc_iter")) == 20


# -- the native library and data loader ---------------------------------------------

def test_native_dataloader_batch_order_matches_jax():
    from flexflow_tpu.native.dataloader import NativeDataLoader as JDL
    from flexflow_tpu_torch.native.dataloader import NativeDataLoader as TDL

    data = np.random.RandomState(0).randn(40, 3, 5).astype(np.float32)
    for shuffle in (True, False):
        jdl = JDL(data, batch_size=8, shuffle=shuffle, seed=7)
        tdl = TDL(data, batch_size=8, shuffle=shuffle, seed=7)
        assert tdl.num_batches == jdl.num_batches == 5
        for _ in range(2):   # two epochs: each reshuffles
            jb, tb = list(jdl), list(tdl)
            assert len(tb) == len(jb) == 5
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(a, b)
        seen = np.concatenate(tb).reshape(40, -1)
        assert sorted(map(tuple, seen)) == sorted(
            map(tuple, data.reshape(40, -1)))


def test_native_library_builds_under_build_and_loads_nothing_of_jax():
    """The port's library lives under build/native (a name per source
    hash, renamed into place), never under flexflow_tpu/native; a process
    that builds and runs it maps no file of the JAX package and imports
    no jax."""
    code = (
        "import sys, numpy as np\n"
        "from flexflow_tpu_torch import native\n"
        "from flexflow_tpu_torch.native.dataloader import NativeDataLoader\n"
        "assert native.available()\n"
        "b = list(NativeDataLoader(np.arange(16.0).reshape(16, 1), 4))\n"
        "maps = open('/proc/self/maps').read()\n"
        "bad = [l for l in maps.splitlines() if '/flexflow_tpu/' in l]\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'flexflow_tpu.')) or m == 'flexflow_tpu']\n"
        "print(native.lib_path())\n"
        "sys.exit(1 if bad or mods or len(b) != 4 else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
    path = pathlib.Path(r.stdout.strip().splitlines()[-1])
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("libffnative-") and path.exists()
    assert not list((REPO / "build" / "native").glob("*.tmp-*"))
    for src in ("simulator.cc", "dataloader.cc"):
        port = (REPO / "flexflow_tpu_torch" / "native" / "src" / src)
        jax = (REPO / "flexflow_tpu" / "native" / "src" / src)
        # the same code below the header comment
        body = [t.split("#include", 1)[1] for t in (port.read_text(),
                                                     jax.read_text())]
        assert body[0] == body[1], src
    for p in [REPO / "chip_smoke.py",
              *(REPO / "flexflow_tpu_torch").rglob("*.py")]:
        text = p.read_text()
        assert "import jax" not in text and "from flexflow_tpu " not in text \
            and "from flexflow_tpu." not in text \
            and "import flexflow_tpu." not in text, p


def test_racing_native_builds_leave_one_whole_library():
    """Six processes (the suite's xdist workers) forcing a build of the
    same library at once: each writes its own temporary file and renames
    it into place, so every one loads a whole library and no temporary
    is left behind."""
    code = ("import ctypes\n"
            "from flexflow_tpu_torch import native\n"
            "p = native.build(force=True)\n"
            "ctypes.CDLL(p).ffsim_create\n"
            "print(p)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip().splitlines()[-1] for o, _ in outs}
    assert paths == {str(tnative.lib_path())}
    assert not list((REPO / "build" / "native").glob("*.tmp-*"))
    assert tnative.available()


# -- the topology-aware machine model -------------------------------------------------

@pytest.mark.parametrize("dims", [(4, 8), (2, 4), (8,), (2, 2, 2)])
def test_torus_routing_matches_jax(dims):
    jt, tt = jnet.TorusTopology(dims=dims), tnet.TorusTopology(dims=dims)
    n = tt.num_chips
    assert n == jt.num_chips
    for a in range(n):
        assert tt.coords(a) == jt.coords(a)
        assert tt.chip(tt.coords(a)) == a
        assert tt.neighbors(a) == jt.neighbors(a)
        for b in range(n):
            assert tt.hop_distance(a, b) == jt.hop_distance(a, b)
            assert tt.shortest_path(a, b) == jt.shortest_path(a, b)


@pytest.mark.parametrize("nodes", [1, 2])
def test_topology_costs_match_jax(nodes):
    jm, tm = _machines("topology", 8, nodes)
    assert tm.hierarchical and tm.num_workers == 8 * nodes
    rng = np.random.RandomState(0)
    n = tm.num_workers
    groups = [list(range(n)), [0, 1], [0, 3, 5, 6], [0, 2, 4, 6],
              [1, 7], list(range(0, n, 3))]
    if nodes > 1:
        groups += [[0, 8], [3, 4, 11, 12], [7, 15]]
    for ids in groups:
        for nbytes in (0, 1e3, 3.7e7):
            for f in ("allreduce_cost", "replicate_cost", "all_to_all_cost",
                      "reshard_cost", "all_gather_cost",
                      "reduce_scatter_cost"):
                np.testing.assert_allclose(
                    getattr(tm, f)(nbytes, ids), getattr(jm, f)(nbytes, ids),
                    rtol=COST_RTOL, err_msg=f"{f} {ids}")
            for kind in ("allreduce", "all_gather", "replicate",
                         "all_to_all", "reshard"):
                np.testing.assert_allclose(
                    tm.latency_bound_collective_cost(kind, nbytes, ids),
                    jm.latency_bound_collective_cost(kind, nbytes, ids),
                    rtol=COST_RTOL)
        assert tm.ring_hop_factor(ids) == jm.ring_hop_factor(ids)
    for _ in range(20):
        src, dst = rng.randint(0, n, 2)
        nbytes = float(rng.randint(1, 10 ** 8))
        np.testing.assert_allclose(tm.xfer_cost(nbytes, src, dst),
                                   jm.xfer_cost(nbytes, src, dst),
                                   rtol=COST_RTOL)
    for k in range(1, 6):
        flows = [(float(rng.randint(1, 10 ** 7)), int(rng.randint(0, n)),
                  int(rng.randint(0, n))) for _ in range(k)]
        np.testing.assert_allclose(tm.concurrent_flows_cost(flows),
                                   jm.concurrent_flows_cost(flows),
                                   rtol=COST_RTOL)


def test_topology_model_shrinks_like_jax():
    jm, tm = _machines("topology", 8)
    for n in (8, 4, 6):
        j, t = jsearch.for_device_count(n, like=jm), \
            tsearch.for_device_count(n, like=tm)
        assert (t.num_nodes, t.workers_per_node, t.topology.dims) == \
            (j.num_nodes, j.workers_per_node, j.topology.dims)


@pytest.mark.parametrize("fname", ["machine_config_example",
                                   "machine_config_v5e32",
                                   "machine_config_multislice"])
def test_machine_config_files_parse_like_jax(fname):
    path = str(REPO / fname)
    jm, tm = jsearch.parse_machine_config(path), \
        tsearch.parse_machine_config(path)
    assert type(tm).__name__ == type(jm).__name__
    for f in ("num_nodes", "workers_per_node", "ici_bandwidth",
              "dcn_bandwidth", "ici_latency", "dcn_latency"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert dataclasses.asdict(tm.chip) == {**dataclasses.asdict(jm.chip),
                                           "mxu_lanes": 128,
                                           "mxu_sublanes": 8}
    if hasattr(jm, "topology"):
        assert tm.topology.dims == jm.topology.dims
        assert tm.congestion_factor == jm.congestion_factor


def _machine_file(tmp_path, workers):
    p = tmp_path / f"machine_{workers}.cfg"
    p.write_text(f"num_nodes = 1\nnum_gpus_per_node = {workers}\n"
                 "intra_node_bandwidth = 90e9\ninter_node_bandwidth = 25e9\n")
    return str(p)


def test_version_1_search_matches_jax(tmp_path):
    """compile() with --machine-model-version 1 wraps the file's machine
    in the topology-aware model, in both packages alike."""
    cfg = {"search_budget": 2, "machine_model_version": 1,
           "machine_model_file": _machine_file(tmp_path, 4)}
    out = []
    for pkg in (jff, tff):
        m = transformer_model(pkg, **cfg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the demotion's validation
            m.compile(pkg.SGDOptimizer(lr=0.01), getattr(pkg.LossType, MSE))
        out.append(m)
    jm, tm = out
    assert type(tm.search_cost_model.machine).__name__ == \
        "TopologyAwareMachineModel"
    np.testing.assert_allclose(tm.searched_cost, jm.searched_cost,
                               rtol=COST_RTOL)
    assert _op_types(tm.graph) == _op_types(jm.graph)
    assert _views_by_position(tm.graph, tm.searched_views) == \
        _views_by_position(jm.graph, jm.searched_views)


# -- the memory-aware search ---------------------------------------------------------

def _memory_search(pkg, mem, budget_bytes):
    g = (jlowering if pkg is jff else tlowering).layers_to_pcg(
        transformer_model(pkg).layers)[0]
    machine = pkg.search.MachineModel(num_nodes=1, workers_per_node=4)
    cm = pkg.search.CostModel(machine, calibration=False)
    mvm = jmv if pkg is jff else tmv
    res = mvm.MachineResource(1, 4, 4)
    xfers = pkg.search.generate_all_pcg_xfers([2, 4])
    opt = pkg.SGDOptimizer(lr=0.01)
    return g, mem.graph_optimize_with_memory(
        g, cm, res, xfers, device_mem_budget=budget_bytes, budget=2,
        train=True, optimizer=opt, grad_bytes_ratio=0.5)


def _least_bytes(lam=1.0):
    """The port's search with memory alone deciding (lambda 1 s a byte):
    the least per-device bytes a strategy of the search reaches."""
    g = tlowering.layers_to_pcg(transformer_model(tff).layers)[0]
    cm = tsearch.CostModel(tsearch.MachineModel(num_nodes=1,
                                                workers_per_node=4),
                           calibration=False)
    wmul = tmem.weight_bytes_multiplier(tff.SGDOptimizer(lr=0.01), 0.5)
    best, r = tsearch.GraphSearchHelper(
        tmem.MemorySearchHelper(cm, mem_lambda=lam, weight_mult=wmul),
        tsearch.generate_all_pcg_xfers([2, 4]), budget=2).graph_optimize(
            g, tmv.MachineResource(1, 4, 4))
    return tmem.measure_memory(best, r.views, cm, train=True,
                               optimizer=tff.SGDOptimizer(lr=0.01),
                               grad_bytes_ratio=0.5).max_bytes


def test_graph_optimize_with_memory_matches_jax():
    """Unconstrained (lambda 0), with a budget halfway between the fastest
    winner's bytes and the least the search reaches (lambda above 0, the
    winner under it), and under the least (infeasible: the fastest
    comes back at lambda 0): the same lambda, bytes, cost and views in
    both packages."""
    fast = _memory_search(tff, tmem, 1 << 50)[1][2].max_bytes
    least = _least_bytes()
    assert least < fast
    for budget, feasible in ((1 << 50, True), ((fast + least) // 2, True),
                             (least // 2, False)):
        (jg, (jb, jr, ju, jlam)), (tg, (tb, tr, tu, tlam)) = (
            _memory_search(jff, jmem, budget),
            _memory_search(tff, tmem, budget))
        assert (tu.max_bytes, tlam) == (ju.max_bytes, jlam), budget
        assert tu.per_device_bytes == ju.per_device_bytes
        np.testing.assert_allclose(tr.cost, jr.cost, rtol=COST_RTOL)
        assert _op_types(tb) == _op_types(jb)
        assert _views_by_position(tb, tr.views) == \
            _views_by_position(jb, jr.views)
        if not feasible:
            assert tlam == 0.0 and tu.max_bytes == fast
        elif budget < fast:
            assert tlam > 0.0 and tu.max_bytes <= budget
        else:
            assert tlam == 0.0 and tu.max_bytes == fast


def test_memory_search_flag_compiles_a_winner_that_fits():
    """--memory-search through compile: the winner's training memory at
    or under device_mem, lambda above 0, and it trains."""
    free = transformer_model(tff, search_budget=2, search_num_workers=4)
    free.compile(tff.SGDOptimizer(lr=0.01), getattr(tff.LossType, MSE))
    fast = free.search_trajectory.of_kind("memory_check")[0]["bytes"]
    m = transformer_model(tff, search_budget=2, search_num_workers=4,
                          perform_memory_search=True,
                          device_mem=int(fast * 0.75))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the demotion's validation
        m.compile(tff.SGDOptimizer(lr=0.01), getattr(tff.LossType, MSE))
    got = m.memory_search
    if got["lambda"] == 0.0:
        pytest.fail(f"no strategy under {fast * 0.75} bytes: {got}")
    assert got["bytes"] <= fast * 0.75
    assert m.search_trajectory.of_kind("memory_lambda")
    x = np.random.RandomState(0).randn(16, 32, 64).astype(np.float32)
    m.fit(x, x, epochs=1, verbose=False)
    assert m.state.step == 2


@pytest.mark.parametrize("argv", [["--memory-search"],
                                  ["--machine-model-version", "1"],
                                  ["--simulator-workspace-size", "1024"]],
                         ids=" ".join)
def test_toolchain_flags_parse_to_jax_fields(argv):
    t, j = tff.FFConfig(device="cpu"), jff.FFConfig()
    fields = ("perform_memory_search", "machine_model_version",
              "simulator_work_space_size")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    t.parse_args(argv)
    j.parse_args(argv)
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    assert any(getattr(t, f) != getattr(tff.FFConfig(device="cpu"), f)
               for f in fields)
