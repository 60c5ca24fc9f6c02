"""flexflow_tpu_torch's mesh executor across processes against the JAX
package on a mesh of the same size.

The port runs one process per device: each test's ranks are
subprocesses (flexflow_tpu_torch/runtime/mesh_run.py running
tests/torch_mesh_cases.py, gloo on the CPU,
OMP_NUM_THREADS=1, a free localhost port), killed with every peer when
the launch passes its 150 s timeout. Rank 0 writes its results under the
test's tmp_path (a failed rank's output is its `rank<r>.log` there). The
JAX side runs in this process on the conftest's CPU devices with
`workersPerNode = N`; the weights are JAX's, carried across with
`params_from_numpy`; the batches come from a numpy seed.

Cases: the small Transformer of tests/test_sharding.py (batch 8, seq 16,
hidden 64, 4 heads, 2 blocks) for 3 SGD steps under dp 4, tp 4 (batch 2,
with the model-sharded local weight shapes) and dp 2 x tp 2; a BatchNorm
CNN under dp 4 (the running statistics after 2 steps are the global
batch's, from partial sums); the Unity winner of a 4-worker machine executed at its
degrees, and two ranks forced to different winners; the JAX package's
multi-process data-parallel `fit` cases (2 and 3 ranks, a diverging
global batch). Tolerance: f32 with rtol 1e-5 and atol 1e-6 (the
collectives and XLA sum in other orders).

All launches of the module start together in a module fixture, and the
JAX references are computed while the ranks run.
"""
import concurrent.futures
import json
import pathlib

import jax
import numpy as np
import pytest

import flexflow_tpu as jff
from flexflow_tpu.models.transformer import build_transformer as jtransformer
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu_torch.runtime.mesh_run import launch

RTOL, ATOL = 1e-5, 1e-6
TF = {"batch": 8, "seq": 16, "hidden": 64, "heads": 4, "layers": 2}
TIMEOUT = 150
CASES = str(pathlib.Path(__file__).with_name("torch_mesh_cases.py"))


def _jax_model(n, batch, build, **cfg_kw):
    cfg = jff.FFConfig()
    cfg.batch_size = batch
    cfg.workersPerNode = n
    cfg.numNodes = 1
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    m = jff.FFModel(cfg)
    build(m)
    return m


def _jax_transformer(n, kw, loss="LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE",
                     **cfg_kw):
    m = _jax_model(n, kw["batch"], lambda m: jtransformer(
        m, kw["batch"], kw["seq"], kw["hidden"], kw["heads"], kw["layers"]),
        **cfg_kw)
    m.compile(jff.SGDOptimizer(lr=0.01), getattr(jff.LossType, loss),
              [jff.MetricsType.METRICS_MEAN_SQUARED_ERROR])
    return m


def _jax_search_mlp(d, workers=4):
    """tests/test_torch_port_search.py's MLP searched for a machine of
    `workers` (its machine file): a tensor-parallel winner at 4."""
    def build(m):
        x = m.create_tensor((64, 512), jff.DataType.DT_FLOAT)
        t = m.dense(x, 1024, jff.ActiMode.AC_MODE_RELU)
        m.dense(t, 256)

    m = _jax_model(workers, 64, build, search_budget=4,
                   machine_model_file=_machine_file(d, workers))
    m.compile(jff.SGDOptimizer(lr=0.01),
              jff.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    return m


def _jax_bn_cnn(n, batch):
    def build(m):
        x = m.create_tensor((batch, 3, 8, 8), jff.DataType.DT_FLOAT)
        t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1)
        t = m.batch_norm(t)
        t = m.pool2d(t, 2, 2, 2, 2, 0, 0)
        t = m.conv2d(t, 8, 3, 3, 1, 1, 1, 1)
        t = m.batch_norm(t)
        t = m.flat(t)
        t = m.dense(t, 10)
        m.softmax(t)

    m = _jax_model(n, batch, build)
    m.compile(jff.SGDOptimizer(lr=0.01),
              jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [jff.MetricsType.METRICS_ACCURACY])
    return m


def _save_params(m, path):
    np.savez(path, **{f"{op}/{n}": np.asarray(a, np.float32)
                      for op, ws in m.state.params.items()
                      for n, a in ws.items()})
    return str(path)


def _jax_steps(m, xs, y, steps):
    """`steps` train steps of the JAX model on consecutive batches; the
    losses."""
    ex = m.executor
    bs = m.config.batch_size
    step = ex.build_train_step()
    losses = []
    for i in range(steps):
        xb = [ex.shard_batch(pt, a[i * bs:(i + 1) * bs])
              for pt, a in zip(ex.input_pts, xs)]
        yb = ex.put_replicated(y[i * bs:(i + 1) * bs])
        m.state, partials = step(m.state, xb, yb, jax.random.PRNGKey(i))
        losses.append(float(partials["loss"]))
    return losses


def _machine_file(d, workers):
    p = pathlib.Path(d) / f"machine_{workers}.cfg"
    p.write_text(f"num_nodes = 1\nnum_gpus_per_node = {workers}\n"
                 "intra_node_bandwidth = 90e9\ninter_node_bandwidth = 25e9\n")
    return str(p)


def _views_by_position(graph, views):
    pos = {op.guid: i for i, op in enumerate(graph.topo_order())}
    return sorted([pos.get(g, -1), v.start_device_id, list(v.dim),
                   list(v.stride)] for g, v in views.items())


class Run:
    """One launch of the rank program: its exit codes (or the error that
    ended it) and each case's per-rank results."""

    def __init__(self, d, nprocs):
        self.dir = pathlib.Path(d)
        self.nprocs = nprocs

    def result(self, name, rank=0):
        f = self.dir / f"{name}.rank{rank}.json"
        assert f.exists(), (f"no result for {name} on rank {rank}; rank "
                            "logs:\n" + self.logs())
        return json.loads(f.read_text())

    def ok(self, name):
        out = [self.result(name, r) for r in range(self.nprocs)]
        for r, o in enumerate(out):
            assert "error" not in o, f"rank {r}: {o.get('traceback')}"
        return out[0]

    def arrays(self, name):
        with np.load(self.dir / f"{name}.npz") as z:
            return {k: z[k] for k in z.files}

    def logs(self):
        return "\n".join(
            f"--- rank {r}:\n" + (self.dir / f"rank{r}.log").read_text()
            for r in range(self.nprocs)
            if (self.dir / f"rank{r}.log").exists())


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """Start every launch of the module at once; the JAX references are
    computed in the tests while the ranks run."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcm, "load_default_calibration", lambda: None)
    request.addfinalizer(mp.undo)
    d = tmp_path_factory.mktemp("mesh_ranks")
    rng = np.random.RandomState(0)
    data = {
        "tf": dict(x0=rng.randn(24, 16, 64).astype(np.float32),
                   y=rng.randn(24, 16, 64).astype(np.float32)),
        "cnn": dict(x0=rng.randn(32, 3, 8, 8).astype(np.float32),
                    y=rng.randint(0, 10, (32, 1)).astype(np.int32)),
        "search": dict(x0=rng.randn(128, 512).astype(np.float32),
                       y=rng.randn(128, 256).astype(np.float32)),
        "mlp": dict(x0=rng.rand(256, 784).astype(np.float32),
                    y=rng.randint(0, 10, (256, 1)).astype(np.int32)),
    }
    other = np.random.RandomState(1)
    data["mlp_diverged"] = dict(
        x0=other.rand(256, 784).astype(np.float32),
        y=other.randint(0, 10, (256, 1)).astype(np.int32))
    paths = {}
    for k, arrays in data.items():
        paths[k] = str(d / f"data_{k}.npz")
        np.savez(paths[k], **arrays)
    jm = {"tf": _jax_transformer(4, TF),
          "cnn": _jax_bn_cnn(4, 8),
          "search": _jax_search_mlp(d)}
    w = {k: _save_params(m, d / f"w_{k}.npz") for k, m in jm.items()}
    mse = "mse"
    four = [
        {"name": "dp4", "builder": "transformer", "builder_kwargs": TF,
         "config": {"batch_size": 8}, "weights": w["tf"],
         "data": paths["tf"], "steps": 3, "loss": mse},
        {"name": "tp4", "builder": "transformer",
         "builder_kwargs": dict(TF, batch=2),
         "config": {"batch_size": 2, "tensor_parallel_degree": 4},
         "weights": w["tf"], "data": paths["tf"], "steps": 3, "loss": mse},
        {"name": "dp2tp2", "builder": "transformer", "builder_kwargs": TF,
         "config": {"batch_size": 8, "tensor_parallel_degree": 2},
         "weights": w["tf"], "data": paths["tf"], "steps": 3, "loss": mse},
        {"name": "bn_cnn", "builder": "bn_cnn",
         "builder_kwargs": {"batch": 8}, "config": {"batch_size": 8},
         "weights": w["cnn"], "data": paths["cnn"], "steps": 2,
         "loss": "sparse_categorical_crossentropy",
         "metrics": ["accuracy"], "forward": True},
        {"name": "search", "builder": "search_mlp",
         "builder_kwargs": {"batch": 64},
         "config": {"batch_size": 64, "search_budget": 4,
                    "machine_model_file": _machine_file(d, 4)},
         "weights": w["search"], "data": paths["search"], "steps": 2,
         "loss": mse},
    ]
    mlp = {"builder": "mlp", "mode": "fit", "epochs": 2, "lr": 0.05,
           "loss": "sparse_categorical_crossentropy",
           "metrics": ["accuracy", "sparse_categorical_crossentropy"]}
    groups = {
        "four": (4, four),
        "fit2": (2, [dict(mlp, name="fit2", builder_kwargs={"batch": 32},
                          config={"batch_size": 32}, data=paths["mlp"])]),
        "fit3": (3, [dict(mlp, name="fit3", builder_kwargs={"batch": 30},
                          config={"batch_size": 30}, data=paths["mlp"])]),
        "diverge": (2, [dict(mlp, name="diverge",
                             builder_kwargs={"batch": 32},
                             config={"batch_size": 32}, data=paths["mlp"],
                             rank_data=paths["mlp_diverged"])]),
        # rank 1 searches a one-worker machine: a serial winner against
        # rank 0's data-parallel one
        "mismatch": (2, [{
            "name": "mismatch", "builder": "search_mlp",
            "builder_kwargs": {"batch": 64}, "loss": mse, "mode": "compile",
            "config": {"batch_size": 64, "search_budget": 4,
                       "machine_model_file": _machine_file(d, 4)},
            "config_by_rank": {"1": {"machine_model_file":
                                     _machine_file(d, 1)}}}]),
    }
    pool = concurrent.futures.ThreadPoolExecutor(len(groups))
    futures = {}
    out = {}
    for name, (n, cases) in groups.items():
        gd = d / name
        gd.mkdir()
        spec = gd / "spec.json"
        spec.write_text(json.dumps(cases))
        out[name] = Run(gd, n)
        futures[name] = pool.submit(launch, n, ["--device", "cpu", CASES,
                                                str(spec), str(gd)],
                                    str(gd), timeout=TIMEOUT)
    yield {"runs": out, "futures": futures, "jax": jm, "data": data,
           "paths": paths}
    pool.shutdown(wait=True)


def _wait(runs, group):
    """The group's Run once its ranks have exited (the launch's own
    timeout kills them all and raises)."""
    rcs = runs["futures"][group].result(timeout=TIMEOUT + 30)
    run = runs["runs"][group]
    return run, rcs


def _compare_weights(run, name, jm):
    got = run.arrays(name)
    want = {f"w/{op}/{n}": np.asarray(a, np.float32)
            for op, ws in jm.state.params.items() for n, a in ws.items()}
    assert set(k for k in got if k.startswith("w/")) == set(want)
    for k, a in want.items():
        np.testing.assert_allclose(got[k], a, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("name,tp,batch", [("dp4", 1, 8), ("tp4", 4, 2),
                                            ("dp2tp2", 2, 8)])
def test_transformer_matches_jax_on_the_same_mesh(runs, name, tp, batch):
    """3 SGD steps of the small Transformer: every loss and every weight
    against the JAX package on a 4-device mesh of the same degrees (JAX
    draws the same weights on any mesh: the ranks start from them)."""
    jm = (runs["jax"]["tf"] if name == "dp4"
          else _jax_transformer(4, dict(TF, batch=batch),
                                tensor_parallel_degree=tp))
    want = _jax_steps(jm, [runs["data"]["tf"]["x0"]], runs["data"]["tf"]["y"],
                      3)
    run, rcs = _wait(runs, "four")
    out = run.ok(name)
    assert out["executor"] == "MeshExecutor"
    assert out["mesh"]["data"] == 4 // tp and out["mesh"]["model"] == tp
    np.testing.assert_allclose(out["losses"], want, rtol=RTOL, atol=ATOL)
    _compare_weights(run, name, jm)
    n_weights = len(out["local_shapes"])
    # a gradient redistribute runs where a gradient comes out placed
    # otherwise than its weight: with a data axis every gradient is
    # Partial over "data" (the all-reduce, each step); under tp 4 alone a
    # weight sharded over "model" as its activations are takes its
    # gradient sharded so, with no collective
    if tp < 4:
        assert out["grad_syncs"] == 3 * n_weights
    else:
        assert out["grad_syncs"] % 3 == 0
        assert 0 < out["grad_syncs"] < 3 * n_weights
    # no op of the Transformer needs a sharded operand gathered whole
    assert out["gathered"] == {}
    if tp > 1:
        # the model-sharded weights of test_tp_weight_shardings_applied,
        # held as their local shards
        from flexflow_tpu.parallel.mesh import pspec_for_parallel_tensor

        mesh = jm.executor.mesh
        sharded = 0
        for op in jm.graph.ops:
            for n, wpt in zip(op.weight_names, op.weights):
                spec = tuple(pspec_for_parallel_tensor(wpt, mesh))
                shape = list(wpt.material_shape())
                for i, s in enumerate(spec):
                    if s == "model":
                        shape[i] //= tp
                        sharded += 1
                assert out["local_shapes"][f"{op.name}/{n}"] == shape, \
                    (op.name, n)
        assert sharded > 0
    assert rcs == [0] * 4


def test_bn_cnn_running_statistics_are_the_global_batchs(runs):
    """A BatchNorm CNN under dp 4: after 2 steps the running mean and
    variance are the global batch's, as the JAX package's are (local
    statistics would differ), taken from partial sums without gathering
    the activation, and so are the weights and the serving forward on the
    running statistics."""
    jm = runs["jax"]["cnn"]
    want = _jax_steps(jm, [runs["data"]["cnn"]["x0"]],
                      runs["data"]["cnn"]["y"], 2)
    run, _ = _wait(runs, "four")
    out = run.ok("bn_cnn")
    # the batch statistics come from partial sums all-reduced over
    # "data" (parallel/mesh.py var_mean): no activation is gathered whole
    # (the convolutions and the pooling run on the batch shards)
    assert out["gathered"] == {}
    np.testing.assert_allclose(out["losses"], want, rtol=RTOL, atol=ATOL)
    got = run.arrays("bn_cnn")
    n_bufs = 0
    for op, bufs in jm.state.net_state.items():
        for n, b in bufs.items():
            np.testing.assert_allclose(got[f"s/{op}/{n}"], np.asarray(b),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{op}.{n}")
            n_bufs += 1
    assert n_bufs == 4
    _compare_weights(run, "bn_cnn", jm)
    ex = jm.executor
    x = runs["data"]["cnn"]["x0"][:8]
    want = ex.build_forward()(jm.state.params,
                              [ex.shard_batch(ex.input_pts[0], x)],
                              jm.state.net_state)
    np.testing.assert_allclose(got["f/out"], np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_searched_winner_runs_at_its_degrees(runs):
    """The Unity winner of a 4-worker machine for the search parity
    tests' MLP (their machine file, the JAX side's shipped calibration
    off): both packages pick the same views, a tensor-parallel strategy
    with Combine ops, and both train 2 steps on their 4-device meshes at
    the winner's degrees."""
    jm = runs["jax"]["search"]
    want = _jax_steps(jm, [runs["data"]["search"]["x0"]],
                      runs["data"]["search"]["y"], 2)
    run, _ = _wait(runs, "four")
    out = run.ok("search")
    assert out["searched_views"] == _views_by_position(jm.graph,
                                                       jm.searched_views)
    assert {k: v for k, v in out["mesh"].items() if v > 1} == {
        k: int(v) for k, v in jm.executor.mesh.shape.items() if v > 1}
    assert out["mesh"]["model"] == 4
    np.testing.assert_allclose(out["losses"], want, rtol=RTOL, atol=ATOL)
    _compare_weights(run, "search", jm)


def test_ranks_with_different_winners_raise(runs):
    run, rcs = _wait(runs, "mismatch")
    for r in range(2):
        err = run.result("mismatch", r).get("error", "")
        assert "different strategies" in err, run.logs()
    assert rcs == [0, 0]


@pytest.mark.parametrize("group,n,batch", [("fit2", 2, 32), ("fit3", 3, 30)])
def test_multi_process_data_parallel_fit(runs, group, n, batch):
    """The JAX package's test_multinode cases in the port: 2 and 3
    processes fit the MLP for 2 epochs (3 ranks: batch 30, the tail 16
    samples dropped), and end where one device ends."""
    import flexflow_tpu_torch as tff
    from flexflow_tpu_torch.runtime.weights import params_to_numpy
    from torch_mesh_cases import build as _build

    m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=batch))
    _build(m, "mlp", {"batch": batch})
    m.compile(tff.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
              ["accuracy", "sparse_categorical_crossentropy"])
    d = runs["data"]["mlp"]
    m.fit(d["x0"], d["y"], batch_size=batch, epochs=2, verbose=False)
    run, rcs = _wait(runs, group)
    out = run.ok(group)
    assert out["mesh"]["data"] == n
    assert out["train_all"] == (256 // batch) * batch
    got = run.arrays(group)
    for op, ws in params_to_numpy(m).items():
        for w, a in ws.items():
            np.testing.assert_allclose(got[f"w/{op}/{w}"], a, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{op}.{w}")
    assert rcs == [0] * n


def test_diverging_global_batch_fails_loudly(runs):
    """A rank feeding other data raises the contract error on every rank
    within the timeout, instead of training on inconsistent shards."""
    run, _ = _wait(runs, "diverge")
    for r in range(2):
        err = run.result("diverge", r).get("error", "")
        assert "SAME global batch" in err, run.logs()
