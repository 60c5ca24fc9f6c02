"""flexflow_tpu_torch's FSDP/ZeRO weight sharding and overlapped gradient
sync on the mesh executor, against the JAX package on the conftest's CPU
devices, and the two repaired costs on the data axis: BatchNorm's and
LayerNorm's statistics from partial sums, and chunked attention with the
query positions sharded over an axis the batch or the heads do not
divide.

The ranks run as in tests/test_torch_port_mesh.py: one module-scoped
launch of 4 gloo ranks (flexflow_tpu_torch/runtime/mesh_run.py running
tests/torch_mesh_cases.py, OMP_NUM_THREADS=1, a free localhost port,
every rank killed when the launch passes its 150 s timeout; a failed
rank's output is its `rank<r>.log` under the module's tmp dir). The JAX
side runs in this process on 4 of the conftest's CPU devices
(`workersPerNode = 4`) while the ranks run; its initial weights are
carried to the ranks with `params_from_numpy`.

Each test mirrors a JAX test:
  - tests/test_weight_sharding.py: FSDP (fsdp 4, and data 2 x fsdp 2)
    trains to the replicated weights (the port on one device) and to
    JAX's FSDP run at rtol 2e-4, atol 1e-5, with each weight gathered on
    use and its gradient reduce-scattered; Adam's slots sharded 1/fsdp;
    an fsdp degree that does not divide the data degree clamped with a
    warning;
  - tests/test_perf_overlap.py: the overlapped step against the
    all-reduce step (SGD with momentum and Adam, with and without the
    step guard, at dp 4 and dp 2 x tp 2) at rtol 3e-6, atol 1e-7 in the
    port, and against JAX's overlapped step at rtol 1e-5, atol 1e-6;
    ZeRO-1 slots; the reduce-scatters issued from the backward's hooks;
    a WeightShard target excluded from the overlappable syncs;
  - tests/test_perf_analysis.py: the executor's overlap schedule is race
    free and gone with the overlapped sync off;
  - the flagship Transformer's searched winner for a 4-worker machine
    (batch 8, seq 64, hidden 128, 8 heads, 2 blocks, search budget 4),
    whose WeightShard nodes need an fsdp axis of 2, at its degrees (the
    two surplus ranks run it as replicas), against JAX's run of the same
    winner and the port on one device, rtol 1e-5, atol 1e-6;
  - `var_mean` over a sharded dim against numpy with no all-gather, and
    chunked attention holding 1/(data x model) of the query rows per
    rank against one device's dense path, rtol 1e-5, atol 1e-6.
"""
import concurrent.futures
import json
import pathlib
import warnings

import jax
import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu.models.transformer import build_transformer as jtransformer
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu_torch.runtime.mesh_run import launch
from flexflow_tpu_torch.runtime.weights import params_from_numpy, \
    params_to_numpy
from torch_mesh_cases import build as _build

TIMEOUT = 150
CASES = str(pathlib.Path(__file__).with_name("torch_mesh_cases.py"))
# the FSDP tolerance of tests/test_weight_sharding.py
FSDP_RTOL, FSDP_ATOL = 2e-4, 1e-5
# the overlapped step against the all-reduce step (tests/test_perf_
# overlap.py), and against the JAX package
OV_RTOL, OV_ATOL = 3e-6, 1e-7
JAX_RTOL, JAX_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-5, 1e-6
WINNER = {"batch": 8, "seq": 64, "hidden": 128, "heads": 8, "layers": 2}
OPTS = {"sgd": {"lr": 0.05, "momentum": 0.9}, "adam": {"adam": True,
                                                      "alpha": 1e-3}}
MESHES = {"dp4": {}, "dp2tp2": {"tensor_parallel_degree": 2}}
# chunked attention whose heads do not divide the model axis: (builder
# kwargs, config, this rank's q (b, s, h, d))
ROWS = {
    "tp4": ({"batch": 2, "seq": 16, "embed": 36, "heads": 6},
            {"batch_size": 2, "tensor_parallel_degree": 4}, [2, 4, 6, 6]),
    "dp2tp2": ({"batch": 4, "seq": 16, "embed": 36, "heads": 3},
               {"batch_size": 4, "tensor_parallel_degree": 2},
               [2, 8, 3, 12]),
    # neither the batch nor the heads divide: the positions shard over
    # both axes, data major, under a causal mask
    "both_causal": ({"batch": 3, "seq": 16, "embed": 36, "heads": 3,
                     "causal": True},
                    {"batch_size": 3, "tensor_parallel_degree": 2},
                    [3, 4, 3, 12]),
}
VAR_MEAN = {
    # BatchNorm's statistics: the batch sharded over "data"
    "batchnorm": {"mesh": {"data": 4}, "shape": [8, 3, 4, 4],
                  "shard": {"data": 0}, "dims": [0, 2, 3]},
    # LayerNorm's: the hidden dim sharded over "model", the batch over
    # "data"
    "layernorm": {"mesh": {"data": 2, "model": 2}, "shape": [4, 6, 8],
                  "shard": {"data": 0, "model": 2}, "dims": [2],
                  "keepdim": True},
}


def _jax_cfg(**kw):
    cfg = jff.FFConfig()
    cfg.workersPerNode, cfg.numNodes = 4, 1
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _jax_mlp(fsdp, optimizer=None):
    """tests/test_weight_sharding.py _mlp on 4 devices."""
    m = jff.FFModel(_jax_cfg(batch_size=8, fsdp_degree=fsdp))
    x = m.create_tensor((8, 16), jff.DataType.DT_FLOAT)
    t = m.dense(x, 64, jff.ActiMode.AC_MODE_RELU)
    t = m.dense(t, 4)
    m.softmax(t)
    m.compile(optimizer or jff.SGDOptimizer(lr=0.1, momentum=0.9),
              jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [])
    return m


def _jax_small(opt, tp):
    """tests/test_perf_overlap.py _small_model (overlapped) on 4
    devices."""
    m = jff.FFModel(_jax_cfg(batch_size=8, tensor_parallel_degree=tp))
    x = m.create_tensor((8, 16), jff.DataType.DT_FLOAT, name="x")
    t = m.dense(x, 32, jff.ActiMode.AC_MODE_RELU)
    m.dense(t, 16, jff.ActiMode.AC_MODE_NONE)
    o = (jff.AdamOptimizer(alpha=1e-3) if opt == "adam"
         else jff.SGDOptimizer(lr=0.05, momentum=0.9))
    m.compile(o, jff.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              [jff.MetricsType.METRICS_MEAN_SQUARED_ERROR])
    return m


def _jax_winner(machine):
    m = jff.FFModel(_jax_cfg(batch_size=8, search_budget=4,
                             machine_model_file=machine))
    jtransformer(m, 8, WINNER["seq"], WINNER["hidden"], WINNER["heads"],
                 WINNER["layers"])
    m.compile(jff.SGDOptimizer(lr=0.01),
              jff.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    return m


def _save_params(m, path):
    np.savez(path, **{f"{op}/{n}": np.asarray(a, np.float32)
                      for op, ws in m.state.params.items()
                      for n, a in ws.items()})
    return str(path)


def _tree(path):
    with np.load(path) as z:
        tree = {}
        for key in z.files:
            op, n = key.split("/", 1)
            tree.setdefault(op, {})[n] = z[key]
    return tree


def _mlp_data():
    """tests/test_weight_sharding.py _data."""
    rng = np.random.RandomState(0)
    return dict(x0=rng.randn(32, 16).astype(np.float32),
                y=rng.randint(0, 4, (32, 1)).astype(np.int32))


def _ov_data():
    """tests/test_perf_overlap.py _run_steps' batch."""
    return dict(x0=np.random.RandomState(0).randn(8, 16).astype(np.float32),
                y=np.random.RandomState(1).randn(8, 16).astype(np.float32))


class _Run:
    def __init__(self, d, nprocs, future):
        self.dir, self.nprocs, self.future = pathlib.Path(d), nprocs, future

    def result(self, name, rank=0):
        self.future.result(timeout=TIMEOUT + 30)
        f = self.dir / f"{name}.rank{rank}.json"
        assert f.exists(), "rank logs:\n" + "\n".join(
            (self.dir / f"rank{r}.log").read_text()
            for r in range(self.nprocs))
        return json.loads(f.read_text())

    def ok(self, name):
        outs = [self.result(name, r) for r in range(self.nprocs)]
        for r, o in enumerate(outs):
            assert "error" not in o, f"rank {r}: {o.get('traceback')}"
        return outs[0]

    def arrays(self, name):
        with np.load(self.dir / f"{name}.npz") as z:
            return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """Start the 4 ranks, then build the JAX references while they run."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcm, "load_default_calibration", lambda: None)
    request.addfinalizer(mp.undo)
    d = tmp_path_factory.mktemp("fsdp_ranks")
    rng = np.random.RandomState(0)
    data = {"mlp": _mlp_data(), "ov": _ov_data(),
            "tf": dict(x0=rng.randn(16, 64, 128).astype(np.float32),
                       y=rng.randn(16, 64, 128).astype(np.float32))}
    for name, (kw, _, _) in ROWS.items():
        shape = (2 * kw["batch"], kw["seq"], kw["embed"])
        data[f"rows_{name}"] = dict(x0=rng.randn(*shape).astype(np.float32),
                                    y=rng.randn(*shape).astype(np.float32))
    paths = {}
    for k, arrays in data.items():
        paths[k] = str(d / f"data_{k}.npz")
        np.savez(paths[k], **arrays)
    machine = d / "machine_4.cfg"
    machine.write_text("num_nodes = 1\nnum_gpus_per_node = 4\n"
                       "intra_node_bandwidth = 90e9\n"
                       "inter_node_bandwidth = 25e9\n")
    # the JAX models whose initial weights the ranks start from
    jax_models = {"fsdp4": _jax_mlp(4), "dp2_fsdp2": _jax_mlp(2),
                  "winner": _jax_winner(str(machine))}
    for mesh, tp in (("dp4", 1), ("dp2tp2", 2)):
        for opt in OPTS:
            jax_models[f"{mesh}_{opt}"] = _jax_small(opt, tp)
    w = {k: _save_params(m, d / f"w_{k}.npz")
         for k, m in jax_models.items()}
    sparse = "sparse_categorical_crossentropy"
    cases = [
        {"name": name, "builder": "mlp",
         "builder_kwargs": {"batch": 8, "width": 16, "hidden": 64,
                            "classes": 4},
         "config": {"batch_size": 8, "fsdp_degree": fsdp},
         "optimizer": {"lr": 0.1, "momentum": 0.9}, "loss": sparse,
         "weights": w[name], "data": paths["mlp"], "mode": "fit",
         "epochs": 2}
        for name, fsdp in (("fsdp4", 4), ("dp2_fsdp2", 2))]
    cases.append({"name": "fsdp4_adam", "builder": "mlp",
                  "builder_kwargs": {"batch": 8, "width": 16, "hidden": 64,
                                     "classes": 4},
                  "config": {"batch_size": 8, "fsdp_degree": 4},
                  "optimizer": {"adam": True, "alpha": 0.01},
                  "loss": sparse, "data": paths["mlp"], "steps": 1})
    for mesh, cfg in MESHES.items():
        for opt, okw in OPTS.items():
            for guard in (False, True):
                for kind, overlap in (("ov", True), ("ar", False)):
                    c = {"name": f"{kind}_{mesh}_{opt}_{int(guard)}",
                         "builder": "overlap_mlp",
                         "builder_kwargs": {"batch": 8},
                         "config": dict(cfg, batch_size=8,
                                        overlap_backward_update=overlap),
                         "optimizer": okw, "loss": "mse",
                         "metrics": ["mean_squared_error"],
                         "weights": w[f"{mesh}_{opt}"], "data": paths["ov"],
                         "steps": 3, "same_batch": True, "opt_state": True}
                    if guard:
                        c.update(mode="guard", guard={
                            "init_loss_scale": 2.0 ** 15, "poison_step": -1})
                    if (kind, mesh, opt, guard) == ("ov", "dp4", "sgd",
                                                    False):
                        c["schedule"] = True
                    cases.append(c)
    cases.append({"name": "winner", "builder": "transformer",
                  "builder_kwargs": WINNER,
                  "config": {"batch_size": 8, "search_budget": 4,
                             "machine_model_file": str(machine)},
                  "env": {"FF_ATTENTION_IMPL": "flash"},
                  "weights": w["winner"], "data": paths["tf"], "steps": 2,
                  "loss": "mse"})
    for name, (kw, cfg, _) in ROWS.items():
        cases.append({"name": f"rows_{name}", "builder": "attention",
                      "builder_kwargs": kw, "config": cfg,
                      "env": {"FF_ATTENTION_IMPL": "chunked"},
                      "data": paths[f"rows_{name}"], "steps": 2,
                      "lr": 0.1})
    for name, vm in VAR_MEAN.items():
        cases.append(dict(vm, name=f"var_mean_{name}", mode="var_mean"))
    (d / "spec.json").write_text(json.dumps(cases))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    run = _Run(d, 4, pool.submit(
        launch, 4, ["--device", "cpu", CASES, str(d / "spec.json"), str(d)],
        str(d), timeout=TIMEOUT))
    yield {"run": run, "data": data, "jax": jax_models, "weights": w,
           "machine": str(machine)}
    pool.shutdown(wait=True)


def _jax_fit(m, data):
    m.fit(data["x0"], data["y"], epochs=2, verbose=False)
    return {op: {n: np.asarray(a) for n, a in ws.items()}
            for op, ws in m.state.params.items()}


def _jax_steps(m, data, steps, guard=False, batch=8):
    """tests/test_perf_overlap.py _run_steps (guard: StepGuardConfig
    with the ranks' initial scale); returns (state, last partials)."""
    import dataclasses

    from flexflow_tpu.runtime.resilience import StepGuardConfig

    ex = m.executor
    st = m.state
    if guard:
        ex.set_step_guard(StepGuardConfig(init_loss_scale=2.0 ** 15))
        st = dataclasses.replace(st, guard=ex.init_guard_state())
    step = ex.build_train_step(donate=False)
    xb = ex.shard_batch(ex.input_pts[0], data["x0"][:batch])
    yb = ex.put_replicated(data["y"][:batch])
    key = ex.put_replicated(jax.random.PRNGKey(7))
    partials = None
    for _ in range(steps):
        st, partials = step(st, [xb], yb, key)
    return st, partials


def _one_device(builder, kw, weights, data, steps, loss, optimizer,
                fit=False, **cfg):
    """The port on one device from `weights` (a path or a tree): the
    losses of `steps` train steps on consecutive batches (or 2 epochs of
    `fit`) and the weights after."""
    m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=kw["batch"],
                                 **cfg))
    _build(m, builder, kw)
    opt = dict(optimizer)
    opt = (tff.AdamOptimizer(**{k: v for k, v in opt.items()
                                if k != "adam"})
           if opt.pop("adam", False) else tff.SGDOptimizer(**opt))
    m.compile(opt, loss, [])
    if weights is not None:
        params_from_numpy(m, _tree(weights) if isinstance(weights, str)
                          else weights)
    losses = []
    if fit:
        m.fit(data["x0"], data["y"], batch_size=kw["batch"], epochs=2,
              verbose=False)
    else:
        step = m.executor.build_train_step()
        bs = kw["batch"]
        for i in range(steps):
            m.state, partials = step(
                m.state, [data["x0"][i * bs:(i + 1) * bs]],
                data["y"][i * bs:(i + 1) * bs], i)
            losses.append(float(partials["loss"]))
    return losses, params_to_numpy(m)


def _assert_weights(got, want, rtol, atol, prefix="w/"):
    n = 0
    for op, ws in want.items():
        for name, a in ws.items():
            np.testing.assert_allclose(got[f"{prefix}{op}/{name}"],
                                       np.asarray(a, np.float32), rtol=rtol,
                                       atol=atol, err_msg=f"{op}.{name}")
            n += 1
    assert n > 0


@pytest.mark.parametrize("name,fsdp", [("fsdp4", 4), ("dp2_fsdp2", 2)])
def test_fsdp_lowering_matches_replicated_training(runs, name, fsdp):
    """tests/test_weight_sharding.py's acceptance core in the port: the
    MLP with its weights sharded over "fsdp" (fsdp 4, and fsdp 2 carved
    out of 4 data workers) fits 2 epochs to the replicated weights (the
    port on one device) and to JAX's FSDP run. Every weight lives
    sharded over "fsdp", is gathered where its op reads it and has its
    gradient reduce-scattered onto its shard: no gradient is all-reduced
    over "fsdp" (at data 2 x fsdp 2 each shard's gradient is also summed
    over "data")."""
    jm = runs["jax"][name]
    assert len([op for op in jm.graph.ops if op.op_type.name
                == "OP_WEIGHT_SHARD"]) == 2
    want_jax = _jax_fit(jm, runs["data"]["mlp"])
    _, want = _one_device("mlp", {"batch": 8, "width": 16, "hidden": 64,
                                  "classes": 4}, runs["weights"][name],
                          runs["data"]["mlp"], 0,
                          "sparse_categorical_crossentropy",
                          {"lr": 0.1, "momentum": 0.9}, fit=True)
    run = runs["run"]
    out = run.ok(name)
    assert out["mesh"]["fsdp"] == fsdp
    assert out["mesh"]["data"] == 4 // fsdp
    assert all("S(0)" in p[-1]
               for p in out["weight_placements"].values())
    for key, shape in out["local_shapes"].items():
        op, n = key.split("/")
        assert shape[0] * fsdp == want[op][n].shape[0], key
    got = run.arrays(name)
    _assert_weights(got, want, FSDP_RTOL, FSDP_ATOL)
    _assert_weights(got, want_jax, FSDP_RTOL, FSDP_ATOL)
    n_weights, steps = 4, 8
    coll = out["collectives"]
    assert coll["weight/all_gather/fsdp"] == n_weights * steps
    assert coll["grad/reduce_scatter/fsdp"] == n_weights * steps
    assert "grad/all_reduce/fsdp" not in coll
    assert coll.get("grad/all_reduce/data", 0) == (
        n_weights * steps if fsdp == 2 else 0)
    # FSDP weights are not the overlapped sync's: it would sync them twice
    assert out["overlap_weights"] == []


def test_fsdp_optimizer_state_is_sharded(runs):
    """ZeRO's point: Adam's slots, made by zeros_like, inherit each
    weight's fsdp sharding: a rank holds 1/fsdp of the rows of both."""
    out = runs["run"].ok("fsdp4_adam")
    for slots in (out["opt_init"], out["opt_slots"]):
        m = slots["m/op_linear_0/kernel"]
        assert m == [[4, 64], ["S(0)"]]
        for key, (shape, pl) in slots.items():
            assert pl == ["S(0)"], key
            op, n = key.split("/")[1:]
            assert shape == out["local_shapes"][f"{op}/{n}"], key


def test_fsdp_degree_clamped_when_not_dividing():
    """An fsdp degree that does not divide the data degree (here 1: one
    device) is clamped down, with the JAX package's warning."""
    def port():
        m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=8,
                                     fsdp_degree=3))
        _build(m, "mlp", {"batch": 8, "width": 16, "hidden": 64,
                          "classes": 4})
        m.compile(tff.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")
        return m

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        m = port()
    msgs = [str(w.message) for w in rec if "clamped" in str(w.message)]
    assert msgs == ["fsdp_degree 3 does not divide the data-parallel "
                    "degree 1; clamped to 1"]
    assert m.executor.mesh is None
    assert not [op for op in m.graph.ops
                if op.op_type.name == "OP_WEIGHT_SHARD"]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cfg = jff.FFConfig()
        cfg.workersPerNode, cfg.batch_size, cfg.fsdp_degree = 1, 8, 3
        jm = jff.FFModel(cfg)
        x = jm.create_tensor((8, 16), jff.DataType.DT_FLOAT)
        jm.softmax(jm.dense(x, 4))
        jm.compile(jff.SGDOptimizer(lr=0.1),
                   jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [])
    assert [str(w.message) for w in rec if "clamped" in str(w.message)] \
        == msgs


def _overlap_check(runs, mesh, opt, guard):
    """The overlapped step against the all-reduce step in the port (the
    weights and every slot, rtol 3e-6) and against JAX's overlapped
    step (the weights and the last loss, rtol 1e-5)."""
    run = runs["run"]
    tag = f"{mesh}_{opt}_{int(guard)}"
    ov, ar = run.ok(f"ov_{tag}"), run.ok(f"ar_{tag}")
    got, base = run.arrays(f"ov_{tag}"), run.arrays(f"ar_{tag}")
    assert ov["overlap_weights"] and not ar["overlap_weights"]
    assert set(got) == set(base)
    for k in base:
        np.testing.assert_allclose(got[k], base[k], rtol=OV_RTOL,
                                   atol=OV_ATOL, err_msg=k)
    np.testing.assert_allclose(ov["losses"], ar["losses"], rtol=OV_RTOL,
                               atol=OV_ATOL)
    st, partials = _jax_steps(runs["jax"][f"{mesh}_{opt}"],
                              runs["data"]["ov"], 3, guard=guard)
    want = {op: {n: np.asarray(a) for n, a in ws.items()}
            for op, ws in st.params.items()}
    _assert_weights(got, want, JAX_RTOL, JAX_ATOL)
    np.testing.assert_allclose(ov["losses"][-1], float(partials["loss"]),
                               rtol=JAX_RTOL, atol=JAX_ATOL)
    if guard:
        # the norm from per-shard partials is the whole gradient's
        np.testing.assert_allclose(ov["grad_norms"], ar["grad_norms"],
                                   rtol=OV_RTOL)
        np.testing.assert_allclose(ov["grad_norms"][-1],
                                   float(partials["grad_norm"]),
                                   rtol=JAX_RTOL)
        assert ov["skipped"] == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("guard", [False, True])
def test_overlapped_step_matches_allreduce_sgd(runs, mesh, guard):
    _overlap_check(runs, mesh, "sgd", guard)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("guard", [False, True])
def test_overlapped_step_matches_allreduce_adam(runs, mesh, guard):
    _overlap_check(runs, mesh, "adam", guard)


def test_overlap_shards_optimizer_state_zero1(runs):
    """The sharded update never gathers m or v: Adam's slots live
    sharded over "data" (ZeRO-1) from init_state on and after the steps,
    1/4 of the rows on each rank at dp 4, while the weights stay whole."""
    out = runs["run"].ok("ov_dp4_adam_0")
    for slots in (out["opt_init"], out["opt_slots"]):
        assert slots["m/op_linear_0/kernel"] == [[4, 32], ["S(0)"]]
        assert slots["v/op_linear_1/kernel"] == [[8, 16], ["S(0)"]]
    assert out["local_shapes"]["op_linear_0/kernel"] == [16, 32]
    assert all(p == ["R"] for p in out["weight_placements"].values())
    base = runs["run"].ok("ar_dp4_adam_0")
    assert base["opt_slots"]["m/op_linear_0/kernel"] == [[16, 32], ["R"]]


def test_overlap_reduce_scatters_are_issued_from_the_backward(runs):
    """Each eligible gradient's reduce-scatter is issued from its leaf's
    hook while torch.autograd.grad still runs the backward (one a weight
    a step), and the updated weights are all-gathered: no all-reduce is
    left. The all-reduce step all-reduces every gradient instead."""
    out = runs["run"].ok("ov_dp4_sgd_0")
    n = len(out["overlap_weights"])
    assert n == 4
    assert out["overlap_issued_in_backward"] == 3 * n
    assert out["collectives"] == {"grad/reduce_scatter/data": 3 * n,
                                  "param/all_gather/data": 3 * n}
    assert out["grad_syncs"] == 3 * n
    base = runs["run"].ok("ar_dp4_sgd_0")
    assert base["overlap_issued_in_backward"] == 0
    assert base["collectives"] == {"grad/all_reduce/data": 3 * n}


def test_fsdp_target_excluded_from_overlap():
    """A WeightShard-governed op's sync is FSDP's reduce-scatter, not an
    overlappable all-reduce: the port's `overlappable_grad_syncs` leaves
    it out as JAX's does."""
    from flexflow_tpu.analysis.collectives import \
        overlappable_grad_syncs as joverlappable
    from flexflow_tpu.parallel.weight_sharding import \
        insert_weight_shard as jinsert
    from flexflow_tpu_torch.analysis.collectives import \
        overlappable_grad_syncs
    from flexflow_tpu_torch.parallel.weight_sharding import \
        insert_weight_shard

    def linear_graph(pkg, n):
        cfg = pkg.FFConfig() if pkg is jff else pkg.FFConfig(device="cpu")
        cfg.batch_size = 8
        cfg.workersPerNode = n
        m = pkg.FFModel(cfg)
        x = m.create_tensor((8, 16), pkg.DataType.DT_FLOAT, name="x")
        t = m.dense(x, 64, pkg.ActiMode.AC_MODE_RELU)
        m.dense(t, 16, pkg.ActiMode.AC_MODE_NONE)
        m.compile(pkg.SGDOptimizer(lr=0.1),
                  pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                  [pkg.MetricsType.METRICS_MEAN_SQUARED_ERROR])
        return m.graph

    got = {}
    for pkg, insert, overlappable, n in (
            (jff, jinsert, joverlappable, len(jax.devices())),
            (tff, insert_weight_shard, overlappable_grad_syncs, 1)):
        graph = linear_graph(pkg, n)
        ops = [op for op in graph.topo_order()
               if op.weights and not op.is_parallel_op]
        insert(graph, ops[0], 2)
        ov = overlappable(graph)
        assert ops[0].guid not in ov
        got[pkg.__name__] = [op.guid in ov for op in ops]
    assert got["flexflow_tpu_torch"] == got["flexflow_tpu"] == [False, True]


def test_flagship_winner_with_weight_shards_runs_at_its_degrees(runs):
    """The flagship's searched winner for a 4-worker machine shards
    three ops' weights over an fsdp axis of 2 (a WeightShard node each),
    the batch over data x fsdp jointly (data 1): it runs at those
    degrees, the two surplus ranks as replicas. Each fsdp weight is
    gathered where its op reads it and its gradient reduce-scattered
    onto its shard; the other weights' gradients are all-reduced over
    the fsdp group, which is the data-parallel group here. The flash
    kernels (their plain versions here) run per shard on the batch's
    half each rank holds. Two steps match JAX's run of the same winner
    and the port's on one device (the dense path in both)."""
    jm = runs["jax"]["winner"]
    from flexflow_tpu.parallel.weight_sharding import sharded_weight_records

    assert dict(jm.executor.mesh.shape)["fsdp"] == 2

    n_fsdp = len(sharded_weight_records(jm.graph))
    ex = jm.executor
    bs = 8
    step = ex.build_train_step()
    jlosses = []
    for i in range(2):
        xb = ex.shard_batch(ex.input_pts[0],
                            runs["data"]["tf"]["x0"][i * bs:(i + 1) * bs])
        yb = ex.put_replicated(runs["data"]["tf"]["y"][i * bs:(i + 1) * bs])
        jm.state, partials = step(jm.state, [xb], yb, jax.random.PRNGKey(i))
        jlosses.append(float(partials["loss"]))
    losses, want = _one_device(
        "transformer", WINNER, runs["weights"]["winner"], runs["data"]["tf"],
        2, "mse", {"lr": 0.01}, search_budget=4,
        machine_model_file=runs["machine"])
    run = runs["run"]
    out = run.ok("winner")
    assert {k: v for k, v in out["mesh"].items() if v > 1} == {
        k: int(v) for k, v in jm.executor.mesh.shape.items() if v > 1}
    assert out["replicas"] == 2
    sharded = [k for k, p in out["weight_placements"].items()
               if any(s.startswith("S(") for s in p)]
    assert len(sharded) == n_fsdp > 0
    assert out["mesh_paths"] == {"local_map": 2 * WINNER["layers"]}
    assert set(map(tuple, out["local_q"].values())) == {
        (WINNER["batch"] // 2, WINNER["heads"], WINNER["seq"],
         WINNER["hidden"] // WINNER["heads"])}
    n_other = len(out["weight_placements"]) - n_fsdp
    assert out["collectives"] == {"weight/all_gather/fsdp": 2 * n_fsdp,
                                  "grad/reduce_scatter/fsdp": 2 * n_fsdp,
                                  "grad/all_reduce/fsdp": 2 * n_other}
    np.testing.assert_allclose(out["losses"], losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["losses"], jlosses, rtol=RTOL, atol=ATOL)
    got = run.arrays("winner")
    _assert_weights(got, want, RTOL, ATOL)
    _assert_weights(got, {op: {n: np.asarray(a) for n, a in ws.items()}
                          for op, ws in jm.state.params.items()},
                    RTOL, ATOL)


@pytest.mark.parametrize("name", sorted(VAR_MEAN))
def test_statistics_from_partial_sums(runs, name):
    """parallel/mesh.py var_mean over a dim a mesh axis shards: the mean
    and the biased variance of numpy's float64 computation, rtol 1e-5,
    with only all-reduces of the kept dims' vectors (no all-gather, no
    gather counted), the result replicated over the reducing axes."""
    case = VAR_MEAN[name]
    run = runs["run"]
    out = run.ok(f"var_mean_{name}")
    x = np.random.RandomState(0).randn(*case["shape"]).astype(np.float64)
    dims = tuple(case["dims"])
    keep = case.get("keepdim", False)
    got = run.arrays(f"var_mean_{name}")
    np.testing.assert_allclose(got["mean"], x.mean(dims, keepdims=keep),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["var"], x.var(dims, keepdims=keep),
                               rtol=RTOL, atol=ATOL)
    assert out["gathered"] == {}
    assert out["comms"] and all("all_reduce" in k for k in out["comms"]), \
        out["comms"]
    reducing = [a for a, d in case["shard"].items() if d in dims]
    assert out["comms"] == {next(iter(out["comms"])): 2 * len(reducing)}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_chunked_attention_shards_the_query_rows(runs, monkeypatch, name):
    """Chunked attention whose heads (and batch) do not divide the model
    (and data) axis: each rank holds 1/(data x model) of the query rows
    (the positions sharded over the axis that divides neither, at the
    rank's global offset under a causal mask), and 2 steps match one
    device's dense path."""
    kw, cfg, local_q = ROWS[name]
    monkeypatch.setenv("FF_ATTENTION_IMPL", "dense")
    want_losses, want = _one_device("attention", kw, None,
                                    runs["data"][f"rows_{name}"], 2, "mse",
                                    {"lr": 0.1})
    run = runs["run"]
    out = run.ok(f"rows_{name}")
    assert list(out["local_q"].values()) == [local_q]
    b, s, h, dh = local_q
    assert b * s * h * 4 == kw["batch"] * kw["seq"] * kw["heads"]
    assert "replicated_over_data" not in out["mesh_paths"]
    assert "replicated_over_model" not in out["mesh_paths"]
    np.testing.assert_allclose(out["losses"], want_losses, rtol=RTOL,
                               atol=ATOL)
    _assert_weights(run.arrays(f"rows_{name}"), want, RTOL, ATOL)


def test_executor_overlap_schedule_hook_is_clean(runs):
    """tests/test_perf_analysis.py's hook test on the port: the live
    executor's own schedule of its overlapped dp 4 step is present and
    race free (FFA502), and turning the overlapped sync off removes it."""
    out = runs["run"].ok("ov_dp4_sgd_0")
    assert out["schedule_len"] > 0
    assert out["schedule_ok"] is True
    assert out["schedule_off"] is True
