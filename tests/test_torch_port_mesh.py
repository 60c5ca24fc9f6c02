"""flexflow_tpu_torch's device mesh: the placements lowering against the
JAX package's PartitionSpecs, data parallelism against one device, and
the flash dispatch on a sharded mesh.

The placements are a pure function of (ParallelTensor, axis names, axis
sizes): the table runs in this process with no process group, against
`pspec_for_parallel_tensor` on the conftest's CPU devices. The rest runs
ranks as subprocesses (flexflow_tpu_torch/runtime/mesh_run.py running
tests/torch_mesh_cases.py, gloo, OMP_NUM_THREADS=1, a free port; every
rank killed when the launch passes its 150 s timeout; a failed rank's
output is its `rank<r>.log` under the test's tmp_path), each against the
port on one device in this process from the same seed's weights:
  - the dense/softmax model of test_dp_matches_single_device at dp 4:
    the loss and the weights after one step, rel 1e-5 (the JAX test's
    limit) and atol 1e-6;
  - a Dropout op (its mask drawn over the global shape and held as a
    replicated DTensor) at dp 4, 3 steps against one device, rtol 1e-5;
  - the step guard at dp 2 x tp 2 (a NaN-poisoned step skipped on every
    rank; the gradient norm the global gradient's), rtol 1e-5;
  - SGD (momentum, nesterov, weight decay) and Adam updating the
    weights of the dense/softmax model in place at dp 2 x tp 2 (its
    first kernel sharded over "model"): 3 steps, the losses and the
    weights, rtol 1e-5, atol 1e-6;
  - FF_ATTENTION_IMPL=flash on dp 2 x tp 2 (heads divide): the MHA op
    routes through `local_map` (the kernels' plain versions per shard on
    the CPU) and trains 2 steps to the one-device dense losses and
    weights, rtol 1e-5, atol 1e-6; heads 6 on tp 4: chunked attention
    with the query positions sharded over "model", and the same
    agreement; heads 3 on dp 2 x tp 2: the same, with the batch sharded
    over "data";
  - attention dropout: at dp 4 the dense path with the global mask; a
    2-block BERT (attention and hidden dropout, weights loaded from its
    torch module) at dp 2 x tp 2 the same; on a mesh of one device the
    BERT keeps the flash kernels' dropout per shard through local_map;
    each matches one device's steps, rtol 1e-5, atol 1e-6;
  - on 2 ranks, the train scan is bit-equal to stepwise fit.
"""
import concurrent.futures
import json
import pathlib

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as tff
from flexflow_tpu.parallel.mesh import build_mesh as jbuild_mesh
from flexflow_tpu.parallel.mesh import pspec_for_parallel_tensor
from flexflow_tpu.pcg.parallel_tensor import ParallelDim as JDim
from flexflow_tpu.pcg.parallel_tensor import ParallelTensor as JPT
from flexflow_tpu_torch.parallel.mesh import placements_for_parallel_tensor
from flexflow_tpu_torch.pcg.parallel_tensor import ParallelDim as TDim
from flexflow_tpu_torch.pcg.parallel_tensor import ParallelTensor as TPT
from flexflow_tpu_torch.runtime.mesh_run import launch
from torch_mesh_cases import build as _build
from flexflow_tpu_torch.runtime.weights import params_to_numpy

RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 150

# (mesh axes, dims as (size, degree, parallel_idx, is_replica_dim))
_TABLE = [
    ({"data": 4, "model": 2}, [(32, 4, 0, False), (16, 1, -1, False),
                               (64, 2, 1, False)]),
    # a replica dim is dropped: material dims after it keep their index
    ({"data": 4, "model": 2}, [(2, 2, 1, True), (32, 4, 0, False),
                               (64, 1, -1, False)]),
    # two dims on one axis: the first keeps it
    ({"data": 2, "model": 4}, [(8, 4, 1, False), (16, 4, 1, False)]),
    ({"data": 2, "model": 4}, [(8, 1, -1, False), (16, 4, 1, False),
                               (12, 2, 0, False)]),
    # the ZeRO batch rule: data x fsdp jointly
    ({"data": 2, "model": 1, "fsdp": 2}, [(16, 4, 0, False),
                                          (8, 1, -1, False)]),
    ({"data": 2, "model": 1, "fsdp": 2}, [(16, 2, 0, False),
                                          (8, 2, 2, False)]),
    # the expert axis (the renamed data axis) takes the same rule
    ({"data": 1, "model": 1, "expert": 2, "fsdp": 2},
     [(8, 4, 2, False), (4, 1, -1, False)]),
    # a weight sharded over fsdp alone
    ({"data": 2, "model": 2, "fsdp": 2}, [(64, 2, 2, False),
                                          (32, 2, 1, False)]),
    # an index past the axes, and a degree-1 dim, stay replicated
    ({"data": 2, "model": 2}, [(8, 2, 5, False), (4, 1, 0, False)]),
]


def _spec_of(placements, axis_names, ndim):
    """The PartitionSpec-like tuple of a placement list: per tensor dim,
    None, an axis name, or a tuple of axis names (mesh order), trailing
    Nones trimmed, as JAX's specs read."""
    from torch.distributed.tensor import Shard

    per_dim = [[] for _ in range(ndim)]
    for name, p in zip(axis_names, placements):
        if isinstance(p, Shard):
            per_dim[p.dim].append(name)
    spec = [None if not a else a[0] if len(a) == 1 else tuple(a)
            for a in per_dim]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@pytest.mark.parametrize("axes,dims", _TABLE)
def test_placements_lowering_matches_jax_pspec(axes, dims):
    jpt = JPT(dims=[JDim(size=s, degree=g, parallel_idx=i, is_replica_dim=r)
                    for s, g, i, r in dims])
    tpt = TPT(dims=[TDim(size=s, degree=g, parallel_idx=i, is_replica_dim=r)
                    for s, g, i, r in dims])
    want = tuple(pspec_for_parallel_tensor(jpt, jbuild_mesh(axes)))
    pl = placements_for_parallel_tensor(tpt, tuple(axes),
                                        tuple(axes.values()))
    assert len(pl) == len(axes)
    assert _spec_of(pl, tuple(axes), len(tpt.material_shape())) == want


@pytest.mark.parametrize("axes,dims", [
    ({"data": 4, "model": 2}, [4]), ({"data": 4, "model": 2}, [2, 4]),
    ({"data": 2, "model": 2}, [2, 2]), ({"data": 8}, [3])])
def test_machine_view_to_axes_matches_jax(axes, dims):
    import types

    from flexflow_tpu.parallel.mesh import machine_view_to_axes as jmv
    from flexflow_tpu_torch.parallel.mesh import machine_view_to_axes

    view = types.SimpleNamespace(dim=dims)
    assert machine_view_to_axes(view, types.SimpleNamespace(shape=axes)) \
        == jmv(view, jbuild_mesh(axes))


@pytest.mark.parametrize("field,slice_name", [
    ("sequence_parallel_degree", "sequence parallelism"),
    ("expert_parallel_degree", "expert parallelism"),
    ("pipeline_parallel_degree", "pipeline parallelism")])
def test_unported_degrees_raise_naming_their_slice(field, slice_name):
    """The sequence, expert and pipeline degrees are ported (the slices
    named): on one process (one device) a degree of 2 needs two devices,
    and compile raises ValueError naming the degrees and the device
    count, as a tensor degree does. No pipeline runs its stages one after
    another in one process."""
    m = tff.FFModel(tff.FFConfig(device="cpu", **{field: 2}))
    m.softmax(m.create_tensor((2, 4)))
    with pytest.raises(ValueError,
                       match=f"{field} 2 .*does not divide the 1 devices"):
        m.compile()


def test_more_devices_than_processes_raise():
    """Without a process group the port runs one device: asking for more
    names the one-process-per-device launch."""
    m = tff.FFModel(tff.FFConfig(device="cpu", workersPerNode=2))
    m.softmax(m.create_tensor((2, 4)))
    with pytest.raises(NotImplementedError, match="one process per device"):
        m.compile()
    m = tff.FFModel(tff.FFConfig(device="cpu", tensor_parallel_degree=2))
    m.softmax(m.create_tensor((2, 4)))
    with pytest.raises(ValueError, match="does not divide"):
        m.compile()


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_ring_and_ulysses_raise_naming_their_slice(monkeypatch, impl):
    """FF_ATTENTION_IMPL=ring|ulysses without a seq axis: the op warns
    with JAX's "sp_mesh" reason and streams as JAX's local_attention
    does off the card (chunked attention), bit for bit."""
    from flexflow_tpu_torch.ops import attention as att

    m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=2))
    _build(m, "attention", {"batch": 2, "seq": 4, "embed": 8, "heads": 2})
    m.compile(loss_type="mse")
    x = [np.random.RandomState(0).randn(2, 4, 8).astype(np.float32)]
    monkeypatch.setenv("FF_ATTENTION_IMPL", "chunked")
    want = m.executor.build_forward()(m.params, x)
    monkeypatch.setenv("FF_ATTENTION_IMPL", impl)
    att._FALLBACK_WARNED.clear()
    with pytest.warns(UserWarning,
                      match="sequence parallelism .* needs a seq-sharded"):
        got = m.executor.build_forward()(m.params, x)
    assert torch.equal(got, want)


# the optimizers on tensor-sharded weights: SGD with momentum, nesterov
# and weight decay, and Adam
OPTIMIZERS = {
    "sgd_momentum": {"lr": 0.1, "momentum": 0.9, "nesterov": True,
                     "weight_decay": 0.01},
    "adam": {"adam": True, "alpha": 0.01, "weight_decay": 0.01},
}
ATT = {"batch": 4, "seq": 16, "embed": 32, "heads": 4}
ATT6 = {"batch": 2, "seq": 16, "embed": 36, "heads": 6}
ATT3 = {"batch": 4, "seq": 16, "embed": 36, "heads": 3}
ATT_DROP = dict(ATT, dropout=0.1)
BERT = {"layers": 2, "hidden": 64, "heads": 4, "ffn": 256, "dropout": 0.1,
        "batch": 2, "seq": 16}
CASES = str(pathlib.Path(__file__).with_name("torch_mesh_cases.py"))


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
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ranks")
    rng = np.random.RandomState(0)
    data = {
        "dense": dict(x0=rng.randn(8, 12).astype(np.float32),
                      y=rng.randint(0, 4, (8, 1)).astype(np.int32)),
        "dense3": dict(x0=rng.randn(24, 12).astype(np.float32),
                       y=rng.randint(0, 4, (24, 1)).astype(np.int32)),
        "att": dict(x0=rng.randn(8, 16, 32).astype(np.float32),
                    y=rng.randn(8, 16, 32).astype(np.float32)),
        "att6": dict(x0=rng.randn(4, 16, 36).astype(np.float32),
                     y=rng.randn(4, 16, 36).astype(np.float32)),
        "att3": dict(x0=rng.randn(8, 16, 36).astype(np.float32),
                     y=rng.randn(8, 16, 36).astype(np.float32)),
        "bert": dict(x0=rng.randn(4, 16, 64).astype(np.float32),
                     y=rng.randn(4, 16, 64).astype(np.float32)),
        "moe": dict(x0=rng.randn(16, 32).astype(np.float32),
                    y=rng.randint(0, 4, (16, 1)).astype(np.int32)),
    }
    paths = {}
    for k, arrays in data.items():
        paths[k] = str(d / f"data_{k}.npz")
        np.savez(paths[k], **arrays)
    four = [
        {"name": "dp4_dense", "builder": "dense_softmax",
         "builder_kwargs": {"batch": 8}, "config": {"batch_size": 8},
         "data": paths["dense"], "steps": 1, "lr": 0.1,
         "loss": "sparse_categorical_crossentropy", "metrics": ["accuracy"]},
        {"name": "dropout", "builder": "dropout_mlp",
         "builder_kwargs": {"batch": 8}, "config": {"batch_size": 8},
         "data": paths["dense3"], "steps": 3, "lr": 0.1,
         "loss": "sparse_categorical_crossentropy"},
        {"name": "guard", "builder": "dense_softmax",
         "builder_kwargs": {"batch": 8},
         "config": {"batch_size": 8, "tensor_parallel_degree": 2},
         "data": paths["dense3"], "steps": 3, "mode": "guard",
         "optimizer": OPTIMIZERS["sgd_momentum"],
         "loss": "sparse_categorical_crossentropy"},
        *[{"name": f"opt_{k}", "builder": "dense_softmax",
           "builder_kwargs": {"batch": 8},
           "config": {"batch_size": 8, "tensor_parallel_degree": 2},
           "data": paths["dense3"], "steps": 3, "optimizer": opt,
           "loss": "sparse_categorical_crossentropy"}
          for k, opt in OPTIMIZERS.items()],
        {"name": "flash_local_map", "builder": "attention",
         "builder_kwargs": ATT,
         "config": {"batch_size": 4, "tensor_parallel_degree": 2},
         "env": {"FF_ATTENTION_IMPL": "flash"}, "data": paths["att"],
         "steps": 2, "lr": 0.1},
        {"name": "flash_indivisible", "builder": "attention",
         "builder_kwargs": ATT6,
         "config": {"batch_size": 2, "tensor_parallel_degree": 4},
         "env": {"FF_ATTENTION_IMPL": "flash"}, "data": paths["att6"],
         "steps": 2, "lr": 0.1},
        {"name": "flash_chunked_batch", "builder": "attention",
         "builder_kwargs": ATT3,
         "config": {"batch_size": 4, "tensor_parallel_degree": 2},
         "env": {"FF_ATTENTION_IMPL": "flash"}, "data": paths["att3"],
         "steps": 2, "lr": 0.1},
        {"name": "flash_dropout_dp4", "builder": "attention",
         "builder_kwargs": ATT_DROP, "config": {"batch_size": 4},
         "env": {"FF_ATTENTION_IMPL": "flash"}, "data": paths["att"],
         "steps": 2, "lr": 0.1},
        {"name": "moe_dp4", "builder": "moe", "builder_kwargs": {"batch": 8},
         "config": {"batch_size": 8}, "data": paths["moe"], "steps": 2,
         "lr": 0.1, "loss": "sparse_categorical_crossentropy"},
        {"name": "bert_dp2tp2", "builder": "bert", "builder_kwargs": BERT,
         "config": {"batch_size": 2, "tensor_parallel_degree": 2},
         "env": {"FF_ATTENTION_IMPL": "flash"}, "data": paths["bert"],
         "steps": 2, "lr": 0.01},
    ]
    one = [
        {"name": "bert_world1", "builder": "bert", "builder_kwargs": BERT,
         "config": {"batch_size": 2}, "env": {"FF_ATTENTION_IMPL": "flash"},
         "data": paths["bert"], "steps": 2, "lr": 0.01},
    ]
    base = {"builder": "mlp", "builder_kwargs": {"batch": 32},
            "config": {"batch_size": 32}, "loss": "sparse_categorical_"
            "crossentropy", "data": str(d / "data_mlp.npz")}
    np.savez(base["data"], x0=rng.rand(64, 784).astype(np.float32),
             y=rng.randint(0, 10, (64, 1)).astype(np.int32))
    two = []
    # the train scan over the mesh, and the stepwise fit it must equal
    for spd in (1, 2):
        two.append(dict(base, name=f"fit_spd{spd}", mode="fit",
                        config=dict(base["config"],
                                    iterations_per_dispatch=spd)))
    pool = concurrent.futures.ThreadPoolExecutor(2)
    out = {}
    for name, n, cases in (("four", 4, four), ("two", 2, two),
                           ("one", 1, one)):
        gd = d / name
        gd.mkdir()
        (gd / "spec.json").write_text(json.dumps(cases))
        out[name] = _Run(gd, n, pool.submit(
            launch, n, ["--device", "cpu", CASES, str(gd / "spec.json"),
                        str(gd)], str(gd), timeout=TIMEOUT))
    yield {"runs": out, "data": data}
    pool.shutdown(wait=True)


def _one_device(builder, kw, data, steps, lr, loss, metrics=(),
                optimizer=None):
    """The port on one device (no process group) from the same seed's
    weights: the losses of `steps` train steps and the weights after."""
    m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=kw["batch"]))
    source = _build(m, builder, kw)
    opt = dict(optimizer or {"lr": lr})
    opt = (tff.AdamOptimizer(**{k: v for k, v in opt.items()
                                if k != "adam"})
           if opt.pop("adam", False) else tff.SGDOptimizer(**opt))
    m.compile(opt, loss, list(metrics))
    if source is not None:
        source.load_weights(m)
    step = m.executor.build_train_step()
    bs = kw["batch"]
    losses = []
    for i in range(steps):
        m.state, partials = step(m.state, [data["x0"][i * bs:(i + 1) * bs]],
                                 data["y"][i * bs:(i + 1) * bs], i)
        losses.append(float(partials["loss"]))
    return losses, params_to_numpy(m)


def _compare(run, name, weights):
    got = run.arrays(name)
    for op, ws in weights.items():
        for n, a in ws.items():
            np.testing.assert_allclose(got[f"w/{op}/{n}"], a, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{op}.{n}")


def test_dp_matches_single_device(runs):
    """tests/test_sharding.py's DP check in the port alone: one step of
    the dense/softmax model at dp 4 against one device."""
    want, weights = _one_device(
        "dense_softmax", {"batch": 8}, runs["data"]["dense"], 1, 0.1,
        "sparse_categorical_crossentropy", ["accuracy"])
    run = runs["runs"]["four"]
    out = run.ok("dp4_dense")
    assert out["mesh"]["data"] == 4
    assert out["losses"][0] == pytest.approx(want[0], rel=1e-5)
    _compare(run, "dp4_dense", weights)
    # the weights replicated over the one live (data) axis
    assert all(p == ["R"] for p in out["weight_placements"].values())


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_optimizers_update_sharded_weights_in_place(runs, kind):
    """3 steps of the dense/softmax model at dp 2 x tp 2 under each
    optimizer against one device: the updates act on DTensor weights
    (one kernel sharded over "model") and their state in place."""
    want, weights = _one_device(
        "dense_softmax", {"batch": 8}, runs["data"]["dense3"], 3, None,
        "sparse_categorical_crossentropy",
        optimizer=dict(OPTIMIZERS[kind]))
    run = runs["runs"]["four"]
    out = run.ok(f"opt_{kind}")
    assert (out["mesh"]["data"], out["mesh"]["model"]) == (2, 2)
    assert any("S(" in str(p) for p in out["weight_placements"].values())
    np.testing.assert_allclose(out["losses"], want, rtol=RTOL, atol=ATOL)
    _compare(run, f"opt_{kind}", weights)


def test_an_op_dtensor_refuses_runs_on_replicated_operands(runs):
    """The Dropout op builds its mask as a plain tensor of the global
    shape, which DTensor refuses beside a DTensor: the op holds it as a
    replicated DTensor (parallel/mesh.py `like`), so at dp 4 the op runs
    on its batch shards with the global mask, every gradient is summed
    over "data", and 3 steps match one device's (the same step seeds
    draw the same masks)."""
    want, weights = _one_device(
        "dropout_mlp", {"batch": 8}, runs["data"]["dense3"], 3, 0.1,
        "sparse_categorical_crossentropy")
    run = runs["runs"]["four"]
    out = run.ok("dropout")
    # every weight replicated over "data": each step all-reduces every
    # gradient
    assert out["grad_syncs"] == 3 * len(out["local_shapes"])
    np.testing.assert_allclose(out["losses"], want, rtol=RTOL, atol=ATOL)
    _compare(run, "dropout", weights)


def test_step_guard_reads_the_global_gradient(runs):
    """The NaN/Inf step guard at dp 2 x tp 2: the gradient norm is the
    global gradient's (one device's, rtol 1e-5), the poisoned second step
    is skipped on every rank with the weights and momentum carried
    through, and the run ends where one device's ends."""
    from flexflow_tpu_torch.runtime.resilience import StepGuardConfig

    m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=8))
    _build(m, "dense_softmax", {"batch": 8})
    m.compile(tff.SGDOptimizer(**OPTIMIZERS["sgd_momentum"]),
              "sparse_categorical_crossentropy")
    ex = m.executor
    ex.set_step_guard(StepGuardConfig(init_loss_scale=4.0))
    m.state.guard = ex.init_guard_state()
    step = ex.build_train_step()
    d = runs["data"]["dense3"]
    norms, skipped = [], []
    for i in range(3):
        poison = torch.tensor(float("nan") if i == 1 else 1.0)
        m.state, partials = step(m.state, [d["x0"][i * 8:(i + 1) * 8]],
                                 d["y"][i * 8:(i + 1) * 8], i, poison)
        norms.append(float(partials["grad_norm"]))
        skipped.append(float(partials["skipped"]))
    run = runs["runs"]["four"]
    out = run.ok("guard")
    assert out["skipped"] == skipped == [0.0, 1.0, 0.0]
    np.testing.assert_allclose(out["grad_norms"], norms, rtol=RTOL, atol=ATOL)
    _compare(run, "guard", params_to_numpy(m))


# the attention routes a case's ranks count: (route, count a step). The
# chunked cases' heads do not divide the model axis, which shards their
# query positions instead (the batch over "data" where it divides)
_ROUTES = {
    "local_map": {"local_map": 1},
    "chunked_replicated": {"chunked": 1, "rows_over_model": 1},
    "chunked_batch_sharded": {"chunked": 1, "rows_over_model": 1},
    "dense": {"dense": 1},
}


@pytest.mark.parametrize("name,kw,data,route", [
    ("flash_local_map", ATT, "att", "local_map"),
    ("flash_indivisible", ATT6, "att6", "chunked_replicated"),
    ("flash_chunked_batch", ATT3, "att3", "chunked_batch_sharded"),
    ("flash_dropout_dp4", ATT_DROP, "att", "dense")])
def test_flash_dispatch_on_a_sharded_mesh(runs, monkeypatch, name, kw,
                                          data, route):
    """FF_ATTENTION_IMPL=flash on a sharded mesh: heads that divide the
    model axis run the flash kernels per shard through local_map (here
    their plain versions), indivisible heads take chunked attention with
    the query positions sharded over "model" (on dp 2 x tp 2 with the
    batch still sharded over "data": no `rows_over_data`), and dropout at
    dp 4 takes the dense path
    with the global mask; either way 2 train steps match one device's
    (the dense path; the flash path's plain versions under dropout,
    which drop the same elements)."""
    monkeypatch.setenv("FF_ATTENTION_IMPL",
                       "flash" if kw.get("dropout") else "dense")
    want, weights = _one_device("attention", kw, runs["data"][data], 2, 0.1,
                                "mse")
    run = runs["runs"]["four"]
    out = run.ok(name)
    assert out["mesh_paths"] == {k: 2 * v
                                 for k, v in _ROUTES[route].items()}
    np.testing.assert_allclose(out["losses"], want, rtol=RTOL, atol=ATOL)
    _compare(run, name, weights)


def test_flash_dropout_per_shard_on_a_mesh_of_one_device(runs,
                                                        monkeypatch):
    """On a mesh of one device every shard is the whole array, so a
    2-block BERT (attention and hidden dropout) keeps the flash kernels'
    dropout through local_map (never the dense path), as the JAX package
    keeps its flash dropout kernel on a trivial mesh, and 2 steps match
    one device's; no gradient needs a collective."""
    monkeypatch.setenv("FF_ATTENTION_IMPL", "flash")
    want, weights = _one_device("bert", BERT, runs["data"]["bert"], 2,
                                0.01, "mse")
    run = runs["runs"]["one"]
    out = run.ok("bert_world1")
    assert out["executor"] == "MeshExecutor"
    assert out["mesh_paths"] == {"local_map": 2 * BERT["layers"]}
    assert out["grad_syncs"] == 0
    np.testing.assert_allclose(out["losses"], want, rtol=RTOL, atol=ATOL)
    _compare(run, "bert_world1", weights)


def test_bert_with_dropout_on_a_sharded_mesh(runs, monkeypatch):
    """A 2-block BERT through the PyTorch frontend (its weights loaded
    into the compiled model's shards), attention and hidden dropout 0.1,
    at dp 2 x tp 2: every op runs on DTensors (no op is gathered), the
    attention takes the dense path with the global mask, and 2 steps
    match one device's flash path, which drops the same elements."""
    monkeypatch.setenv("FF_ATTENTION_IMPL", "flash")
    want, weights = _one_device("bert", BERT, runs["data"]["bert"], 2,
                                0.01, "mse")
    run = runs["runs"]["four"]
    out = run.ok("bert_dp2tp2")
    assert (out["mesh"]["data"], out["mesh"]["model"]) == (2, 2)
    assert any("S(" in str(p) for p in out["weight_placements"].values())
    assert out["mesh_paths"] == {"dense": 2 * BERT["layers"]}
    np.testing.assert_allclose(out["losses"], want, rtol=RTOL, atol=ATOL)
    _compare(run, "bert_dp2tp2", weights)


def test_moe_dispatch_over_the_global_batch(runs):
    """The zoo's MoE at dp 4: a token's slot in its expert's capacity is
    its rank among the WHOLE batch's rows, so GroupBy's and Aggregate's
    dispatch mask is built on the assignments gathered whole (counted),
    and 2 steps with the balance loss match one device's."""
    want, weights = _one_device("moe", {"batch": 8}, runs["data"]["moe"], 2,
                                0.1, "sparse_categorical_crossentropy")
    run = runs["runs"]["four"]
    out = run.ok("moe_dp4")
    assert out["mesh"]["data"] == 4
    assert out["gathered"]["dispatch_mask"] > 0
    np.testing.assert_allclose(out["losses"], want, rtol=RTOL, atol=ATOL)
    _compare(run, "moe_dp4", weights)


def test_train_scan_on_a_mesh_of_two_devices(runs):
    """fit(iterations_per_dispatch=2) on a 2-device data mesh runs the
    train scan (the eager steps' loop off the card), where it used to
    raise: the weights after it are bit-equal to stepwise fit's on the
    same mesh, and every gradient is synced each step either way."""
    run = runs["runs"]["two"]
    scan, step = run.ok("fit_spd2"), run.ok("fit_spd1")
    assert scan["mesh"]["data"] == 2
    assert scan["collectives"] == step["collectives"] != {}
    a, b = run.arrays("fit_spd2"), run.arrays("fit_spd1")
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_no_process_group_keeps_the_one_device_executor():
    m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=2))
    m.softmax(m.create_tensor((2, 4)))
    m.compile(loss_type="mse")
    assert type(m.executor).__name__ == "PCGExecutor"
    assert m.executor.mesh is None
    assert not torch.distributed.is_initialized()
