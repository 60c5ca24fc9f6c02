"""flexflow_tpu_torch's pipeline parallelism against the JAX package on the
conftest's CPU devices: the block-stack op (ops/pipeline.py), the GPipe
schedule over a "pipe" axis (parallel/pipeline.py: stacked blocks and
stage-partitioned PCGs), the executor's stage plan, the pipeline search
and the hybrid mesh.

On one process: `balanced_linear_partition`, `_encoder_block` and
`scan_blocks` with their gradients (f32, and bf16 compute over f32
weights), the block stack at one stage against the per-layer graph with
sliced weights (`runtime/weights.py` `block_stack_layers`),
`_plan_pcg_pipeline` on tests/test_pipeline.py's non-uniform CNN and
each of its "running unpipelined" refusals, the seed table's tick fold,
and `_search_pipeline_degree`'s decision at 4 devices (JAX's
`workersPerNode` 4; the port's live device count patched to 4, so the
search decides for 4 devices while one process runs it): pipeline on an
overflow, a fitting tensor-parallel winner instead, nothing with ample
memory (tests/test_pipeline.py's sizes, scaled to 4 devices).

On gloo ranks, as the other mesh files run them (subprocesses running
tests/torch_mesh_cases.py, OMP_NUM_THREADS=1, the 150 s launch timeout,
a group of 2 and a group of 4 started together; a failed rank's output
is its `rank<r>.log` under the module's tmp dir), each held against JAX
on a CPU mesh of the same shape from JAX's initial weights: `gpipe_mesh`
forward and gradients at pipe 2 and data 2 x pipe 2; the block-stack
model's train steps (pp 2 with 4 micro-batches, pp 4 with 0); `gpipe_pcg`
on the non-uniform model (forward, and one train step at pp 2 and data 2
x pipe 2); the search's pipelined winner, executed; `verify_strategy` on
a pipelined strategy; the hybrid mesh's axis order.

Tolerances are tests/test_pipeline.py's: 2e-5 forward in f32, 1e-4
gradients and trained weights, 2e-4 for the non-uniform model; bf16
compute holds the f32 reference at BF16_TOL.
"""
import concurrent.futures
import functools
import json
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu.models.transformer import build_transformer as jtransformer
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu_torch.runtime.mesh_run import launch
from flexflow_tpu_torch.runtime.weights import (block_stack_layers,
                                                params_from_numpy,
                                                params_to_numpy)
from torch_mesh_cases import build as _build

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
NU_TOL = 2e-4
# bf16 compute against the f32 math of the same weights (both packages
# round q, k, v, the probabilities and the attention rows to bf16)
BF16_TOL = 3e-2
TIMEOUT = 150
CASES = str(pathlib.Path(__file__).with_name("torch_mesh_cases.py"))
# tests/test_pipeline.py's flagship blocks
TF = {"batch": 8, "seq": 16, "hidden": 32, "heads": 4, "layers": 4}
NU_BATCH = 8
# the GPipe schedule alone: (L, e, h), x (b, s, e)
GP = (4, 32, 4)
GP_X = (8, 16, 32)
# (ranks, {mesh}, micro-batches) of the schedule alone
GPIPE_CASES = {"gpipe_p2": (2, {"data": 1, "pipe": 2}, 2),
               "gpipe_d2p2": (4, {"data": 2, "pipe": 2}, 2)}
# (ranks, pp, num_microbatches) of the block-stack model; pp 1 on 2
# ranks: the stack on a data-parallel mesh, each rank's layers in turn
STACK_CASES = {"stack_pp2_m4": (2, 2, 4), "stack_pp4_m0": (4, 4, 0),
               "stack_dp2": (2, 1, 0)}
STACK_STEPS = 3
# (ranks) of the non-uniform model at pp 2
PCG_CASES = {"pcg_pp2": 2, "pcg_dp2pp2": 4}
# the search at 4 devices: (layers, width, batch, device_mem MiB) and the
# decision's kind; the overflow case also runs on 4 ranks
SEARCH_CASES = {"overflow": ((8, 1024, 256, 24), "pipe"),
                "tp_fits": ((4, 2048, 16, 36), "model"),
                "ample": ((4, 1024, 64, 1 << 20), None)}
SEARCH_WORKERS = 4
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"
SPARSE = "sparse_categorical_crossentropy"


@pytest.fixture(autouse=True)
def _no_jax_calibration(monkeypatch):
    monkeypatch.setattr(jcm, "load_default_calibration", lambda: None)


def _machine_file(d, workers=SEARCH_WORKERS):
    p = pathlib.Path(d) / f"machine_{workers}.cfg"
    p.write_text(f"num_nodes = 1\nnum_gpus_per_node = {workers}\n"
                 "intra_node_bandwidth = 90e9\ninter_node_bandwidth = 25e9\n")
    return str(p)


def _jax_cfg(n, **kw):
    cfg = jff.FFConfig()
    cfg.workersPerNode, cfg.numNodes = n, 1
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _jax_stack(n, pp, n_micro):
    m = jff.FFModel(_jax_cfg(n, batch_size=TF["batch"],
                             pipeline_parallel_degree=pp,
                             num_microbatches=n_micro))
    x = m.create_tensor((TF["batch"], TF["seq"], TF["hidden"]),
                        jff.DataType.DT_FLOAT)
    m.transformer_blocks(x, TF["hidden"], TF["heads"], TF["layers"],
                         name="encoder_stack")
    m.compile(jff.SGDOptimizer(lr=0.05), getattr(jff.LossType, MSE), [])
    return m


def _jax_nonuniform(n, pp, machine=""):
    A, D = jff.ActiMode, jff.DataType
    m = jff.FFModel(_jax_cfg(n, batch_size=NU_BATCH,
                             pipeline_parallel_degree=pp,
                             machine_model_file=machine))
    x = m.create_tensor((NU_BATCH, 3, 16, 16), D.DT_FLOAT)
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, A.AC_MODE_RELU)
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = m.flat(t)
    t = m.dense(t, 64, A.AC_MODE_RELU)
    skip = t
    t = m.dense(t, 64)
    t = m.add(t, skip)
    m.dense(t, 10)
    m.compile(jff.SGDOptimizer(lr=0.05), getattr(jff.LossType, MSE), [])
    return m


def _jax_budgeted(n, layers, width, batch, mem_mib, machine):
    A, D = jff.ActiMode, jff.DataType
    m = jff.FFModel(_jax_cfg(n, batch_size=batch, search_budget=2,
                             device_mem=mem_mib << 20,
                             machine_model_file=machine))
    x = m.create_tensor((batch, width), D.DT_FLOAT)
    t = x
    for _ in range(layers):
        t = m.dense(t, width, A.AC_MODE_RELU)
    t = m.dense(t, 10)
    m.softmax(t)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.compile(jff.SGDOptimizer(lr=0.01),
                  jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [])
    return m


def _torch_model(builder, kw, loss="mse", lr=0.05, **cfg):
    m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=kw["batch"],
                                 **cfg))
    _build(m, builder, kw)
    m.compile(tff.SGDOptimizer(lr=lr), loss, [])
    return m


def _jax_params(m):
    return {op: {n: np.asarray(a) for n, a in ws.items()}
            for op, ws in m.state.params.items()}


def _save(path, tree):
    np.savez(path, **{f"{op}/{n}": np.asarray(a, np.float32)
                      for op, ws in tree.items() for n, a in ws.items()})
    return str(path)


def _weighted(m):
    """JAX model `m`'s weighted op names in topo order."""
    return [op.name for op in m.executor.topo if op.weights]


def _jax_steps(m, data, batch, steps, forward=False):
    """`steps` train steps of JAX model `m`: (losses, the forward of the
    first batch from the weights before them, the weights after)."""
    ex = m.executor
    fwd = None
    if forward:
        fwd = np.asarray(ex.build_forward()(
            m.state.params, [ex.shard_batch(ex.input_pts[0],
                                            data["x0"][:batch])]))
    step = ex.build_train_step(donate=False)
    st, losses = m.state, []
    for i in range(steps):
        xb = ex.shard_batch(ex.input_pts[0],
                            data["x0"][i * batch:(i + 1) * batch])
        yb = ex.put_replicated(data["y"][i * batch:(i + 1) * batch])
        st, partials = step(st, [xb], yb, ex.put_replicated(
            jax.random.PRNGKey(i)))
        losses.append(float(partials["loss"]))
    return losses, fwd, {op: {n: np.asarray(a) for n, a in ws.items()}
                         for op, ws in st.params.items()}


def _jax_gpipe(arrs, n, mesh_axes, n_micro):
    """JAX's gpipe_spmd on `n` CPU devices: the output and the gradients
    of sum(out ** 2) for every weight and x."""
    from flexflow_tpu.ops.pipeline import _encoder_block
    from flexflow_tpu.parallel.mesh import build_mesh
    from flexflow_tpu.parallel.pipeline import gpipe_spmd

    mesh = build_mesh(mesh_axes, jax.devices()[:n])
    w = {k: jnp.asarray(a) for k, a in arrs.items() if k != "x"}
    x = jnp.asarray(arrs["x"])
    block = functools.partial(_encoder_block, head_dim=w["wq"].shape[-1],
                              compute_dtype=None)

    def loss(w, x):
        out = gpipe_spmd(block, w, x, n_stages=mesh_axes["pipe"],
                         n_micro=n_micro, mesh=mesh)
        return jnp.sum(out ** 2), out

    (_, out), (gw, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(w, x)
    got = {"out": np.asarray(out), "dx": np.asarray(gx)}
    got.update({f"d{k}": np.asarray(g) for k, g in gw.items()})
    return got


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
        return outs

    def arrays(self, name):
        with np.load(self.dir / f"{name}.npz") as z:
            return {k: z[k] for k in z.files}


def _gp_arrays(rng):
    L, e, h = GP
    d = e // h
    shapes = {"wq": (L, e, h, d), "wk": (L, e, h, d), "wv": (L, e, h, d),
              "wo": (L, h, d, e), "bias_o": (L, e), "w1": (L, e, e),
              "w2": (L, e, e)}
    out = {k: (rng.randn(*s) * 0.1).astype(np.float32)
           for k, s in shapes.items()}
    out["x"] = rng.randn(*GP_X).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Build the JAX models whose weights the ranks start from, start both
    rank groups, then compute the JAX references while they run."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcm, "load_default_calibration", lambda: None)
    d = tmp_path_factory.mktemp("pipeline_ranks")
    machine = _machine_file(d)
    rng = np.random.RandomState(0)
    data = {"gp": _gp_arrays(rng),
            "tf": dict(x0=rng.randn(STACK_STEPS * TF["batch"], TF["seq"],
                                    TF["hidden"]).astype(np.float32)),
            "nu": dict(x0=rng.randn(NU_BATCH, 3, 16, 16).astype(np.float32),
                       y=rng.randn(NU_BATCH, 10).astype(np.float32))}
    data["tf"]["y"] = (data["tf"]["x0"] * 0.5).astype(np.float32)
    layers, width, batch, _ = SEARCH_CASES["overflow"][0]
    data["search"] = dict(
        x0=(rng.randn(batch, width) * 0.1).astype(np.float32),
        y=rng.randint(0, 10, (batch, 1)).astype(np.int32))
    paths = {}
    for k, arrays in data.items():
        paths[k] = str(d / f"data_{k}.npz")
        np.savez(paths[k], **arrays)
    jm = {name: _jax_stack(n, pp, micro)
          for name, (n, pp, micro) in STACK_CASES.items()}
    # one machine file for both packages: the plan cuts by its costs
    nu_machine = {n: _machine_file(d, n) for n in set(PCG_CASES.values())}
    jm.update({name: _jax_nonuniform(n, 2, nu_machine[n])
               for name, n in PCG_CASES.items()})
    jm["search"] = _jax_budgeted(SEARCH_WORKERS, *SEARCH_CASES["overflow"][0],
                                 machine)
    w = {k: _save(d / f"w_{k}.npz", _jax_params(m)) for k, m in jm.items()
         if k != "search"}
    names = _weighted(jm["search"])
    w["search"] = str(d / "w_search.npz")
    np.savez(w["search"], **{f"{names.index(op)}/{n}": np.asarray(a)
                             for op, ws in _jax_params(jm["search"]).items()
                             for n, a in ws.items()})
    groups = {2: [], 4: []}
    for name, (n, axes, micro) in GPIPE_CASES.items():
        groups[n].append({"name": name, "mode": "gpipe", "mesh": axes,
                          "n_micro": micro, "data": paths["gp"]})
    for name, (n, pp, micro) in STACK_CASES.items():
        groups[n].append({
            "name": name, "builder": "block_stack", "builder_kwargs": TF,
            "config": {"batch_size": TF["batch"],
                       "pipeline_parallel_degree": pp,
                       "num_microbatches": micro},
            "weights": w[name], "data": paths["tf"], "steps": STACK_STEPS,
            "lr": 0.05})
    for name, n in PCG_CASES.items():
        case = {"name": name, "builder": "nonuniform",
                "builder_kwargs": {"batch": NU_BATCH},
                "config": {"batch_size": NU_BATCH,
                           "pipeline_parallel_degree": 2,
                           "machine_model_file": nu_machine[n]},
                "weights": w[name], "data": paths["nu"], "steps": 1,
                "lr": 0.05}
        groups[n].append(case)
        if n == 2:
            groups[n].append(dict(case, name="pcg_pp2_fwd", steps=0,
                                  forward=True))
            groups[n].append(dict(case, name="pcg_pp2_verify",
                                  mode="verify", steps=2))
    for spd in (1, STACK_STEPS):
        groups[2].append({
            "name": f"stack_pp2_fit{spd}", "builder": "transformer",
            "builder_kwargs": TF,
            "config": {"batch_size": TF["batch"],
                       "pipeline_parallel_degree": 2,
                       "iterations_per_dispatch": spd},
            "weights": w["stack_pp2_m4"], "data": paths["tf"],
            "mode": "fit", "lr": 0.05})
    groups[2].append({
        "name": "pcg_dropout", "builder": "dropout_mlp",
        "builder_kwargs": {"batch": NU_BATCH},
        "config": {"batch_size": NU_BATCH, "pipeline_parallel_degree": 2},
        "random_data": {"x_shapes": [[NU_BATCH, 12]],
                        "y_shape": [NU_BATCH, 4]}, "steps": 2})
    groups[4].append({
        "name": "search_overflow", "builder": "budgeted",
        "builder_kwargs": {"layers": layers, "width": width,
                           "batch": batch},
        "config": {"batch_size": batch, "search_budget": 2,
                   "device_mem": SEARCH_CASES["overflow"][0][3] << 20,
                   "machine_model_file": machine},
        "weights": w["search"], "weights_by_position": True,
        "data": paths["search"], "steps": 1, "lr": 0.01, "loss": SPARSE})
    groups[4].append({"name": "hybrid", "mode": "hybrid",
                      "ici": {"pipe": 2}, "dcn": {"data": 2}})
    pool = concurrent.futures.ThreadPoolExecutor(2)
    out = {}
    for n, cases in groups.items():
        gd = d / f"group{n}"
        gd.mkdir()
        (gd / "spec.json").write_text(json.dumps(cases))
        out[n] = _Run(gd, n, pool.submit(
            launch, n, ["--device", "cpu", CASES, str(gd / "spec.json"),
                        str(gd)], str(gd), timeout=TIMEOUT))
    refs = {name: _jax_gpipe(data["gp"], n, axes, micro)
            for name, (n, axes, micro) in GPIPE_CASES.items()}
    for name in STACK_CASES:
        refs[name] = _jax_steps(jm[name], data["tf"], TF["batch"],
                                STACK_STEPS)
    for name in PCG_CASES:
        refs[name] = _jax_steps(jm[name], data["nu"], NU_BATCH, 1,
                                forward=True)
    refs["search"] = _jax_steps(jm["search"], data["search"], batch, 1)
    yield {"runs": out, "data": data, "jax": jm, "refs": refs}
    pool.shutdown(wait=True)
    mp.undo()


def _assert_weights(got, want, tol, prefix="w", names=None):
    n = 0
    for op, ws in want.items():
        key = op if names is None else names.index(op)
        for name, a in ws.items():
            np.testing.assert_allclose(got[f"{prefix}/{key}/{name}"],
                                       np.asarray(a, np.float32), rtol=tol,
                                       atol=tol, err_msg=f"{op}.{name}")
            n += 1
    assert n > 0


# -- one process ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [2, 3, 4])
def test_balanced_linear_partition_matches_jax(seed, k):
    """The linear-partition DP's cuts on seeded cost lists (ties
    included: integer costs) are JAX's."""
    from flexflow_tpu.parallel.pipeline import balanced_linear_partition as j
    from flexflow_tpu_torch.parallel.pipeline import \
        balanced_linear_partition as t

    rng = np.random.RandomState(seed)
    for n in (k, k + 1, 7, 12):
        costs = [float(c) for c in (rng.randint(1, 5, n) if seed % 2
                                    else rng.rand(n))]
        assert t(costs, k) == j(costs, k), costs


def _block_weights(rng, L, e, h):
    d = e // h
    shapes = {"wq": (L, e, h, d), "wk": (L, e, h, d), "wv": (L, e, h, d),
              "wo": (L, h, d, e), "bias_o": (L, e), "w1": (L, e, e),
              "w2": (L, e, e)}
    return {k: (rng.randn(*s) * 0.3).astype(np.float32)
            for k, s in shapes.items()}


def _grads_both(fn_j, fn_t, w, x):
    """(out, grads) of sum(fn(w, x) ** 2) in JAX and in the port, as
    numpy: grads over every weight and x."""
    wj = {k: jnp.asarray(a) for k, a in w.items()}

    def loss(w_, x_):
        o = fn_j(w_, x_)
        return jnp.sum(o.astype(jnp.float32) ** 2), o

    (_, oj), (gw, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(wj, jnp.asarray(x))
    wt = {k: torch.tensor(a, requires_grad=True) for k, a in w.items()}
    xt = torch.tensor(x, requires_grad=True)
    ot = fn_t(wt, xt)
    gt = torch.autograd.grad((ot.float() ** 2).sum(), [xt] + list(wt.values()))
    jg = {"x": np.asarray(gx), **{k: np.asarray(g) for k, g in gw.items()}}
    tg = {"x": gt[0].numpy(), **{k: g.numpy()
                                for k, g in zip(wt, gt[1:])}}
    return (np.asarray(oj, np.float32), ot.detach().float().numpy(), jg, tg)


def _hold(what, got, want, tol):
    # the gradients of sum(out ** 2) scale with the output: tolerance
    # relative to each array's largest entry
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fn", ["block", "scan"])
def test_encoder_block_and_scan_match_jax(fn, dtype):
    """_encoder_block (one layer) and scan_blocks (3 stacked layers): the
    output and the gradients of sum(out ** 2) for every weight and x,
    against JAX's, in f32 (FWD_TOL, GRAD_TOL) and under bf16 compute
    over f32 weights (BF16_TOL)."""
    from flexflow_tpu.ops.pipeline import _encoder_block as jblock
    from flexflow_tpu.parallel.pipeline import scan_blocks as jscan
    from flexflow_tpu_torch.ops.pipeline import _encoder_block as tblock
    from flexflow_tpu_torch.parallel.pipeline import scan_blocks as tscan

    rng = np.random.RandomState(5)
    L, e, h = 3, 16, 2
    w = _block_weights(rng, L, e, h)
    x = rng.randn(2, 8, e).astype(np.float32)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (None, None))
    jb = functools.partial(jblock, head_dim=e // h, compute_dtype=jd)
    tb = functools.partial(tblock, head_dim=e // h, compute_dtype=td)
    if fn == "block":
        w = {k: a[0] for k, a in w.items()}
        fj, ft = (lambda w_, x_: jb(w_, x_)), (lambda w_, x_: tb(w_, x_))
    else:
        fj = lambda w_, x_: jscan(jb, w_, x_)      # noqa: E731
        ft = lambda w_, x_: tscan(tb, w_, x_)      # noqa: E731
    oj, ot, jg, tg = _grads_both(fj, ft, w, x)
    ftol, gtol = (BF16_TOL, BF16_TOL) if dtype == "bf16" else (FWD_TOL,
                                                                GRAD_TOL)
    _hold("out", ot, oj, ftol)
    for k in jg:
        _hold(f"d{k}", tg[k], jg[k], gtol)


def test_block_stack_one_stage_matches_per_layer_graph():
    """FFModel.transformer_blocks at one stage against the per-layer
    flagship graph (MHA + 2 dense a block) with the stack's weights
    sliced in (`block_stack_layers`), and against JAX's block stack on
    the same weights, within FWD_TOL; one train step's loss and sliced
    weights against the per-layer graph's within GRAD_TOL."""
    rng = np.random.RandomState(2)
    x = rng.randn(TF["batch"], TF["seq"], TF["hidden"]).astype(np.float32)
    y = (x * 0.5).astype(np.float32)
    stack = tff.FFModel(tff.FFConfig(device="cpu", batch_size=TF["batch"]))
    inp = stack.create_tensor((TF["batch"], TF["seq"], TF["hidden"]))
    stack.transformer_blocks(inp, TF["hidden"], TF["heads"], TF["layers"],
                             name="encoder_stack")
    stack.compile(tff.SGDOptimizer(lr=0.05), "mse", [])
    jx = jff.FFModel(_jax_cfg(1, batch_size=TF["batch"]))
    jinp = jx.create_tensor((TF["batch"], TF["seq"], TF["hidden"]),
                            jff.DataType.DT_FLOAT)
    jx.transformer_blocks(jinp, TF["hidden"], TF["heads"], TF["layers"],
                          name="encoder_stack")
    jx.compile(jff.SGDOptimizer(lr=0.05), getattr(jff.LossType, MSE), [])
    params_from_numpy(stack, _jax_params(jx))
    stacked = params_to_numpy(stack)["encoder_stack"]
    per_layer = _torch_model("transformer", TF)
    params_from_numpy(per_layer, block_stack_layers(per_layer, stacked))
    got = stack.executor.build_forward()(stack.params, [x]).numpy()
    want = per_layer.executor.build_forward()(per_layer.params, [x]).numpy()
    jwant = np.asarray(jx.executor.build_forward()(
        jx.state.params, [jnp.asarray(x)]))
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got, jwant, rtol=FWD_TOL, atol=FWD_TOL)
    losses = []
    for m in (stack, per_layer):
        m.state, p = m.executor.build_train_step()(m.state, [x], y, 0)
        losses.append(float(p["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=GRAD_TOL)
    trained = block_stack_layers(per_layer,
                                 params_to_numpy(stack)["encoder_stack"])
    ref = params_to_numpy(per_layer)
    for op, ws in trained.items():
        for n, a in ws.items():
            np.testing.assert_allclose(a, ref[op][n], rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=f"{op}.{n}")


def _plan_summary(plan):
    return {"stages": [[op.name for op in st] for st in plan.stages],
            "cuts": [[tuple(shape) for _, shape, _ in cut]
                     for cut in plan.cuts],
            "buf_elems": plan.buf_elems, "n_stages": plan.n_stages,
            "out_shape": tuple(plan.out_shape)}


@pytest.mark.parametrize("oracle", ["default_machine", "machine_file"])
@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_plan_matches_jax(tmp_path, oracle, n_stages):
    """_plan_pcg_pipeline on tests/test_pipeline.py's non-uniform CNN:
    the stages' op order, the cuts' shapes and buf_elems are JAX's, with
    the default machine's analytic costs and with the cost model of one
    machine file."""
    jm = _jax_nonuniform(1, 1)
    tm = _torch_model("nonuniform", {"batch": NU_BATCH})
    if oracle == "machine_file":
        path = _machine_file(tmp_path, 1)
        jm.config.machine_model_file = tm.config.machine_model_file = path
        jm.executor._plan_cost_model = jm._build_cost_model()
        tm.executor._plan_cost_model = tm._build_cost_model()
    else:
        jm.executor._plan_cost_model = tm.executor._plan_cost_model = None
    want = _plan_summary(jm.executor._plan_pcg_pipeline(n_stages))
    got = _plan_summary(tm.executor._plan_pcg_pipeline(n_stages))
    assert got == want


def _refusal_model(pkg, kind):
    A, D = pkg.ActiMode, pkg.DataType
    b = NU_BATCH
    cfg = (tff.FFConfig(device="cpu", batch_size=b) if pkg is tff
           else _jax_cfg(1, batch_size=b))
    m = pkg.FFModel(cfg)
    if kind == "fewer_ops":
        m.dense(m.create_tensor((b, 16), D.DT_FLOAT), 4)
    elif kind == "stateful":
        x = m.create_tensor((b, 3, 8, 8), D.DT_FLOAT)
        t = m.batch_norm(m.conv2d(x, 8, 3, 3, 1, 1, 1, 1))
        m.dense(m.flat(t), 4)
    elif kind == "late_input":
        x = m.create_tensor((b, 16), D.DT_FLOAT)
        x2 = m.create_tensor((b, 16), D.DT_FLOAT)
        t = m.dense(m.dense(m.dense(x, 16), 16), 16)
        m.add(t, x2)
    elif kind == "not_batch_leading":
        t = m.transpose(m.create_tensor((b, 16), D.DT_FLOAT), (1, 0))
        m.dense(m.dense(m.dense(t, 32), 32), 32)
    else:
        t = m.dense(m.create_tensor((b, 64), D.DT_FLOAT), 64)
        v, i = m.top_k(t, 2, False)
        t = m.dense(m.dense(m.dense(m.dense(v, 64), 64), 64), 2,
                    A.AC_MODE_NONE)
        m.add(t, m.cast(i, D.DT_FLOAT))
    m.compile(pkg.SGDOptimizer(lr=0.01), getattr(pkg.LossType, MSE), [])
    return m


@pytest.mark.parametrize("kind,reason", [
    ("fewer_ops", "fewer compute ops than stages"),
    ("stateful", "OP_BATCHNORM (stateful/aux-loss op)"),
    ("late_input", "a graph input is consumed past stage 0"),
    ("not_batch_leading", "a cut tensor is not batch-leading"),
    ("non_float", "non-float cut tensor")])
def test_plan_refusals_warn_as_jax(kind, reason):
    """Each of JAX's "running unpipelined" cases: no plan, and JAX's
    warning, word for word."""
    said = {}
    for pkg in (jff, tff):
        m = _refusal_model(pkg, kind)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            assert m.executor._plan_pcg_pipeline(2) is None
        said[pkg.__name__] = [str(w.message) for w in rec
                              if "pipeline:" in str(w.message)]
    assert said["flexflow_tpu_torch"] == said["flexflow_tpu"]
    (msg,) = said["flexflow_tpu"]
    assert reason in msg and msg.endswith("running unpipelined")


def test_seq_length_refused_under_a_plan():
    """A per-iteration seq_length changes the cut tensors' shapes: under a
    stage plan `apply` refuses it, as JAX's does, with JAX's message."""
    said = []
    for pkg in (jff, tff):
        m = (_jax_nonuniform(1, 1) if pkg is jff
             else _torch_model("nonuniform", {"batch": NU_BATCH}))
        ex = m.executor
        ex.pipeline_plan = ex._plan_pcg_pipeline(2)
        assert ex.pipeline_plan is not None
        with pytest.raises(NotImplementedError) as e:
            ex.apply(m.state.params, {}, training=False, rng=None,
                     seq_length=4)
        said.append(str(e.value))
    assert said[0] == said[1] and "seq_length" in said[0]


def test_seed_table_folds_the_tick():
    """Under a schedule of T ticks each (op, tick) has its own seeds,
    dropout_seeds(fold_in(fold_in(step, op), tick)), JAX's fold of the
    tick into the op's key; one tick is the unpipelined table."""
    from flexflow_tpu_torch.core.seeds import as_int32, fold_in, seed_table
    from flexflow_tpu_torch.kernels.attention import dropout_seeds

    plain = seed_table([11, 12], [1, 3], 4)
    ticked = seed_table([11, 12], [1, 3], 4, ticks=3)
    assert ticked.shape == (2, 12, 2)
    for j, s in enumerate((11, 12)):
        for i in (1, 3):
            want = [[as_int32(int(v)) for v in dropout_seeds(
                fold_in(fold_in(s, i), t))] for t in range(3)]
            assert ticked[j, i * 3:i * 3 + 3].tolist() == want
        assert ticked[j, 0:3].abs().sum() == 0
    assert len({tuple(r) for r in ticked[0, 3:6].tolist()}) == 3
    np.testing.assert_array_equal(plain[:, [1, 3]].numpy(),
                                  seed_table([11, 12], [1, 3], 4)[
                                      :, [1, 3]].numpy())


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_pipeline_decision_matches_jax(tmp_path, monkeypatch, case):
    """_search_pipeline_degree at 4 devices, JAX's `workersPerNode` 4 and
    the port's live device count 4: an overflowing dense stack adopts a
    pipe axis (data x pipe = 4), a stack a tensor-parallel winner fits is
    re-searched onto it instead, and ample memory keeps the winner; the
    adopted axes and degree are JAX's."""
    (layers, width, batch, mem), kind = SEARCH_CASES[case]
    machine = _machine_file(tmp_path)
    jm = _jax_budgeted(SEARCH_WORKERS, layers, width, batch, mem, machine)
    monkeypatch.setattr(tff.FFModel, "_live_device_count",
                        lambda self: SEARCH_WORKERS)
    tm = tff.FFModel(tff.FFConfig(device="cpu", batch_size=batch,
                                  search_budget=2, device_mem=mem << 20,
                                  machine_model_file=machine))
    _build(tm, "budgeted", {"layers": layers, "width": width,
                            "batch": batch})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm.compile(tff.SGDOptimizer(lr=0.01), SPARSE, [])
    want = {k: int(v) for k, v in jm.executor.mesh.shape.items() if v > 1}
    got = {k: v for k, v in tm.mesh_axes.items() if v > 1}
    assert got == want
    assert tm.searched_pipeline_degree == getattr(
        jm, "searched_pipeline_degree", 1)
    (ev,) = tm.search_trajectory.of_kind("pipeline_search")
    assert ev["degree"] == tm.searched_pipeline_degree
    if kind is None:
        assert got.get("pipe", 1) == 1 and not ev["replaced_by_researched"]
    else:
        assert got.get(kind, 1) > 1, got
        assert ev["replaced_by_researched"] == (kind == "model")


# -- gloo ranks ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GPIPE_CASES))
def test_gpipe_matches_jax(runs, name):
    """gpipe_mesh (each rank's gpipe_spmd through local_map, the hops
    ring shifts round the pipe group) at pipe 2 and data 2 x pipe
    2: the output (FWD_TOL) and the gradients of every weight and x
    (GRAD_TOL) against JAX's gpipe_spmd under shard_map on a mesh of the
    same shape: not scaled by the pipe degree. Each rank holds its
    stage's layers."""
    n, axes, _ = GPIPE_CASES[name]
    run = runs["runs"][n]
    outs = run.ok(name)
    assert {o["local_rows"] for o in outs} == {GP[0] // axes["pipe"]}
    got, want = run.arrays(name), runs["refs"][name]
    assert set(got) == set(want)
    _hold("out", got["out"], want["out"], FWD_TOL)
    for k in want:
        if k != "out":
            _hold(k, got[k], want[k], GRAD_TOL)


@pytest.mark.parametrize("name", sorted(STACK_CASES))
def test_block_stack_trains_as_jax(runs, name):
    """The block-stack model through the GPipe schedule (pp 2 with 4
    micro-batches on 2 ranks; pp 4 with the default, one a stage, on 4),
    and at pp 1 on a data-parallel mesh of 2 (each rank every layer on
    its batch shard): 3 train steps' losses and the weights after them
    against JAX's run of the same mesh from the same weights (GRAD_TOL);
    the stacked layers Shard(0) over "pipe"; the data replicas' shards
    equal."""
    n, pp, _ = STACK_CASES[name]
    run = runs["runs"][n]
    outs = run.ok(name)
    out = outs[0]
    assert {k: v for k, v in out["mesh"].items() if v > 1} == {
        k: v for k, v in (("data", n // pp), ("pipe", pp)) if v > 1}
    if pp > 1:
        assert out["weight_placements"]["encoder_stack/wq"][-1] == "S(0)"
    assert out["local_shapes"]["encoder_stack/wq"][0] == TF["layers"] // pp
    assert len(set(o["weight_digest"] for o in outs)) == pp
    losses, _, want = runs["refs"][name]
    np.testing.assert_allclose(out["losses"], losses, rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    _assert_weights(run.arrays(name), want, GRAD_TOL)


@pytest.mark.parametrize("name", sorted(PCG_CASES))
def test_nonuniform_pipeline_trains_as_jax(runs, name):
    """tests/test_pipeline.py's non-uniform CNN through gpipe_pcg (the
    stage plan of 2, each rank its stage's ops, the cut in one f32
    buffer): one train step's loss and weights against JAX's on a mesh of
    the same shape from the same weights (NU_TOL); every weight
    replicated over "pipe", its gradient summed over data and pipe, so
    every rank holds the same weights after the step."""
    n = PCG_CASES[name]
    run = runs["runs"][n]
    outs = run.ok(name)
    out = outs[0]
    jm = runs["jax"][name]
    assert out["pipeline_stages"] == [[op.name for op in st] for st in
                                      jm.executor.pipeline_plan.stages]
    assert len({o["weight_digest"] for o in outs}) == 1
    coll = out["collectives"]
    assert sum(v for k, v in coll.items()
               if k.startswith("grad/") and k.endswith("/pipe")) > 0
    if n == 4:
        assert any(k.startswith("grad/") and k.endswith("/data")
                   for k in coll)
    losses, _, want = runs["refs"][name]
    np.testing.assert_allclose(out["losses"], losses, rtol=NU_TOL,
                               atol=NU_TOL)
    _assert_weights(run.arrays(name), want, NU_TOL)


def test_nonuniform_pipeline_forward_matches_jax(runs):
    """The non-uniform CNN's forward through gpipe_pcg at pp 2 against
    JAX's pipelined forward from the same weights (NU_TOL), and against
    the port's one-device forward."""
    run = runs["runs"][2]
    run.ok("pcg_pp2_fwd")
    got = run.arrays("pcg_pp2_fwd")["f/out"]
    _, fwd, _ = runs["refs"]["pcg_pp2"]
    np.testing.assert_allclose(got, fwd, rtol=NU_TOL, atol=NU_TOL)
    one = _torch_model("nonuniform", {"batch": NU_BATCH})
    assert one.executor.pipeline_plan is None
    params_from_numpy(one, _jax_params(runs["jax"]["pcg_pp2"]))
    want = one.executor.build_forward()(one.params,
                                        [runs["data"]["nu"]["x0"]]).numpy()
    np.testing.assert_allclose(got, want, rtol=NU_TOL, atol=NU_TOL)


def test_verify_strategy_runs_a_pipelined_strategy(runs):
    """verify_strategy on the non-uniform CNN at pp 2: two steps of the
    pipelined strategy against the serial reference agree, and no op is
    probed (find_first_divergence returns None under a plan)."""
    outs = runs["runs"][2].ok("pcg_pp2_verify")
    v = outs[0]["verdict"]
    assert v["ok"] and v["steps"] == 2, v
    assert v["diverging_op"] is None and len(v["loss_diffs"]) == 2


def test_search_winner_executes_as_jax(runs):
    """The overflowing dense stack searched on 4 ranks adopts JAX's pipe
    axis and runs it through the generalized plan (it raised before):
    one train step's loss and weights against JAX's pipelined step from
    the same weights (NU_TOL), weights matched by position among the
    weighted ops."""
    outs = runs["runs"][4].ok("search_overflow")
    out = outs[0]
    jm = runs["jax"]["search"]
    assert {k: v for k, v in out["mesh"].items() if v > 1} == {
        k: int(v) for k, v in jm.executor.mesh.shape.items() if v > 1}
    assert out["searched_pipeline_degree"] == jm.searched_pipeline_degree > 1
    assert out["pipeline_stages"] is not None
    losses, _, want = runs["refs"]["search"]
    np.testing.assert_allclose(out["losses"], losses, rtol=NU_TOL,
                               atol=NU_TOL)
    _assert_weights(runs["runs"][4].arrays("search_overflow"), want, NU_TOL,
                    prefix="p", names=_weighted(jm))


def test_scan_over_a_pipe_axis(runs):
    """fit with iterations_per_dispatch 3 on the block stack at pp 2 (the
    train scan over the mesh: on a card one CUDA graph holding the hops,
    on gloo its loop) is bit-equal to the stepwise fit on the same
    mesh."""
    run = runs["runs"][2]
    run.ok(f"stack_pp2_fit{STACK_STEPS}")
    run.ok("stack_pp2_fit1")
    a = run.arrays(f"stack_pp2_fit{STACK_STEPS}")
    b = run.arrays("stack_pp2_fit1")
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_dropout_draws_per_tick_in_the_generalized_pipeline(runs):
    """A Dropout op in a stage-partitioned graph at pp 2: the seed table
    holds a seed an (op, tick), 3 ticks (2 micro-batches + 1), and two
    steps run with both ranks holding the same weights."""
    outs = runs["runs"][2].ok("pcg_dropout")
    assert outs[0]["pipeline_stages"] is not None
    assert outs[0]["pipe_ticks"] == 3
    assert np.all(np.isfinite(outs[0]["losses"]))
    assert len({o["weight_digest"] for o in outs}) == 1


def test_hybrid_mesh_axis_order(runs):
    """build_hybrid_mesh({"pipe": 2}, {"data": 2}) on 4 ranks: the DCN
    axes lead, as JAX's fallback lays them out on CPU devices."""
    from flexflow_tpu.parallel.mesh import build_hybrid_mesh

    outs = runs["runs"][4].ok("hybrid")
    jmesh = build_hybrid_mesh({"pipe": 2}, {"data": 2}, jax.devices()[:4])
    for r, o in enumerate(outs):
        assert o["axis_names"] == list(jmesh.axis_names) == ["data", "pipe"]
        assert o["shape"] == {k: int(v) for k, v in jmesh.shape.items()}
        assert o["coordinate"] == list(np.unravel_index(r, (2, 2)))
