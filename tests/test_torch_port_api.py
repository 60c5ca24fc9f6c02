"""The port's last API spellings and four repairs against the JAX package.

Repairs (each failed before it): `conv2d` takes any integral `groups` as
JAX's feature_group_count does (the reference scripts pass use_bias's
True there); `FFConfig.bf16_grads` decides the gradient dtype by JAX's
rule (None follows mixed precision); `search_survivability_penalty`
reaches the cost model as in JAX; `export_strategy_computation_graph_file`
receives the searched graph in DOT form after a search.

Tolerances: the CNN tests' (losses rtol 1e-5, weights rtol 1e-4 and
atol 1e-5: f32 sums in other orders, XLA's convolutions against
oneDNN's); under bf16 compute, the mixed-precision tests' four bf16
steps (rtol 2^-5) plus 2^-8 of the largest value of the array compared
(the bf16 products round at other places in the two frameworks), a
weight's move over two steps held to both steps' bounds added, plus an
f32 ulp of the weight a step (each package rounds each update).

Spellings: FFIterationConfig, InitializerType and MAX_TENSOR_DIM,
Optimizer.next, FFModel.optimizer_setter, the Keras GlorotUniform's
seed, the ops registry's op types, one ServingConfigError, the package
exports, HAS_ONNX and reset_attention_fallback_warnings, each against
JAX's. The port leaves out spellings that neither package reads and no
script sets: the core GlorotUniformInitializer's `seed` and the ops'
`seq_pointwise` declarations.
"""
import importlib
import re

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu import ff_types as jtypes
from flexflow_tpu.models.transformer import build_transformer as jbuild
from flexflow_tpu.search import cost_model as jcm
import flexflow_tpu_torch as tff
from flexflow_tpu_torch import ff_types as ttypes
from flexflow_tpu_torch.models import build_transformer
from flexflow_tpu_torch.runtime.weights import params_from_numpy

RTOL, W_RTOL, W_ATOL = 1e-5, 1e-4, 1e-5
BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -5, 2.0 ** -8
SPARSE = "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY"
MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"


def _np(tree):
    """A copy (the port updates its weights in place)."""
    return {op: {n: np.array(a, np.float32) for n, a in ws.items()}
            for op, ws in tree.items()}


def _jcfg(**kw):
    cfg = jff.FFConfig()
    cfg.workersPerNode = 1
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _assert_tree_close(ttree, jtree, what, **tol):
    j = _np(jtree)
    assert set(ttree) == set(j), what
    for op, ws in ttree.items():
        assert set(ws) == set(j[op]), f"{what} {op}"
        for n, w in ws.items():
            np.testing.assert_allclose(w.float().numpy(), j[op][n],
                                       err_msg=f"{what} {op}.{n}", **tol)


# -- repair (a): conv2d(groups=True) -----------------------------------------

def _two_convs(pkg, m, batch):
    x = m.create_tensor([batch, 1, 12, 12], pkg.DataType.DT_FLOAT)
    # the reference MNIST CNN's call: activation, then True for groups
    t = m.conv2d(x, 4, 3, 3, 1, 1, 1, 1, pkg.ActiMode.AC_MODE_RELU, True)
    t = m.conv2d(t, 8, 3, 3, 1, 1, 1, 1, pkg.ActiMode.AC_MODE_RELU, True)
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = m.flat(t)
    t = m.dense(t, 10)
    m.softmax(t)


def test_conv2d_groups_true_trains_like_jax():
    """A 2-conv model built with groups=True: one SGD step's loss and
    accuracy partials, then every weight, against JAX's from the same
    weights."""
    batch = 8
    jm = jff.FFModel(_jcfg(batch_size=batch))
    _two_convs(jff, jm, batch)
    jm.compile(jff.SGDOptimizer(lr=0.05), getattr(jff.LossType, SPARSE),
               [jff.MetricsType.METRICS_ACCURACY])
    tm = tff.FFModel(tff.FFConfig(batch_size=batch, device="cpu"))
    _two_convs(tff, tm, batch)
    tm.compile(tff.SGDOptimizer(lr=0.05), getattr(tff.LossType, SPARSE),
               [tff.MetricsType.METRICS_ACCURACY])
    assert [op.params.groups for op in tm.graph.ops
            if op.op_type == tff.OperatorType.OP_CONV2D] == [1, 1]
    params_from_numpy(tm, _np(jm.state.params))
    rng = np.random.RandomState(0)
    x = rng.randn(batch, 1, 12, 12).astype(np.float32)
    y = rng.randint(0, 10, (batch, 1)).astype(np.int32)
    jst, jp = jm.executor.build_train_step()(jm.state, [x], y,
                                              jax.random.PRNGKey(0))
    tst, tp = tm.executor.build_train_step()(tm.state, [x], y)
    assert set(tp) == set(jp)
    for k in tp:
        np.testing.assert_allclose(float(tp[k]), float(jp[k]), rtol=RTOL,
                                   err_msg=k)
    _assert_tree_close(tst.params, jst.params, "groups=True",
                       rtol=W_RTOL, atol=W_ATOL)


def test_conv2d_groups_must_be_integral():
    m = tff.FFModel(tff.FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor([2, 4, 8, 8], tff.DataType.DT_FLOAT)
    with pytest.raises(TypeError):
        m.conv2d(x, 4, 3, 3, 1, 1, 1, 1, groups=2.0)
    t = m.conv2d(x, 4, 3, 3, 1, 1, 1, 1, groups=np.int64(2))
    assert type(m.layers[-1].params.groups) is int
    assert tuple(t.dims) == (2, 4, 8, 8)


# -- repair (b): bf16_grads -----------------------------------------------------

BATCH, SEQ, HIDDEN, HEADS, LAYERS = 2, 16, 32, 4, 2


def _flagship_pair(mixed, bf16_grads):
    jm = jff.FFModel(_jcfg(batch_size=BATCH, allow_mixed_precision=mixed,
                           bf16_grads=bf16_grads))
    jbuild(jm, BATCH, SEQ, HIDDEN, HEADS, LAYERS)
    jm.compile(jff.SGDOptimizer(lr=0.01), getattr(jff.LossType, MSE))
    tm = _port_flagship(mixed, bf16_grads)
    params_from_numpy(tm, _np(jm.state.params))
    return jm, tm


def _port_flagship(mixed, bf16_grads):
    tm = tff.FFModel(tff.FFConfig(batch_size=BATCH, device="cpu",
                                  allow_mixed_precision=mixed,
                                  bf16_grads=bf16_grads))
    build_transformer(tm, BATCH, SEQ, HIDDEN, HEADS, LAYERS)
    tm.compile(tff.SGDOptimizer(lr=0.01), getattr(tff.LossType, MSE))
    return tm


def _batches(seed, n=2):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, SEQ, HIDDEN).astype(np.float32),
             rng.randn(BATCH, SEQ, HIDDEN).astype(np.float32))
            for _ in range(n)]


def _bf16_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                               atol=BF16_ATOL_SHARE * np.abs(want).max(),
                               err_msg=what)


def test_bf16_grads_false_keeps_f32_gradients_like_jax():
    """Mixed precision with bf16_grads=False: the gradients stay f32 in
    both packages (grad step and executor), and after two SGD steps each
    weight's move from the shared start agrees with JAX's within the
    bf16 tolerance."""
    jm, tm = _flagship_pair(True, False)
    assert tm.executor.grad_dtype is None and jm.executor.grad_dtype is None
    assert tm._grad_bytes_ratio() == jm._grad_bytes_ratio() == 1.0
    (x, y), _ = _batches(3)
    jg, _ = jm.executor.build_grad_step()(jm.state.params, [x], y)
    tg = tm.executor.build_grad_step()(tm.params, [x], y)
    for op, gs in tg.items():
        for n, g in gs.items():
            assert g.dtype == torch.float32 and jg[op][n].dtype == "float32"
            _bf16_close(g.numpy(), np.asarray(jg[op][n]), f"grad {op}.{n}")
    # the moves from the shared start after one and after two steps. Each
    # step's move agrees within that step's bf16 tolerance, and the two
    # steps' tolerances add (rtol on |move 1| + |move 2|, so an element
    # whose moves cancel keeps its per-step bound); each step also
    # rounds the updated f32 weight, by up to half an ulp in each package
    jstep, tstep = jm.executor.build_train_step(), tm.executor.build_train_step()
    jst, tst = jm.state, tm.state
    jw, tw = [_np(jst.params)], [_np(tst.params)]
    for x, y in _batches(4):
        jst, _ = jstep(jst, [x], y, jax.random.PRNGKey(0))
        tst, _ = tstep(tst, [x], y)
        jw.append(_np(jst.params))
        tw.append(_np(tst.params))
    for op, ws in tst.params.items():
        for n, w in ws.items():
            assert w.dtype == torch.float32
            moves = [jw[i + 1][op][n] - jw[i][op][n] for i in (0, 1)]
            ulp = np.spacing(np.maximum.reduce(
                [np.abs(jw[i][op][n]) for i in (0, 1, 2)]))
            for k in (1, 2):
                bound = sum(BF16_RTOL * np.abs(m)
                            + BF16_ATOL_SHARE * np.abs(m).max()
                            for m in moves[:k]) + k * ulp
                gap = np.abs((tw[k][op][n] - tw[0][op][n]) - sum(moves[:k]))
                assert np.all(gap <= bound), (
                    f"{op}.{n} after {k} step(s): gap {gap.max():.3g}, "
                    f"worst excess {(gap - bound).max():.3g}")


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "f32"])
def test_bf16_grads_none_follows_mixed_precision_bit_for_bit(mixed):
    """None takes mixed precision's choice, which is what the port
    hard-wired before the field: two steps with None are bit-equal to
    two with the explicit value, through the executor, the precision
    lint and the tuner's candidate executor."""
    from flexflow_tpu_torch.runtime.tuner import StrategyTuner

    models = {v: _port_flagship(mixed, v) for v in (None, mixed)}
    weights = _np(models[None].params)
    for m in models.values():
        params_from_numpy(m, weights)
        step, st = m.executor.build_train_step(), m.state
        for x, y in _batches(5):
            st, _ = step(st, [x], y)
        cand, _ = StrategyTuner(m)._build_candidate_executor(
            m.graph, m._build_cost_model())
        want = torch.bfloat16 if mixed else None
        assert m.executor.grad_dtype is cand.grad_dtype is want
    for op, ws in models[None].params.items():
        for n, w in ws.items():
            assert torch.equal(w, models[mixed].params[op][n]), f"{op}.{n}"


@pytest.mark.parametrize("mixed,bf16_grads", [(True, None), (True, False),
                                              (False, True)])
def test_precision_lint_sees_the_gradient_dtype_jax_sees(monkeypatch, mixed,
                                                         bf16_grads):
    from flexflow_tpu.analysis import precision as jprec
    from flexflow_tpu_torch.analysis import precision as tprec

    seen = {}
    for name, mod in (("jax", jprec), ("port", tprec)):
        real = mod.precision_diagnostics

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name] = kw.get("grad_dtype")
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "precision_diagnostics", spy)
    jm, tm = _flagship_pair(mixed, bf16_grads)
    assert (seen["port"] is None) == (seen["jax"] is None)
    if seen["port"] is not None:
        assert seen["port"].name == seen["jax"].name == "DT_BF16"
    assert tm._grad_bytes_ratio() == jm._grad_bytes_ratio()
    assert (tm.executor.grad_dtype is None) == (jm.executor.grad_dtype is None)


# -- repair (c): search_survivability_penalty ---------------------------------

@pytest.mark.parametrize("nodes", [1, 2])
@pytest.mark.parametrize("penalty", [-1.0, 0.0, 1.0])
def test_survivability_penalty_reaches_the_cost_model_as_in_jax(
        monkeypatch, nodes, penalty):
    monkeypatch.setattr(jcm, "load_default_calibration", lambda: None)
    jm = jff.FFModel(_jcfg(numNodes=nodes,
                           search_survivability_penalty=penalty))
    tm = tff.FFModel(tff.FFConfig(device="cpu", numNodes=nodes,
                                  search_survivability_penalty=penalty))
    got = tm._build_cost_model().survivability_penalty
    assert got == jm._build_cost_model().survivability_penalty
    assert got == (penalty if penalty >= 0 else (0.25 if nodes > 1 else 0.0))


# -- repair (d): export_strategy_computation_graph_file -----------------------

def _dot_structure(text):
    """(nodes, edges by topological position) of an export_dot file: the
    nodes are listed in the graph's op order, so an edge is a pair of
    positions whatever the ops are named."""
    nodes = re.findall(r"^\s*n(\d+) \[label=", text, re.M)
    pos = {g: i for i, g in enumerate(nodes)}
    edges = [(pos[a], pos[b])
             for a, b in re.findall(r"^\s*n(\d+) -> n(\d+);", text, re.M)]
    return len(nodes), sorted(edges)


def test_searched_graph_dot_file_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jcm, "load_default_calibration", lambda: None)
    machine = tmp_path / "machine.cfg"
    machine.write_text("num_nodes = 1\nnum_gpus_per_node = 4\n"
                       "intra_node_bandwidth = 90e9\n"
                       "inter_node_bandwidth = 25e9\n")
    out = {}
    for name, pkg, cfg in (
            ("jax", jff, _jcfg(batch_size=8)),
            ("port", tff, tff.FFConfig(device="cpu", batch_size=8))):
        cfg.search_budget = 4
        cfg.machine_model_file = str(machine)
        cfg.export_strategy_computation_graph_file = str(tmp_path / name)
        m = pkg.FFModel(cfg)
        (jbuild if pkg is jff else build_transformer)(m, 8, 64, 128, 8, 2)
        m.compile(pkg.SGDOptimizer(lr=0.01), getattr(pkg.LossType, MSE))
        out[name] = _dot_structure((tmp_path / name).read_text())
    assert out["port"] == out["jax"]
    assert out["port"][0] > 0 and out["port"][1]


def test_no_dot_file_without_a_search(tmp_path):
    path = tmp_path / "graph.dot"
    m = tff.FFModel(tff.FFConfig(
        device="cpu", batch_size=2,
        export_strategy_computation_graph_file=str(path)))
    build_transformer(m, 2, 16, 32, 4, 1)
    m.compile(tff.SGDOptimizer(lr=0.01), getattr(tff.LossType, MSE))
    assert not path.exists()


# -- the spellings ----------------------------------------------------------------

def test_types_and_iteration_config_match_jax():
    assert ttypes.MAX_TENSOR_DIM == jtypes.MAX_TENSOR_DIM
    from flexflow_tpu_torch.pcg.parallel_tensor import MAX_TENSOR_DIM
    assert MAX_TENSOR_DIM == ttypes.MAX_TENSOR_DIM
    assert {e.name: e.value for e in ttypes.InitializerType} == \
        {e.name: e.value for e in jtypes.InitializerType}
    t, j = tff.FFIterationConfig(), jff.FFIterationConfig()
    assert t.seq_length == j.seq_length == -1
    t.seq_length = j.seq_length = 7
    t.reset()
    j.reset()
    assert t.seq_length == j.seq_length == -1
    from flexflow_tpu_torch import config
    assert config.FFIterationConfig is ttypes.FFIterationConfig


def test_optimizer_next_setter_and_glorot_seed():
    for pkg in (jff, tff):
        opt = pkg.SGDOptimizer(lr=0.5)
        state = object()
        assert opt.next(state) is state
        assert pkg.AdamOptimizer().next(state) is state
        # the Keras spelling keeps its seed (compat/seq_mnist_mlp.py
        # passes one); the executor's generator decides the draws
        glorot = importlib.import_module(
            pkg.__name__ + ".frontends.keras.initializers").GlorotUniform
        assert glorot(12).seed == 12 and glorot().seed == 0
    with pytest.raises(TypeError):
        tff.GlorotUniformInitializer(seed=7)
    m = tff.FFModel(tff.FFConfig(device="cpu"))
    opt = tff.SGDOptimizer(lr=0.25)
    m.optimizer_setter(opt)
    assert m.optimizer is opt
    assert tff.FFModel.optimizer_setter is tff.FFModel.set_optimizer
    assert jff.FFModel.optimizer_setter is jff.FFModel.set_optimizer


def test_ops_registry_holds_every_jax_op_type():
    """The port registers each op type JAX's registry holds, and the
    parallel ops its executor runs besides."""
    from flexflow_tpu import ops as jops
    from flexflow_tpu_torch import ops as tops
    j, t = set(jops.all_op_types()), set(tops.all_op_types())
    assert j <= t
    assert {o.name for o in t - j} == {
        "OP_ALL_TO_ALL", "OP_COMBINE", "OP_FUSED_PARALLEL", "OP_REDUCTION",
        "OP_REPARTITION", "OP_REPLICATE", "OP_WEIGHT_SHARD"}
    assert all(tops.has_op_def(o) for o in t)


def test_serving_config_error_is_one_class():
    from flexflow_tpu_torch import runtime
    from flexflow_tpu_torch.runtime import serving, verify
    assert (serving.ServingConfigError is verify.ServingConfigError
            is runtime.ServingConfigError is tff.ServingConfigError)
    assert issubclass(tff.ServingConfigError, ValueError)
    with pytest.raises(verify.ServingConfigError, match="max_len"):
        serving.ServingConfig(max_len=1)


def _names(mod):
    import types
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)
            and getattr(getattr(mod, n), "__module__", None) != "typing"}


@pytest.mark.parametrize("sub", ["", ".runtime", ".obs", ".ops",
                                 ".frontends.onnx"])
def test_package_exports_cover_jax(sub):
    import importlib
    j = importlib.import_module("flexflow_tpu" + sub)
    t = importlib.import_module("flexflow_tpu_torch" + sub)
    assert _names(j) <= _names(t)


def test_has_onnx_and_fallback_warning_reset():
    import importlib.util
    from flexflow_tpu.frontends import onnx as jonnx
    from flexflow_tpu_torch.frontends import onnx as tonnx
    from flexflow_tpu_torch.ops import attention as tattn
    assert tonnx.HAS_ONNX == jonnx.HAS_ONNX == (
        importlib.util.find_spec("onnx") is not None)
    tattn._FALLBACK_WARNED.add(("dense", "op", "kernel"))
    tattn.reset_attention_fallback_warnings()
    assert not tattn._FALLBACK_WARNED
