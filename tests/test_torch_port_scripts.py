"""The repo's example scripts on the port, unedited, through its script
runner (flexflow_tpu_torch/run.py), and the `flexflow` drop-in namespace
of the port (flexflow_tpu_torch/flexflow/) against the repo's flexflow/.

The surface: each of the 26 modules of flexflow/ has a twin under
flexflow_tpu_torch.flexflow with the same public names (modules, typing
helpers and `from __future__` features aside) and the same signature
for each callable name, each method of a class the shim defines
included; FFConfig has every dataclass field of JAX's with JAX's
default (the worker and node counts and the port's own `device` aside:
JAX counts the devices it sees, the port its processes) but nine that
neither package reads, which the port refuses, the same argv gives the
same fields and accessor values, the enums agree through flexflow.type's helpers, the
reference-style `SGDOptimizer(ffmodel, lr)` works in both conventions,
and the Keras datasets give both packages the same arrays.

The scripts: one subprocess, `python -m flexflow_tpu_torch.run --device
cpu`, runs a batch script that runs the scripts one after another through
tests/_example_runner.py (each in its own working directory under
tmp_path, so their .ff/.onnx exports stay out of the repo), then
reports which modules the process loaded: no jax, nothing of the JAX
package or of the repo's flexflow/, every `flexflow*` name a port
module, the port modules' own names and specs. It then hides any card
from itself, asks for one, and reports the RuntimeError.
"""
import __future__
import dataclasses
import importlib
import inspect
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu_torch import run

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "python"
# JAX's example tests' argv (tests/test_frontend_examples.py)
SMALL = ["--epochs", "1", "--num-samples", "96", "--batch-size", "32"]

MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).replace(
        ".__init__", "")
    for p in (REPO / "flexflow").rglob("*.py"))


def _public(mod):
    out = set()
    for n in dir(mod):
        v = getattr(mod, n)
        if (n.startswith("_")
                or isinstance(v, (types.ModuleType, __future__._Feature))
                or getattr(v, "__module__", None) == "typing"):
            continue
        out.add(n)
    return out


def _signature(v):
    try:
        return str(inspect.signature(v))
    except (TypeError, ValueError):
        return None


# callables whose signature is each package's own: FFConfig's fields are
# held one by one below (the port adds `device`, orders its fields by
# use and refuses nine); the port's core GlorotUniformInitializer takes
# no `seed`, which JAX's keeps and reads nowhere
_OWN_SIGNATURE = {"FFConfig", "GlorotUniformInitializer"}


def test_the_namespace_has_every_module():
    assert len(MODULES) == 26
    port = sorted(
        ".".join(p.relative_to(REPO / "flexflow_tpu_torch").with_suffix(
            "").parts).replace(".__init__", "")
        for p in (REPO / "flexflow_tpu_torch" / "flexflow").rglob("*.py"))
    assert port == MODULES


@pytest.mark.parametrize("name", MODULES)
def test_module_exports_the_same_names(name):
    j = importlib.import_module(name)
    t = importlib.import_module("flexflow_tpu_torch." + name)
    assert _public(t) == _public(j)
    for n in _public(t):
        v, w = getattr(t, n), getattr(j, n)
        mod = getattr(v, "__module__", "") or ""
        assert not mod.startswith(("flexflow_tpu.", "jax")), (n, mod)
        if callable(v) and n not in _OWN_SIGNATURE:
            assert _signature(v) == _signature(w), n
        # a class the shim itself defines: each of its own methods too
        if isinstance(w, type) and w.__module__.startswith("flexflow."):
            assert sorted(vars(v)) == sorted(vars(w)), n
            for m, f in vars(w).items():
                f = f.fget if isinstance(f, property) else f
                if callable(f):
                    g = vars(v)[m]
                    g = g.fget if isinstance(g, property) else g
                    assert _signature(g) == _signature(f), (n, m)


# -- FFConfig ------------------------------------------------------------------

_OWN = {"workersPerNode", "numNodes"}
# JAX fields the port refuses (setting one raises AttributeError): the
# reference config's, which neither package reads and no script sets
_REFUSED = {
    "computationMode": "Legion's training/inference mode",
    "enable_sample_parallel": "a substitution switch of the reference",
    "enable_inplace_optimizations": "Legion's in-place op fusion",
    "base_optimize_threshold": "the reference graph optimizer's threshold",
    "enable_control_replication": "Legion's control replication",
    "python_data_loader_type": "the reference's Python loader kind",
    "simulator_segment_size": "the reference simulator's segment bytes",
    "simulator_max_num_segments": "the reference simulator's segments",
    "enable_propagation": "the reference search's propagation pass",
}
_JAX_FIELDS = [f.name for f in dataclasses.fields(jff.FFConfig)
               if f.name not in _OWN | set(_REFUSED)]


@pytest.fixture
def clean_argv(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"])


@pytest.mark.parametrize("field", _JAX_FIELDS)
def test_config_field_has_jax_default(field, clean_argv):
    t, j = tff.FFConfig(device="cpu"), jff.FFConfig()
    assert getattr(t, field) == getattr(j, field)
    # the same type, each package's own where it is an enum
    assert type(getattr(t, field)).__name__ == type(getattr(j, field)).__name__


@pytest.mark.parametrize("field", sorted(_REFUSED))
def test_config_refuses_a_field_that_nothing_reads(field, clean_argv):
    t, j = tff.FFConfig(device="cpu"), jff.FFConfig()
    with pytest.raises(AttributeError, match=field):
        setattr(t, field, getattr(j, field))
    # read by neither package: named in no module but the configs
    named = sorted(
        str(p.relative_to(REPO)) for d in ("flexflow_tpu", "flexflow_tpu_torch",
                                           "flexflow", "examples",
                                           "bootcamp_demo")
        for p in (REPO / d).rglob("*.py")
        if field in p.read_text(errors="replace"))
    assert named == ["flexflow_tpu/config.py", "flexflow_tpu_torch/config.py"]


_ACCESSORS = ("workers_per_node", "num_nodes", "cpus_per_node", "numWorkers")
_GETTERS = ("get_batch_size", "get_epochs", "get_workers_per_node",
            "get_num_nodes")


@pytest.mark.parametrize("argv", [
    ["-ll:gpu", "1"],
    ["-b", "32", "-e", "3", "-ll:gpu", "2", "--nodes", "2"],
    ["--batch-size", "8", "-ll:cpu", "4", "-ll:gpu", "1",
     "--search-num-nodes", "2", "--search-num-workers", "4"],
    ["-e", "2", "--lr", "0.5", "-ll:tpu", "3", "--budget", "4"],
], ids=" ".join)
def test_the_same_argv_gives_the_same_config(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    t, j = tff.FFConfig(device="cpu"), jff.FFConfig()
    for f in _JAX_FIELDS + sorted(_OWN):
        assert getattr(t, f) == getattr(j, f), f
    for a in _ACCESSORS:
        assert getattr(t, a) == getattr(j, a), a
    for g in _GETTERS:
        assert getattr(t, g)() == getattr(j, g)(), g
    assert t.get_current_time() > 0 and j.get_current_time() > 0
    t.begin_trace(111)
    t.end_trace(111)


def test_config_without_worker_flags(clean_argv):
    """No -ll:gpu: JAX counts the devices it sees (the test mesh's 8 CPU
    devices), the port its processes (1 without a process group);
    everything else agrees."""
    t, j = tff.FFConfig(device="cpu"), jff.FFConfig()
    assert t.workers_per_node == t.get_workers_per_node() == 1
    assert j.workers_per_node == len(jax.devices())
    assert t.num_nodes == j.num_nodes == 1
    assert t.numWorkers == 1


def _enums(pkg):
    return [getattr(pkg, n) for n in (
        "ActiMode", "AggrMode", "CompMode", "DataType", "LossType",
        "MetricsType", "OperatorType", "ParameterSyncType", "PoolType",
        "RegularizerMode")]


def test_enums_agree_through_the_type_helpers():
    import flexflow.type as jt
    import flexflow_tpu_torch.flexflow.type as tt
    assert tt.OpType is tt.OperatorType
    for je, te in zip(_enums(jt), _enums(tt)):
        assert [m.name for m in te] == [m.name for m in je], te
        for jm in je:
            tm = tt.str_to_enum(te, jt.enum_to_str(je, jm))
            assert tt.enum_to_int(te, tm) == jt.enum_to_int(je, jm)
            assert tt.int_to_enum(te, jt.enum_to_int(je, jm)) is tm
            assert tt.enum_to_str(te, tm) == jm.name


def test_reference_optimizer_signatures(clean_argv):
    import flexflow.core as jc
    import flexflow_tpu_torch.flexflow.core as tc
    for c, cfg in ((jc, jc.FFConfig()), (tc, tc.FFConfig(device="cpu"))):
        m = c.FFModel(cfg)
        o = c.SGDOptimizer(m, 0.02, 0.9)
        assert (o.lr, o.momentum) == (0.02, 0.9)
        assert c.SGDOptimizer(m, 0.01).lr == 0.01
        assert c.AdamOptimizer(m, 0.005).alpha == 0.005
        assert c.SGDOptimizer(lr=0.1).lr == 0.1
        assert c.get_legion_runtime() is None
        assert c.init_flexflow_runtime() is None
        assert c.fflogger.name == "fflogger"


@pytest.mark.parametrize("name", ["mnist", "cifar10", "reuters"])
def test_datasets_give_the_same_arrays(name):
    import flexflow.keras.datasets as jd
    import flexflow_tpu_torch.flexflow.keras.datasets as td
    j, t = getattr(jd, name).load_data(), getattr(td, name).load_data()
    for (ja, jb), (ta, tb) in zip(j, t):
        for a, b in ((ta, ja), (tb, jb)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# -- the runner ------------------------------------------------------------------

def test_install_refuses_after_jax_or_the_jax_package(monkeypatch):
    with pytest.raises(RuntimeError, match="jax"):
        run.install(device="cpu")
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.delitem(sys.modules, "flexflow", raising=False)
    with pytest.raises(RuntimeError, match="flexflow_tpu already imported"):
        run.install(device="cpu")
    assert not any(isinstance(f, run.AliasFinder) for f in sys.meta_path)


def test_set_default_device_checks_the_spelling():
    from flexflow_tpu_torch import config
    with pytest.raises(ValueError):
        config.set_default_device("tpu")
    assert config.default_device() == "cuda"


def _case(name, rel, argv):
    return {"name": name, "path": str(EXAMPLES / rel), "argv": argv,
            "timeout": 300}


CASES = [
    _case("compat/mnist_mlp", "compat/mnist_mlp.py", SMALL),
    _case("compat/seq_mnist_mlp", "compat/seq_mnist_mlp.py", SMALL),
    _case("native/mnist_cnn", "native/mnist_cnn.py", SMALL),
    _case("native/mnist_mlp_attach", "native/mnist_mlp_attach.py", SMALL),
    _case("native/print_layers", "native/print_layers.py", SMALL),
    _case("keras/func_mnist_mlp", "keras/func_mnist_mlp.py", SMALL),
    _case("keras/callback", "keras/callback.py", SMALL),
    _case("pytorch/mnist_mlp", "pytorch/mnist_mlp.py", SMALL),
    _case("onnx/mnist_mlp", "onnx/mnist_mlp.py", SMALL),
    _case("decoder_lm", "decoder_lm.py", ["-e", "1", "-b", "8"]),
]
# what each case prints when it has run through: its throughput line,
# decoder_lm's continuation, print_layers' weight read-back (it trains
# nothing)
MARK = dict({c["name"]: "THROUGHPUT" for c in CASES},
            decoder_lm="generated:",
            **{"native/print_layers": "conv bias after set_weights"})

BATCH = '''
import json, os, signal, sys
spec, out, repo = sys.argv[1:4]
sys.path.insert(0, os.path.join(repo, "tests"))
import _example_runner as er
from flexflow_tpu_torch import run
signal.signal(signal.SIGALRM, er._on_alarm)
results = {}
for case in json.load(open(spec))["cases"]:
    results[case["name"]] = er._run_case(case)
import flexflow_tpu_torch.core.model as cm
jax_pkg = os.path.join(repo, "flexflow_tpu") + os.sep
shim = os.path.join(repo, "flexflow") + os.sep
files = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values())]
report = {
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "jax_package_files": sorted(f for f in files if f.startswith((jax_pkg, shim))),
    "aliases": {k: getattr(m, "__name__", None) for k, m in sys.modules.items()
                if k.split(".")[0] in ("flexflow", "flexflow_tpu")},
    "model_spec": cm.__spec__.name, "model_name": cm.__name__,
    "model_file": cm.__file__,
    "same_object": sys.modules.get("flexflow_tpu") is sys.modules["flexflow_tpu_torch"],
}
# the refusal holds on any host: this process is told it sees no card
import torch
torch.cuda.is_available = lambda: False
run.install(device="cuda")
try:
    run.run_path(os.path.join(repo, "examples/python/native/print_layers.py"))
    report["cuda"] = None
except RuntimeError as e:
    report["cuda"] = str(e)
json.dump({"results": results, "report": report}, open(out, "w"))
'''


@pytest.fixture(scope="module")
def script_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_scripts")
    cases = []
    for c in CASES:
        cwd = base / c["name"].replace("/", "_")
        cwd.mkdir()
        cases.append(dict(c, cwd=str(cwd)))
    (base / "spec.json").write_text(json.dumps({"cases": cases}))
    (base / "batch.py").write_text(BATCH)
    out = base / "out.json"
    # two threads: the suite runs in several workers at once, and the
    # CNN's 8192 samples at every core each would oversubscribe the host
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.run", "--device", "cpu",
         str(base / "batch.py"), str(base / "spec.json"), str(out),
         str(REPO)], cwd=base, env=env, capture_output=True, text=True,
        timeout=900)
    assert out.exists(), (
        f"rc={proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(out.read_text())
    res["cwds"] = {c["name"]: c["cwd"] for c in cases}
    return res


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_script_runs_on_the_port(name, script_run):
    r = script_run["results"][name]
    assert r["ok"], r["output"]
    assert MARK[name] in r["output"], r["output"]


def test_exports_land_in_the_working_directory(script_run):
    cwds = script_run["cwds"]
    assert os.path.exists(os.path.join(cwds["pytorch/mnist_mlp"], "mlp.ff"))
    assert os.path.exists(os.path.join(cwds["onnx/mnist_mlp"],
                                       "mnist_mlp_pt.onnx"))
    assert not (EXAMPLES / "pytorch" / "mlp.ff").exists()


def test_the_scripts_loaded_only_the_port(script_run):
    rep = script_run["report"]
    assert rep["jax"] == [] and rep["jax_package_files"] == []
    assert "flexflow" in rep["aliases"] and "flexflow_tpu" in rep["aliases"]
    for alias, name in rep["aliases"].items():
        assert name.startswith("flexflow_tpu_torch"), (alias, name)
    assert rep["aliases"]["flexflow.core"] == "flexflow_tpu_torch.flexflow.core"
    assert rep["same_object"]
    assert rep["model_spec"] == rep["model_name"] == \
        "flexflow_tpu_torch.core.model"
    assert rep["model_file"] == str(REPO / "flexflow_tpu_torch" / "core" /
                                    "model.py")


def test_device_cuda_without_a_card_raises(script_run):
    assert script_run["report"]["cuda"] is not None
    assert "no CUDA device" in script_run["report"]["cuda"]
