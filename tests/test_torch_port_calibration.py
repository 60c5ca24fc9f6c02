"""The cost model's H100 calibration in flexflow_tpu_torch against the
JAX package's calibration tool (tools/calibrate_cost_model.py).

(a) `fit_calibration` on seeded synthetic rows equals the dict the JAX
tool's `write_outputs` writes for the same chip numbers (the tool runs
from a copy under tmp_path, so its writes land there); (b) the port's
`zoo_graphs()` gives the JAX tool's grid, op by op; (c) the shipped fit
validates and names an H100; (d) `CostModel` applies it on the H100's
chip only, and prices the flagship as JAX's CostModel does given the
same fit and chip numbers; (e) `main(--device cpu)` writes a valid fit.

Tolerances: the fit is the same float arithmetic on the same values, so
it is compared for equality; costs agree to rel 1e-12, as in
test_torch_port_search.py.
"""
import hashlib
import importlib.util
import json
import pathlib
import shutil
import sys

import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu.search as jsearch
import flexflow_tpu.search.machine_model as jmm
import flexflow_tpu_torch as tff
import flexflow_tpu_torch.search as tsearch
from flexflow_tpu.models.transformer import build_transformer as jtransformer
from flexflow_tpu.pcg import lowering as jlowering
from flexflow_tpu.pcg import machine_view as jmv
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.search import measure as jmeasure
from flexflow_tpu.search import substitution as jsub
from flexflow_tpu_torch.ff_types import DataType
from flexflow_tpu_torch.models import build_transformer as ttransformer
from flexflow_tpu_torch.pcg import lowering as tlowering
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.search import calibrate
from flexflow_tpu_torch.search import cost_model as tcm
from flexflow_tpu_torch.search import measure as tmeasure
from flexflow_tpu_torch.search import substitution as tsub

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "calibrate_cost_model.py"
REFERENCE_FILES = (TOOL, REPO / "flexflow_tpu" / "search" /
                   "calibration_v5e.json", REPO / "docs" / "calibration.md")
COST_RTOL = 1e-12
BATCH, SEQ, HIDDEN, HEADS, LAYERS = 8, 64, 128, 8, 2


def _digest(paths):
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
            if p.exists() else None for p in paths}


def _load_tool(path, monkeypatch):
    """The JAX tool as a module, imported by path; its sys.path insert is
    undone when the test ends."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"_jax_calibrate_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- (a) the fit ------------------------------------------------------------------

# (op, rows, regime): compute-bound and memory-bound classes, OP_LINEAR
# in both regimes (the '@mem' split), one-row classes, a class whose
# implied mxu efficiency is unphysical (> 1.2: fitted as memory-bound)
CLASSES = [("OP_LINEAR", 6, "compute"), ("OP_LINEAR", 4, "memory"),
           ("OP_MULTIHEAD_ATTENTION", 3, "compute"),
           ("OP_CONV2D", 2, "compute"), ("OP_BATCHMATMUL", 1, "compute"),
           ("OP_EMBEDDING", 1, "memory"), ("OP_LAYERNORM", 3, "memory"),
           ("OP_SOFTMAX", 1, "memory"), ("OP_POOL2D", 2, "memory"),
           ("OP_EW_ADD", 2, "unphysical")]


def synthetic_rows(seed, peak, hbm):
    """Rows as the tool's main() records them, at efficiencies past both
    clamps, with bwd/fwd ratios inside and outside [0.5, 4] (the one-row
    OP_BATCHMATMUL's only ratio outside)."""
    rng = np.random.RandomState(seed)
    rows = []
    for op, n, regime in CLASSES:
        for i in range(n):
            if regime == "memory":
                nbytes = rng.uniform(1e6, 1e9)
                flops = nbytes / hbm * peak * rng.uniform(0.01, 0.5)
                fwd = nbytes / (hbm * rng.uniform(0.1, 1.1))
            else:
                flops = rng.uniform(1e9, 1e11)
                nbytes = flops / peak * hbm * rng.uniform(0.05, 0.5)
                eff = (rng.uniform(1.3, 2.0) if regime == "unphysical"
                       else rng.uniform(0.2, 0.99))
                fwd = flops / (peak * eff)
            ratio = [rng.uniform(0.6, 3.8), 0.2, 5.0][
                rng.choice(3, p=[0.7, 0.15, 0.15])]
            if op == "OP_BATCHMATMUL":
                ratio = 6.0
            rows.append({
                "model": f"m{i}", "op": op, "shapes": str((i, n)),
                "flops": flops, "bytes": nbytes,
                "fwd_s": fwd, "bwd_s": ratio * fwd,
                "implied_mxu_fwd": flops / (peak * fwd),
                "implied_hbm_fwd": nbytes / (hbm * fwd),
                "bwd_over_fwd": ratio})
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bf16", [True, False])
def test_fit_equals_the_jax_tools(tmp_path, monkeypatch, seed, bf16):
    before = _digest(REFERENCE_FILES)
    root = tmp_path / "tool"
    (root / "tools").mkdir(parents=True)
    (root / "flexflow_tpu" / "search").mkdir(parents=True)
    shutil.copy(TOOL, root / "tools" / TOOL.name)
    tool = _load_tool(root / "tools" / TOOL.name, monkeypatch)
    chip = jmm.MachineModel().chip
    peak = chip.peak_flops_bf16 if bf16 else chip.peak_flops_f32
    rows = synthetic_rows(seed, peak, chip.hbm_bandwidth)
    tool.write_outputs(rows, "a chip", bf16)
    want = json.loads((root / "flexflow_tpu" / "search" /
                       "calibration_v5e.json").read_text())
    got = calibrate.fit_calibration(rows, "a chip", bf16,
                                    tsearch.TPUChipSpec())
    assert json.loads(json.dumps(got)) == want
    classes = want["op_class"]
    assert {"OP_LINEAR", "OP_LINEAR@mem"} <= set(classes)
    assert classes["OP_EW_ADD"]["bound"] == "memory"
    assert "bwd_over_fwd" not in classes["OP_BATCHMATMUL"]
    assert tcm.validate_calibration(got) is got
    assert _digest(REFERENCE_FILES) == before


# -- (b) the grid -----------------------------------------------------------------

def _grid_keys(graphs, local_shape):
    return [(name, [(op.op_type.name,
                     tuple(local_shape(t) for t in op.inputs),
                     tuple(local_shape(w) for w in op.weights))
                    for op in g.topo_order()
                    if not op.is_parallel_op and op.inputs])
            for name, g in graphs]


def test_zoo_graphs_match_the_jax_tools(monkeypatch):
    tool = _load_tool(TOOL, monkeypatch)
    want = _grid_keys(tool.zoo_graphs(), jmeasure._local_shape)
    got = _grid_keys(calibrate.zoo_graphs(), tmeasure._local_shape)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert got == want
    assert sum(len(k) for _, k in got) > 100


# -- (c) the shipped fit ----------------------------------------------------------

def test_shipped_fit_is_a_valid_fit_of_an_h100():
    path = pathlib.Path(calibrate.DEFAULT_OUT)
    cal = json.loads(path.read_text())
    assert tcm.validate_calibration(cal) is cal
    assert "H100" in cal["device"] and cal["dtype"] == "bf16"
    assert cal["op_class"]
    for name, e in cal["op_class"].items():
        assert e["n"] >= 1, name
        assert e["bound"] in ("compute", "memory"), name
        eff = e["mxu_efficiency" if e["bound"] == "compute"
                else "hbm_efficiency"]
        assert 0.0 < eff <= 1.0, name
    assert tcm.load_default_calibration() == cal


# -- (d) the default --------------------------------------------------------------

def test_default_fit_applies_on_the_h100_chip_only():
    fit = tcm.load_default_calibration()
    assert fit is not None
    assert tsearch.CostModel(tsearch.h100_machine()).calibration is fit
    assert tsearch.CostModel(tsearch.h100_machine(2, 8)).calibration is fit
    assert tsearch.CostModel(tsearch.MachineModel()).calibration is None
    assert tsearch.CostModel(tsearch.h100_machine(),
                             calibration=False).calibration is None
    cal = {"mxu_efficiency": 0.4, "op_class": {}}
    assert tsearch.CostModel(tsearch.MachineModel(),
                             calibration=cal).calibration is cal


def _flagship(pkg, partition):
    if pkg is tff:
        m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=BATCH))
        ttransformer(m, BATCH, SEQ, HIDDEN, HEADS, LAYERS)
        g = tlowering.layers_to_pcg(m.layers)[0]
        sub = tsub
    else:
        m = jff.FFModel(jff.FFConfig())
        jtransformer(m, BATCH, SEQ, HIDDEN, HEADS, LAYERS)
        g = jlowering.layers_to_pcg(m.layers)[0]
        sub = jsub
    if partition:
        g = next(iter(sub.partition_batch(partition).apply(g)))
    return g


@pytest.mark.parametrize("partition", [None, 2, 4])
@pytest.mark.parametrize("bf16", [True, False])
def test_default_fit_prices_the_flagship_like_jax(monkeypatch, partition,
                                                  bf16):
    """The port's default CostModel on the H100 against JAX's given the
    shipped fit and the H100's numbers (its tile quanta patched in: the
    JAX package's are module constants)."""
    h = tsearch.H100_SPEC
    monkeypatch.setattr(jcm, "MXU_LANES", h.mxu_lanes)
    monkeypatch.setattr(jcm, "MXU_SUBLANES", h.mxu_sublanes)
    tmach = tsearch.h100_machine(1, 4)
    jmach = jsearch.MachineModel(
        num_nodes=1, workers_per_node=4,
        chip=jmm.TPUChipSpec(peak_flops_bf16=h.peak_flops_bf16,
                             peak_flops_f32=h.peak_flops_f32,
                             hbm_bandwidth=h.hbm_bandwidth,
                             hbm_capacity=h.hbm_capacity,
                             vmem_capacity=h.vmem_capacity),
        ici_bandwidth=tmach.ici_bandwidth, dcn_bandwidth=tmach.dcn_bandwidth)
    fit = tcm.load_default_calibration()
    tc = tsearch.CostModel(tmach, bf16=bf16)
    jc = jsearch.CostModel(jmach, bf16=bf16, calibration=fit)
    plain = tsearch.CostModel(tmach, bf16=bf16, calibration=False)
    jg, tg = _flagship(jff, partition), _flagship(tff, partition)
    jops, tops = jg.topo_order(), tg.topo_order()
    assert [o.op_type for o in jops] == [o.op_type for o in tops]
    moved = 0
    for jo, to in zip(jops, tops):
        if to.is_parallel_op:
            continue
        for deg in (1, 2, 4):
            for start in range(0, 4, deg):
                jv = jmv.MachineView(start_device_id=start, dim=(deg,))
                tv = tmv.MachineView(start_device_id=start, dim=(deg,))
                jm = jc.measure_operator_cost(jo, jv)
                tm = tc.measure_operator_cost(to, tv)
                np.testing.assert_allclose(
                    (tm.forward_time, tm.backward_time, tm.sync_time),
                    (jm.forward_time, jm.backward_time, jm.sync_time),
                    rtol=COST_RTOL, err_msg=to.name)
                moved += (plain.measure_operator_cost(to, tv).forward_time
                          != tm.forward_time)
    assert moved  # the fit changed prices


# -- (e) the tool -----------------------------------------------------------------

def _two_graph_zoo():
    out = []
    for name, build in (
            ("dense", lambda m, x: m.dense(x, 1024)),
            ("layer_norm", lambda m, x: m.layer_norm(x, axes=(-1,)))):
        m = tff.FFModel(tff.FFConfig(device="cpu"))
        shape = (256, 1024) if name == "dense" else (8, 256, 1024)
        build(m, m.create_tensor(shape, DataType.DT_FLOAT))
        out.append((name, tlowering.layers_to_pcg(m.layers)[0]))
    return out


def test_main_on_the_cpu_writes_a_valid_fit(tmp_path, monkeypatch):
    """The tool end to end on the host clock. A CPU's times against the
    H100's roofline imply efficiencies near 0.001, which round to 0 at
    the fit's three decimals; the roofline here is a CPU-sized chip."""
    from flexflow_tpu_torch.search import machine_model

    slow = machine_model.MachineModel(
        num_nodes=1, workers_per_node=1,
        chip=machine_model.TPUChipSpec(peak_flops_bf16=1e11,
                                       hbm_bandwidth=5e9))
    monkeypatch.setattr(machine_model, "h100_machine", lambda: slow)
    monkeypatch.setattr(calibrate, "zoo_graphs", _two_graph_zoo)
    out = tmp_path / "fit.json"
    assert calibrate.main(["--device", "cpu", "--out", str(out)]) == 0
    cal = json.loads(out.read_text())
    assert tcm.validate_calibration(cal) is cal
    assert cal["device"] == "cpu" and cal["power_limit"] is None
    assert set(cal["op_class"]) == {"OP_LINEAR", "OP_LAYERNORM"} or \
        set(cal["op_class"]) == {"OP_LINEAR@mem", "OP_LAYERNORM"}
    assert all(e["n"] == 1 for e in cal["op_class"].values())
    assert not list(tmp_path.glob("*.tmp"))


def _roofline_sweep(lanes, sublanes, bases=(512, 1024)):
    """{base: [(m, k, n, seconds)]}: the sweep's k and n extents at
    compute-bound bases, timed by the roofline at quanta (lanes,
    sublanes)."""
    from flexflow_tpu_torch.search import tile_sweep

    pad = tile_sweep._pad
    by_base = {}
    for base in bases:
        for axis in "kn":
            for off in tile_sweep.SWEEP_OFFSETS:
                m, k, n = (base + off if axis == a else tile_sweep.SWEEP_FIXED
                           for a in "mkn")
                fl = 2.0 * pad(m, sublanes) * pad(k, lanes) * pad(n, lanes)
                by = 2.0 * (m * k + k * n + m * n)
                by_base.setdefault(base, []).append(
                    (m, k, n, max(fl / 5e14, by / 2.5e12)))
    return by_base


@pytest.mark.parametrize("lanes,sublanes", [(128, 1), (64, 8)])
def test_tile_sweep_scores_the_quanta_that_made_the_times(lanes, sublanes):
    """Times made by the roofline at a known quanta pair: that pair
    explains them exactly, and quanta 1 and 1 do not."""
    from flexflow_tpu_torch.search import tile_sweep

    points = [p for pts in _roofline_sweep(lanes, sublanes).values()
              for p in pts]
    errs = tile_sweep.quanta_errors(points)
    assert set(errs) == {(a, b) for a in tile_sweep.SWEEP_QUANTA
                         for b in tile_sweep.SWEEP_QUANTA}
    assert errs[(lanes, sublanes)] == pytest.approx(0.0, abs=1e-9)
    assert errs[(1, 1)] > 1e-3
    assert errs[tile_sweep.best_quanta(errs)] == \
        pytest.approx(0.0, abs=1e-9)


def test_tile_sweep_verdict_rejects_quanta_that_pad_past_the_times():
    """`analyze` holds the shipped pair to quanta 1 and 1 at every base:
    the pair that made the times passes, lanes that pad past them fail."""
    from flexflow_tpu_torch.search import tile_sweep

    by_base = _roofline_sweep(128, 1)
    good = tile_sweep.analyze(by_base, (128, 1))
    assert good["shipped_explains"] and good["shipped"] == "128x1"
    for scoring in ("all", "aligned"):
        assert good[scoring]["shipped"] < good[scoring]["1x1"]
        assert set(good[scoring]["per_base"]) == {"512", "1024"}
    assert not tile_sweep.analyze(by_base, (256, 1))["shipped_explains"]
