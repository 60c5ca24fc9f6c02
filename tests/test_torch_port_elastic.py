"""The elastic runtime of flexflow_tpu_torch (runtime/elastic.py) against
the JAX package, on the CPU.

  - the topology fingerprint of a mesh: a checkpoint saved by 4 gloo
    ranks at dp 4 records 4 devices and JAX's `mesh_axes` for the same
    strategy at 4 CPU devices (the keys that differ by nature are named
    beside their assertions);
  - `topology_matches`, `topology_diff` and `validate_machine_views` on
    the same inputs as JAX's (strided views, lost slices);
  - elastic 4 -> 2: 4 ranks lose a host at step 1 (`host_loss`), 2 ranks
    `restore_elastic` the checkpoint and `fit(elastic=True)` on, against
    JAX at 4 CPU devices and then `shrunk_devices(2)`;
  - a hung step under `allreduce_heartbeat` at 2 ranks: every rank
    raises CollectiveTimeout and one checkpoint is written;
  - 8 ranks shrink to 4 (`shrunk_devices`): the survivors' dp 2 x tp 2
    mesh is built from their own groups and trains as one device does;
  - the health monitor's escalations (hung step, heartbeat error and
    stall, on_hang once, the compile grace) and FileHeartbeat, waiting on
    events with timeouts of at least 10x the simulated stall and never
    asserting a wall-time bound (their JAX counterparts failed under
    xdist load);
  - `fit(elastic=True)`/`fit(health_monitor=...)` on one device, and
    `restore_elastic`'s errors, against JAX's `tests/test_elastic.py`.

The ranks run as gloo subprocesses (flexflow_tpu_torch/runtime/
mesh_run.py running tests/torch_mesh_cases.py, OMP_NUM_THREADS=1, a
150 s launch timeout; the 2-rank group after the 4-rank group that
saves, the 8-rank group after them). JAX's references run in this process on the conftest's CPU
devices, and the port's models start from JAX's initial weights.

Tolerances: params atol 1e-5 / rtol 1e-5 against JAX (the packages sum
the same products in other orders); restored weights bit-equal (atol 0)
to the weights the checkpoint was taken from.
"""
import concurrent.futures
import json
import pathlib
import threading

import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.runtime import checkpoint as jckpt
from flexflow_tpu.runtime import elastic as jel
from flexflow_tpu.runtime import resilience as jrz
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import (ActiMode, DataType, LossType,
                                         MetricsType)
from flexflow_tpu_torch.pcg.machine_view import MachineView
from flexflow_tpu_torch.runtime import elastic as tel
from flexflow_tpu_torch.runtime.fault_domains import FaultDomainMap
from flexflow_tpu_torch.runtime.mesh_run import launch
from flexflow_tpu_torch.runtime.resilience import (CollectiveTimeout,
                                                   FaultInjector,
                                                   HostLossError)
from flexflow_tpu_torch.runtime.weights import params_from_numpy

RTOL = ATOL = 1e-5
TIMEOUT = 150
CASES = str(pathlib.Path(__file__).with_name("torch_mesh_cases.py"))
SPARSE = "sparse_categorical_crossentropy"
MLP = {"batch": 32, "width": 4, "hidden": 16, "classes": 3}
# a monitor's timeout (far past a real step of these models under a
# loaded host), and each wait on it: the wait is 10x+ the stall
STALL_S = 2.0
WAIT_S = 30.0


# ----------------------------------------------------------------------
# models (tests/test_elastic.py small_model, in both packages)
# ----------------------------------------------------------------------
def small_model(batch=32):
    m = FFModel(FFConfig(batch_size=batch, device="cpu"))
    x = m.create_tensor((batch, 4), DataType.DT_FLOAT)
    t = m.dense(x, 16, ActiMode.AC_MODE_RELU)
    t = m.dense(t, 3)
    m.softmax(t)
    m.compile(SGDOptimizer(lr=0.1, momentum=0.9),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [MetricsType.METRICS_ACCURACY])
    return m


def jax_model(workers, batch=32, nodes=1):
    cfg = jff.FFConfig()
    cfg.batch_size = batch
    cfg.numNodes = nodes
    cfg.workersPerNode = workers
    m = jff.FFModel(cfg)
    x = m.create_tensor((batch, 4), jff.DataType.DT_FLOAT)
    t = m.dense(x, 16, jff.ActiMode.AC_MODE_RELU)
    t = m.dense(t, 3)
    m.softmax(t)
    m.compile(jff.SGDOptimizer(lr=0.1, momentum=0.9),
              jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [jff.MetricsType.METRICS_ACCURACY])
    return m


def dataset(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = rng.randint(0, 3, (n, 1)).astype(np.int32)
    return x, y


def jax_params(m):
    return {op: {n: np.array(a, copy=True) for n, a in ws.items()}
            for op, ws in m.state.params.items()}


def port_params(m):
    return {op: {n: w.detach().cpu().numpy().copy() for n, w in ws.items()}
            for op, ws in m.params.items()}


def assert_close(got, want, atol=ATOL, rtol=RTOL):
    assert set(got) == set(want)
    for op, ws in want.items():
        for n, a in ws.items():
            np.testing.assert_allclose(got[op][n], a, atol=atol, rtol=rtol,
                                       err_msg=f"{op}/{n}")


def _tree(arrays, prefix):
    out = {}
    for k, a in arrays.items():
        if k.startswith(prefix + "/"):
            op, n = k[len(prefix) + 1:].split("/", 1)
            out.setdefault(op, {})[n] = a
    return out


def _save_weights(path, params):
    np.savez(path, **{f"{op}/{n}": a for op, ws in params.items()
                      for n, a in ws.items()})
    return str(path)


# ----------------------------------------------------------------------
# the gloo ranks
# ----------------------------------------------------------------------
class _Run:
    """One launch; `wait_s` bounds the wait for it, the launches chained
    ahead of it included."""

    def __init__(self, d, nprocs, future, wait_s):
        self.dir, self.nprocs, self.future = pathlib.Path(d), nprocs, future
        self.wait_s = wait_s

    def result(self, name, rank=0):
        self.future.result(timeout=self.wait_s)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic_ranks")
    x, y = dataset(64)
    np.savez(d / "data.npz", x0=x, y=y)
    init = jax_params(jax_model(4))
    base = {"builder": "mlp", "builder_kwargs": MLP, "loss": SPARSE,
            "optimizer": {"lr": 0.1, "momentum": 0.9},
            "config": {"batch_size": 32}, "data": str(d / "data.npz"),
            "init_weights": _save_weights(d / "init.npz", init)}
    four = [dict(base, name="save", mode="elastic_save",
                 path=str(d / "ck"), epochs=2,
                 faults={str(r): [["host_loss", {
                     "at_step": 1, "surviving_devices": 2}]]
                     for r in range(4)})]
    two = [dict(base, name="resume", mode="elastic_resume",
                path=str(d / "ck"), epochs=2),
           dict(base, name="hung", mode="hung_step", path=str(d / "ck_hung"),
                epochs=2, monitor={"timeout_s": 5.0,
                                   "heartbeat_interval_s": 0.5},
                faults={str(r): [["hung_step", {"at_step": 2}]]
                        for r in range(2)})]
    pool = concurrent.futures.ThreadPoolExecutor(2)
    out = {}

    def start(name, n, cases, after=None):
        gd = d / name
        gd.mkdir()
        (gd / "spec.json").write_text(json.dumps(cases))

        def go():
            if after is not None:
                after.future.result()
            return launch(n, ["--device", "cpu", CASES,
                              str(gd / "spec.json"), str(gd)], str(gd),
                          timeout=TIMEOUT)

        ahead = 0 if after is None else after.wait_s - 60
        out[name] = _Run(gd, n, pool.submit(go), ahead + TIMEOUT + 60)

    eight = [dict(base, name="shrunk", mode="shrunk_mesh", shrink=4,
                  steps=2, init_weights=None,
                  builder_kwargs=dict(MLP, batch=8, classes=4),
                  config={"batch_size": 8, "tensor_parallel_degree": 2})]
    start("four", 4, four)
    start("two", 2, two, after=out["four"])
    start("eight", 8, eight, after=out["two"])
    yield {"runs": out, "dir": d, "init": init, "data": (x, y)}
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_elastic(runs, tmp_path_factory):
    """JAX's 4 -> 2 story on the same data and weights: 4 CPU devices
    lose a host at step 1, then `shrunk_devices(2)`, `restore_elastic` and
    `fit(elastic=True)` on. Its sidecar's topology, the restored and the
    final weights."""
    d = tmp_path_factory.mktemp("jax_elastic")
    x, y = runs["data"]

    m = jax_model(4)  # its seeded init is the ranks' init_weights
    fi = jrz.FaultInjector().inject("host_loss", at_step=1,
                                    surviving_devices=2)
    with pytest.raises(jrz.HostLossError) as ei:
        m.fit(x, y, epochs=2, verbose=False, checkpoint_dir=str(d),
              checkpoint_every_n_steps=1, fault_injector=fi)
    topo = jckpt.load_checkpoint_meta(ei.value.checkpoint_path)["topology"]
    with jel.shrunk_devices(2):
        m2, info = jel.restore_elastic(lambda: jax_model(2), str(d))
        restored = jax_params(m2)
        m2.fit(x, y, epochs=2, verbose=False, checkpoint_dir=str(d),
               elastic=True)
        final = jax_params(m2)
        step = int(m2.state.step)
    return {"topology": topo, "restored": restored, "final": final,
            "step": step, "restored_step": info.step}


# ----------------------------------------------------------------------
# the repair: the fingerprint of a mesh
# ----------------------------------------------------------------------
def test_a_4_rank_checkpoint_records_the_mesh(runs, jax_elastic):
    outs = runs["runs"]["four"].ok("save")
    want = jax_elastic["topology"]
    for o in outs:
        topo = o["topology"]
        assert topo["num_devices"] == 4 == want["num_devices"]
        assert topo["mesh_axes"] == want["mesh_axes"]
        # by nature: JAX's CPU devices are one process's, the port's ranks
        # one process each, each rank its own flat device id
        assert want["num_processes"] == 1 and topo["num_processes"] == 4
        assert want["per_process_devices"] == {"0": [0, 1, 2, 3]}
        assert topo["per_process_devices"] == {
            str(r): [r] for r in range(4)}
        assert set(topo) == set(want)


def test_host_loss_flushes_then_2_ranks_resume_elastically(runs,
                                                           jax_elastic):
    outs = runs["runs"]["four"].ok("save")
    for o in outs:
        assert o["raised"] == "HostLossError"
        assert o["surviving_devices"] == 2
        assert o["checkpoint"].endswith("step_0000000001")
    stopped = _tree(runs["runs"]["four"].arrays("save"), "stopped")
    res = runs["runs"]["two"].ok("resume")
    for o in res:
        assert o["step"] == 1 == jax_elastic["restored_step"]
        assert o["saved_devices"] == 4
        assert o["mesh"]["data"] == 2
        assert o["final_step"] == 4 == jax_elastic["step"]
    arrays = runs["runs"]["two"].arrays("resume")
    restored = _tree(arrays, "restored")
    # the restore onto 2 ranks is the 4 ranks' weights bit for bit
    assert_close(restored, stopped, atol=0, rtol=0)
    assert_close(restored, jax_elastic["restored"])
    assert_close(_tree(arrays, "final"), jax_elastic["final"])


def test_hung_step_raises_on_every_rank_and_writes_one_checkpoint(runs):
    outs = runs["runs"]["two"].ok("hung")
    for o in outs:
        assert o["raised"] == "CollectiveTimeout"
        assert o["kind"] == "hung_step"
        assert o["step"] == 2
        assert o["checkpoint"].endswith("step_0000000002")
        assert o["steps_on_disk"] == [2]
        assert o["running"] is False  # fit stopped the monitor it started
        assert o["beat_s"] is not None  # the heartbeat group beat


def test_a_shrunk_world_builds_a_2d_mesh_of_the_survivors(runs):
    """8 ranks shrink to 4; the survivors' dp 2 x tp 2 mesh is built from
    their groups alone and trains as one device does (the same seeded
    weights, the first batch twice); the lost ranks take no part."""
    outs = runs["runs"]["eight"].ok("shrunk")
    assert [o["lost"] for o in outs] == [False] * 4 + [True] * 4
    for o in outs[:4]:
        assert o["world"] == 4 and o["live"] and o["live_after"]
        assert o["dims"] == [2, 2] and o["ranks"] == [[0, 1], [2, 3]]
        assert (o["mesh"]["data"], o["mesh"]["model"]) == (2, 2)
    x, y = runs["data"]
    ref = FFModel(FFConfig(batch_size=8, device="cpu"))
    xt = ref.create_tensor((8, 4), DataType.DT_FLOAT)
    ref.softmax(ref.dense(ref.dense(xt, 16, ActiMode.AC_MODE_RELU), 4))
    ref.compile(SGDOptimizer(lr=0.1, momentum=0.9),
                "sparse_categorical_crossentropy")
    step = ref.executor.build_train_step()
    losses = []
    for i in range(2):
        ref.state, p = step(ref.state, [x[:8]], y[:8], i)
        losses.append(float(p["loss"]))
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=RTOL,
                               atol=ATOL)
    assert_close(_tree(runs["runs"]["eight"].arrays("shrunk"), "final"),
                 port_params(ref))


# ----------------------------------------------------------------------
# fingerprints, matches, diffs, view validation against JAX's functions
# ----------------------------------------------------------------------
def test_fingerprint_of_one_device_and_slices():
    from flexflow_tpu.runtime.fault_domains import FaultDomainMap as JMap

    fd = FaultDomainMap.from_devices(4, 2)
    fp = tel.topology_fingerprint(torch.device("cpu"), fault_domains=fd)
    jfp = jel.topology_fingerprint(fault_domains=JMap.from_devices(8, 4))
    assert set(fp) == set(jfp)
    assert fp["slices"] == [[0, 1], [2, 3]]
    assert fp["num_devices"] == 1 and fp["mesh_axes"] == {}


_FPS = [
    ({"num_devices": 8, "num_processes": 1, "platform": "cpu"},
     {"num_devices": 4, "num_processes": 1, "platform": "cpu"}),
    ({"num_devices": 8, "num_processes": 1, "platform": "cpu",
      "slices": [[0, 1, 2, 3], [4, 5, 6, 7]]},
     {"num_devices": 8, "num_processes": 1, "platform": "cpu",
      "slices": [list(range(8))]}),
    ({"num_devices": 8, "num_processes": 2, "platform": "gpu",
      "slices": [[0, 1, 2, 3], [4, 5, 6, 7]]},
     {"num_devices": 4, "num_processes": 1, "platform": "cpu",
      "slices": [[0, 1, 2, 3]]}),
    ({"num_devices": 4, "num_processes": 4, "platform": "gpu"},
     {"num_devices": 4, "num_processes": 4, "platform": "gpu"}),
    (None, {"num_devices": 1}),
]


@pytest.mark.parametrize("saved,live", _FPS)
def test_topology_matches_and_diff_as_jax(saved, live):
    assert tel.topology_matches(saved, live) == \
        jel.topology_matches(saved, live)
    assert tel.topology_diff(saved, live) == jel.topology_diff(saved, live)


@pytest.mark.parametrize("start,dim,stride,ndev,slices", [
    (0, (4,), (1,), 4, None), (0, (4,), (1,), 2, None),
    (0, (2,), (3,), 4, None), (1, (2, 2), (1, 2), 4, None),
    (0, (8,), (1,), 4, 2), (4, (4,), (1,), 4, 2), (0, (2,), (5,), 4, 4)])
def test_validate_machine_views_as_jax(start, dim, stride, ndev, slices):
    from flexflow_tpu.pcg.machine_view import MachineView as JView
    from flexflow_tpu.runtime.fault_domains import FaultDomainMap as JMap

    fd = None if slices is None else FaultDomainMap.from_devices(8, slices)
    jfd = None if slices is None else JMap.from_devices(8, slices)
    got = tel.validate_machine_views(
        {7: MachineView(start_device_id=start, dim=dim, stride=stride)},
        ndev, fault_domains=fd)
    want = jel.validate_machine_views(
        {7: JView(start_device_id=start, dim=dim, stride=stride)},
        ndev, fault_domains=jfd)
    # the view's repr is each package's own; the rest of the text is
    # the same
    strip = lambda ms: [m.split(" addresses ")[1] for m in ms]  # noqa: E731
    assert strip(got) == strip(want)
    assert len(got) == len(want)


# ----------------------------------------------------------------------
# one device: fit's keywords, restore_elastic
# ----------------------------------------------------------------------
def _port_from(jm, batch=32):
    m = small_model(batch)
    params_from_numpy(m, jax_params(jm))
    return m


def test_watchdog_flushes_a_checkpoint_and_the_resume_matches_jax(tmp_path):
    x, y = dataset(64)
    jm = jax_model(1)
    m = _port_from(jm)
    fi = FaultInjector().inject("hung_step", at_step=3)
    mon = tel.HealthMonitor(timeout_s=STALL_S)
    with pytest.raises(CollectiveTimeout) as ei:
        m.fit(x, y, epochs=2, verbose=False,
              checkpoint_dir=str(tmp_path / "p"), checkpoint_every_n_steps=2,
              fault_injector=fi, health_monitor=mon)
    assert ei.value.info["kind"] == "hung_step" and ei.value.step == 3
    assert fi.fired["hung_step"] == 1
    assert ei.value.checkpoint_path.endswith("step_0000000003")
    assert not mon.running
    m2 = small_model()
    m2.fit(x, y, epochs=2, verbose=False, checkpoint_dir=str(tmp_path / "p"))
    assert m2.state.step == 4
    jfi = jrz.FaultInjector().inject("hung_step", at_step=3)
    jmon = jel.HealthMonitor(timeout_s=STALL_S)
    try:
        with pytest.raises(jrz.CollectiveTimeout):
            jm.fit(x, y, epochs=2, verbose=False,
                   checkpoint_dir=str(tmp_path / "j"),
                   checkpoint_every_n_steps=2, fault_injector=jfi,
                   health_monitor=jmon)
    finally:
        jmon.stop()
    jm2 = jax_model(1)
    jm2.fit(x, y, epochs=2, verbose=False,
            checkpoint_dir=str(tmp_path / "j"))
    assert_close(port_params(m2), jax_params(jm2))


def test_monitored_fit_equals_a_plain_fit_and_stays_quiet():
    x, y = dataset(64)
    jm = jax_model(1)
    a, b = _port_from(jm), _port_from(jm)
    mon = tel.HealthMonitor(timeout_s=WAIT_S)
    a.fit(x, y, epochs=1, verbose=False, health_monitor=mon)
    b.fit(x, y, epochs=1, verbose=False)
    assert not mon.hang_detected and not mon.running
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n])
    jm.fit(x, y, epochs=1, verbose=False)
    assert_close(port_params(a), jax_params(jm))


def test_host_loss_then_restore_elastic_on_one_device(tmp_path):
    x, y = dataset(64)
    jm = jax_model(1)
    m = _port_from(jm)
    fi = FaultInjector().inject("host_loss", at_step=1, surviving_devices=1)
    with pytest.raises(HostLossError) as ei:
        m.fit(x, y, epochs=2, verbose=False, checkpoint_dir=str(tmp_path),
              fault_injector=fi)
    assert ei.value.surviving_devices == 1
    assert ei.value.checkpoint_path is not None
    with tel.shrunk_devices(1):
        m2, info = tel.restore_elastic(small_model, str(tmp_path))
        assert info.step == 1
        m2.fit(x, y, epochs=2, verbose=False, checkpoint_dir=str(tmp_path),
               elastic=True)
    assert m2.state.step == 4
    jm.fit(x, y, epochs=2, verbose=False)
    assert_close(port_params(m2), jax_params(jm))


def test_restore_elastic_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(tel.ElasticRestoreError, match="no restorable"):
        tel.restore_elastic(small_model, str(tmp_path))


def test_shrunk_devices_without_a_group():
    with tel.shrunk_devices(1) as devs:
        assert devs == [0]
    with pytest.raises(ValueError):
        with tel.shrunk_devices(2):
            pass


def test_recompile_for_topology_keeps_the_config_and_reinitializes():
    m = small_model()
    m.config.search_num_workers = 8
    m.recompile_for_topology()
    assert m.config.search_num_workers == -1
    assert (m.config.numNodes, m.config.workersPerNode) == (1, 1)
    assert m.executor.mesh_is_live() and m.state.step == 0


# ----------------------------------------------------------------------
# the health monitor (events, never wall-time bounds)
# ----------------------------------------------------------------------
def _wait_for_hang(mon):
    """Wait (on the monitor's release event) for a detection; WAIT_S is
    far past every stall these tests simulate."""
    mon._hang_release.wait(WAIT_S)
    return mon.hang_detected


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_file_heartbeat_detects_straggler(tmp_path, pkg):
    el = tel if pkg == "torch" else jel
    me = el.FileHeartbeat(str(tmp_path), "host0", stale_after_s=STALL_S)
    peer = el.FileHeartbeat(str(tmp_path), "host1", stale_after_s=STALL_S)
    peer.beat()
    assert me() == []
    mon = el.HealthMonitor(timeout_s=WAIT_S, heartbeat_fn=me,
                           heartbeat_interval_s=0.05).start()
    try:
        assert _wait_for_hang(mon)
        assert mon.hang_info["kind"] == "straggler"
        assert mon.hang_info["peers"] == ["host1"]
    finally:
        mon.stop()


def test_file_heartbeat_missing_expected_peer(tmp_path):
    for el in (tel, jel):
        me = el.FileHeartbeat(str(tmp_path / el.__name__), "host0",
                              expected_peers=["host0", "host1"])
        assert me() == ["host1"]


def test_heartbeat_error_escalates():
    def broken():
        raise RuntimeError("transport down")

    mon = tel.HealthMonitor(timeout_s=WAIT_S, heartbeat_fn=broken,
                            heartbeat_interval_s=0.05).start()
    try:
        assert _wait_for_hang(mon)
        assert mon.hang_info["kind"] == "heartbeat_error"
        assert "transport down" in mon.hang_info["error"]
    finally:
        mon.stop()


def test_stalled_heartbeat_escalates():
    release = threading.Event()

    def stuck():
        release.wait(WAIT_S)

    mon = tel.HealthMonitor(timeout_s=STALL_S, heartbeat_fn=stuck,
                            heartbeat_interval_s=0.05).start()
    try:
        assert _wait_for_hang(mon)
        assert mon.hang_info["kind"] == "heartbeat_stalled"
    finally:
        release.set()
        mon.stop()


def test_on_hang_callback_fires_once():
    calls = []
    mon = tel.HealthMonitor(timeout_s=0.1, poll_interval_s=0.02,
                            on_hang=calls.append, compile_grace_s=0.0)
    mon.start()
    try:
        mon.step_started(7)
        assert _wait_for_hang(mon)
        mon.stop()  # the watchdog thread has returned: no second call
        assert len(calls) == 1 and calls[0]["step"] == 7
    finally:
        mon.stop()


def test_first_step_gets_compile_grace():
    """Before the first step finishes, the hung-step check waits the
    compile grace on top of the timeout; after it, the timeout alone.
    The grace is far longer than the wait that shows it holds."""
    mon = tel.HealthMonitor(timeout_s=0.1, poll_interval_s=0.02,
                            compile_grace_s=1e4)
    mon.start()
    try:
        mon.step_started(0)
        assert not mon._hang_release.wait(1.0)  # inside the grace
        assert not mon.hang_detected
        mon.step_finished(0)
        mon.step_started(1)
        assert _wait_for_hang(mon)
        assert mon.hang_info["kind"] == "hung_step"
        assert mon.hang_info["step"] == 1
    finally:
        mon.stop()


def test_allreduce_heartbeat_off_a_group_is_a_local_beat():
    beat = tel.allreduce_heartbeat()
    assert beat() is None
    beat.finish()  # nothing to end in step without a group
