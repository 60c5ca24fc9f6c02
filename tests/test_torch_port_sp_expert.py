"""flexflow_tpu_torch's sequence parallelism (ring and Ulysses attention),
expert parallelism and the train scan over a device mesh, against the
JAX package on the conftest's CPU devices.

The ranks run as in tests/test_torch_port_mesh.py: gloo ranks started as
subprocesses (flexflow_tpu_torch/runtime/mesh_run.py running
tests/torch_mesh_cases.py, OMP_NUM_THREADS=1, a free localhost port,
every rank killed when its launch passes its timeout; a failed rank's
output is its `rank<r>.log` under the module's tmp dir). The 2-rank
cases run in one launch; the 4-rank cases in three launches one after
another (the kernels and MHA cases, the MoE cases, the scans), beside
the 2-rank launch, each with a timeout of `TIMEOUT` plus
`TIMEOUT_PER_CASE` a case, so a busy host stretches no launch past a
limit sized for fewer cases. The JAX
side runs in this process on 2 or 4 of the conftest's CPU devices
(`workersPerNode`) while the ranks run; the models' initial weights are
JAX's, carried to the ranks with `params_from_numpy`. Tolerance: rtol
1e-5, atol 1e-6 in f32 (the mesh files' RTOL, ATOL).

  - `ring_attention` and `ulysses_attention` alone on 2 and 4 ranks,
    causal and not: the output and the gradients of q, k and v against
    JAX's functions under shard_map (tests/test_kernels.py);
  - the MHA model of tests/test_sharding.py at sp 2 (ring, and Ulysses
    with FF_ATTENTION_IMPL=ulysses) and dp 2 x sp 2 (ring): the forward
    and 2 train steps against JAX's on the same mesh; a requested
    Ulysses whose local heads do not divide the seq axis ("sp_heads")
    and a ring whose sequence does not ("sp_shape") warn with JAX's
    reasons and still match one device; without a seq axis ("sp_mesh")
    both packages warn once per op and count every fallback
    (tests/test_workload_zoo.py);
  - the small MoE of tests/test_workload_zoo.py (4 experts, top-2,
    capacity factor 1.2) at expert 2 merged with data 2 (the searched
    winner partition_batch + partition_experts_alltoall makes: the
    all-to-all counted), solo expert 2 beside data 2 (the manual
    lowering) and expert 2 x fsdp 2: 2 steps, the losses and the
    weights against JAX's run of the same strategy;
  - searched winners with a seq axis (partition_seq_ring) and an expert
    axis run at their degrees (they used to raise), against one device;
  - the train scan: fit with iterations_per_dispatch 3 at dp 4, dp 2 x
    tp 2 and fsdp 2 (the overlapped sync on, as by default) against
    JAX's fit with the same value on the same mesh, and bit-equal to the
    port's stepwise fit on that mesh.
"""
import concurrent.futures
import contextlib
import functools
import json
import os
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu.models.misc import build_moe as jbuild_moe
from flexflow_tpu.models.transformer import build_transformer as jtransformer
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu_torch.runtime.mesh_run import launch
from flexflow_tpu_torch.runtime.weights import params_from_numpy, \
    params_to_numpy
from torch_mesh_cases import build as _build
from torch_mesh_cases import fixed_winner

RTOL, ATOL = 1e-5, 1e-6
# a launch's timeout: TIMEOUT + TIMEOUT_PER_CASE x its cases
TIMEOUT = 90
TIMEOUT_PER_CASE = 40
CASES = str(pathlib.Path(__file__).with_name("torch_mesh_cases.py"))
# the kernels alone: (b, s, h, d) and the ring's chunk
SPK = (2, 32, 4, 16)
SPK_CHUNK = 8
# the MHA model of tests/test_sharding.py (self-attention, then a dense)
ATT = {"batch": 4, "seq": 16, "embed": 32, "heads": 4}
# heads 3: Ulysses' local heads do not divide seq 2 ("sp_heads")
ATT3 = {"batch": 4, "seq": 16, "embed": 36, "heads": 3}
# seq 15: the sequence does not divide seq 2 ("sp_shape")
ATT15 = {"batch": 4, "seq": 15, "embed": 32, "heads": 4}
# the flagship Transformer, narrow, for the scan and the seq winner
TF = {"batch": 4, "seq": 16, "hidden": 32, "heads": 4, "layers": 2}
SCAN_SPD = 3
# (name, ranks, JAX degrees) of the MHA cases
SP_CASES = {"sp2_ring": (2, "ring", {"sequence_parallel_degree": 2}),
            "sp2_ulysses": (2, "ulysses", {"sequence_parallel_degree": 2}),
            "dp2sp2_ring": (4, "ring", {"sequence_parallel_degree": 2})}
# (name, ranks, batch, config, searched rewrites) of the MoE cases: the
# merged winner at batch 8 (capacity 5, which partition_batch(2) cannot
# shard, so the expert rewrite applies), the others at batch 16
# (capacity 10, which the expert degree divides)
MOE_CASES = {
    "moe_merged": (2, 8, {"search_budget": 1},
                   [["partition_batch", 2],
                    ["partition_experts_alltoall", 2]]),
    "moe_solo": (4, 16, {"expert_parallel_degree": 2}, None),
    "moe_ep2_fsdp2": (4, 16, {"expert_parallel_degree": 2,
                              "fsdp_degree": 2}, None),
}
SCAN_MESHES = {"dp4": {}, "dp2tp2": {"tensor_parallel_degree": 2},
               "fsdp2": {"fsdp_degree": 2}}
SPARSE = "sparse_categorical_crossentropy"


@contextlib.contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _jax_cfg(n, **kw):
    cfg = jff.FFConfig()
    cfg.workersPerNode, cfg.numNodes = n, 1
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _jax_att(n, kw, **cfg):
    m = jff.FFModel(_jax_cfg(n, batch_size=kw["batch"], **cfg))
    x = m.create_tensor((kw["batch"], kw["seq"], kw["embed"]),
                        jff.DataType.DT_FLOAT)
    t = m.multihead_attention(x, x, x, kw["embed"], kw["heads"])
    m.dense(t, kw["embed"])
    m.compile(jff.SGDOptimizer(lr=0.1),
              jff.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    return m


def _jax_moe(n, batch, rewrites=None, **cfg):
    m = jff.FFModel(_jax_cfg(n, batch_size=batch, **cfg))
    jbuild_moe(m, batch, input_dim=16, num_classes=4, num_exp=4,
               num_select=2, hidden=16, alpha=1.2)
    with fixed_winner(rewrites, "flexflow_tpu"):
        m.compile(jff.SGDOptimizer(lr=0.1),
                  jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [])
    return m


def _jax_tf(n, **cfg):
    m = jff.FFModel(_jax_cfg(n, batch_size=TF["batch"], **cfg))
    jtransformer(m, TF["batch"], TF["seq"], TF["hidden"], TF["heads"],
                 TF["layers"])
    m.compile(jff.SGDOptimizer(lr=0.01),
              jff.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE, [])
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


def _jax_params(m):
    return {op: {n: np.asarray(a) for n, a in ws.items()}
            for op, ws in m.state.params.items()}


class _Run:
    """One launch of `nprocs` ranks; `wait_s` bounds the wait for it, the
    launches queued ahead of it included."""

    def __init__(self, d, nprocs, future, names, wait_s):
        self.dir, self.nprocs, self.future = pathlib.Path(d), nprocs, future
        self.names, self.wait_s = set(names), wait_s

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
        return outs[0]

    def arrays(self, name):
        with np.load(self.dir / f"{name}.npz") as z:
            return {k: z[k] for k in z.files}


class _Group:
    """The launches of one rank count, read by case name."""

    def __init__(self, runs):
        self.runs = runs

    def _run(self, name):
        return next(r for r in self.runs if name in r.names)

    def result(self, name, rank=0):
        return self._run(name).result(name, rank)

    def ok(self, name):
        return self._run(name).ok(name)

    def arrays(self, name):
        return self._run(name).arrays(name)


def _att_data(kw, rng):
    shape = (2 * kw["batch"], kw["seq"], kw["embed"])
    return dict(x0=rng.randn(*shape).astype(np.float32),
                y=rng.randn(*shape).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """Build the JAX models whose weights the ranks start from, start both
    rank groups, then run the JAX references while they run."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcm, "load_default_calibration", lambda: None)
    request.addfinalizer(mp.undo)
    d = tmp_path_factory.mktemp("sp_expert_ranks")
    rng = np.random.RandomState(0)
    b, s, h, dh = SPK
    data = {"spk": {k: rng.randn(b, s, h, dh).astype(np.float32)
                    for k in ("q", "k", "v", "g")},
            "att": _att_data(ATT, rng), "att3": _att_data(ATT3, rng),
            "att15": _att_data(ATT15, rng),
            "tf": dict(x0=rng.randn(6 * TF["batch"], TF["seq"],
                                    TF["hidden"]).astype(np.float32),
                       y=rng.randn(6 * TF["batch"], TF["seq"],
                                   TF["hidden"]).astype(np.float32))}
    for batch in (8, 16):
        data[f"moe{batch}"] = dict(
            x0=rng.randn(2 * batch, 16).astype(np.float32),
            y=rng.randint(0, 4, (2 * batch, 1)).astype(np.int32))
    paths = {}
    for k, arrays in data.items():
        paths[k] = str(d / f"data_{k}.npz")
        np.savez(paths[k], **arrays)
    jax_models = {}
    for name, (n, _, cfg) in SP_CASES.items():
        jax_models[name] = _jax_att(n, ATT, **cfg)
    for name, (n, batch, cfg, rewrites) in MOE_CASES.items():
        jax_models[name] = _jax_moe(n, batch, rewrites, **cfg)
    for name, cfg in SCAN_MESHES.items():
        jax_models[f"scan_{name}"] = _jax_tf(4, iterations_per_dispatch=SCAN_SPD,
                                             **cfg)
    w = {k: _save_params(m, d / f"w_{k}.npz") for k, m in jax_models.items()}
    # (ranks, cases) of each launch: the 2-rank cases together, the
    # 4-rank ones in three launches
    groups = {"2": (2, []), "4_sp": (4, []), "4_moe": (4, []),
              "4_scan": (4, [])}
    for n in (2, 4):
        groups[f"{n}" if n == 2 else "4_sp"][1].append({
            "name": f"kernels{n}", "mode": "sp_kernels",
            "data": paths["spk"], "impls": ["ring", "ulysses"],
            "chunk_size": SPK_CHUNK})
    for name, (n, impl, cfg) in SP_CASES.items():
        groups["2" if n == 2 else "4_sp"][1].append({
            "name": name, "builder": "attention", "builder_kwargs": ATT,
            "config": dict(cfg, batch_size=ATT["batch"]),
            "env": {"FF_ATTENTION_IMPL": impl}, "weights": w[name],
            "data": paths["att"], "steps": 2, "lr": 0.1, "forward": True})
    for name, kw, impl in (("sp2_heads", ATT3, "ulysses"),
                           ("sp2_shape", ATT15, "ring")):
        groups["2"][1].append({
            "name": name, "builder": "attention", "builder_kwargs": kw,
            "config": {"batch_size": kw["batch"],
                       "sequence_parallel_degree": 2},
            "env": {"FF_ATTENTION_IMPL": impl},
            "data": paths["att3" if kw is ATT3 else "att15"], "steps": 2,
            "lr": 0.1})
    for name, (n, batch, cfg, rewrites) in MOE_CASES.items():
        groups["2" if n == 2 else "4_moe"][1].append({
            "name": name, "builder": "moe_small",
            "builder_kwargs": {"batch": batch},
            "config": dict(cfg, batch_size=batch), "rewrites": rewrites,
            "weights": w[name], "data": paths[f"moe{batch}"], "steps": 2,
            "lr": 0.1, "loss": SPARSE})
    groups["2"][1].append({
        "name": "seq_winner", "builder": "transformer", "builder_kwargs": TF,
        "config": {"batch_size": TF["batch"], "search_budget": 1,
                   "enable_sequence_parallel": True},
        "rewrites": [["partition_seq_ring", 2]],
        "env": {"FF_ATTENTION_IMPL": "ring"}, "data": paths["tf"],
        "steps": 2, "lr": 0.01})
    for name, cfg in SCAN_MESHES.items():
        for spd in (1, SCAN_SPD):
            groups["4_scan"][1].append({
                "name": f"scan_{name}_{spd}", "builder": "transformer",
                "builder_kwargs": TF,
                "config": dict(cfg, batch_size=TF["batch"],
                               iterations_per_dispatch=spd),
                "weights": w[f"scan_{name}"], "data": paths["tf"],
                "mode": "fit", "lr": 0.01})
    # one queue a rank count: the 4-rank launches run one after another
    # beside the 2-rank one, so at most 6 ranks run at once
    pools = {n: concurrent.futures.ThreadPoolExecutor(1) for n in (2, 4)}
    queued = {2: 0, 4: 0}
    out = {2: _Group([]), 4: _Group([])}
    for label, (n, cases) in groups.items():
        gd = d / f"group{label}"
        gd.mkdir()
        (gd / "spec.json").write_text(json.dumps(cases))
        timeout = TIMEOUT + TIMEOUT_PER_CASE * len(cases)
        queued[n] += timeout
        out[n].runs.append(_Run(gd, n, pools[n].submit(
            launch, n, ["--device", "cpu", CASES, str(gd / "spec.json"),
                        str(gd)], str(gd), timeout=timeout),
            [c["name"] for c in cases], queued[n] + 30))
    refs = {"kernels": {n: _jax_kernels(data["spk"], n) for n in (2, 4)}}
    for name, (n, impl, cfg) in SP_CASES.items():
        with _env(FF_ATTENTION_IMPL=impl):
            refs[name] = _jax_steps(jax_models[name], data["att"],
                                    ATT["batch"], 2, forward=True)
    for name, (n, batch, cfg, rewrites) in MOE_CASES.items():
        refs[name] = _jax_steps(jax_models[name], data[f"moe{batch}"],
                                batch, 2)
    for name in SCAN_MESHES:
        m = jax_models[f"scan_{name}"]
        m.fit(data["tf"]["x0"], data["tf"]["y"], epochs=1, verbose=False)
        refs[f"scan_{name}"] = _jax_params(m)
    yield {"runs": out, "data": data, "jax": jax_models, "refs": refs,
           "weights": w}
    for pool in pools.values():
        pool.shutdown(wait=True)


def _jax_kernels(arrs, n):
    """JAX's ring and Ulysses attention under shard_map over `n` devices
    (tests/test_kernels.py): {"<impl>_<causal>/<out|dq|dk|dv>": array}."""
    from jax.sharding import Mesh, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # jax < 0.5
        from jax.experimental.shard_map import shard_map

    from flexflow_tpu.kernels.attention import ring_attention, \
        ulysses_attention

    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    q, k, v, g = (jnp.asarray(arrs[x]) for x in ("q", "k", "v", "g"))
    out = {}
    for impl in ("ring", "ulysses"):
        for causal in (False, True):
            fn = (functools.partial(ring_attention, axis_name="sp",
                                    causal=causal, chunk_size=SPK_CHUNK)
                  if impl == "ring" else
                  functools.partial(ulysses_attention, axis_name="sp",
                                    causal=causal, interpret=True))
            sm = shard_map(fn, mesh=mesh,
                           in_specs=(P(None, "sp"),) * 3,
                           out_specs=P(None, "sp"))

            @jax.jit
            def with_grads(q, k, v, g, sm=sm):
                o, vjp = jax.vjp(sm, q, k, v)
                return (o,) + vjp(g)

            tag = f"{impl}_{int(causal)}"
            for name, a in zip(("out", "dq", "dk", "dv"),
                               with_grads(q, k, v, g)):
                out[f"{tag}/{name}"] = np.asarray(a)
    return out


def _jax_steps(m, data, batch, steps, forward=False):
    """`steps` train steps of JAX model `m` on consecutive batches:
    (losses, the forward of the first batch after them, weights)."""
    ex = m.executor
    step = ex.build_train_step(donate=False)
    st, losses = m.state, []
    for i in range(steps):
        xb = ex.shard_batch(ex.input_pts[0],
                            data["x0"][i * batch:(i + 1) * batch])
        yb = ex.put_replicated(data["y"][i * batch:(i + 1) * batch])
        st, partials = step(st, [xb], yb, ex.put_replicated(
            jax.random.PRNGKey(i)))
        losses.append(float(partials["loss"]))
    fwd = None
    if forward:
        fwd = np.asarray(ex.build_forward()(
            st.params, [ex.shard_batch(ex.input_pts[0],
                                       data["x0"][:batch])]))
    return losses, fwd, {op: {n: np.asarray(a) for n, a in ws.items()}
                         for op, ws in st.params.items()}


def _assert_weights(got, want, rtol=RTOL, atol=ATOL):
    n = 0
    for op, ws in want.items():
        for name, a in ws.items():
            np.testing.assert_allclose(got[f"w/{op}/{name}"],
                                       np.asarray(a, np.float32), rtol=rtol,
                                       atol=atol, err_msg=f"{op}.{name}")
            n += 1
    assert n > 0


def _one_device(builder, kw, data, steps, lr, loss="mse", weights=None,
                **cfg):
    """The port on one device: losses of `steps` steps and the weights."""
    m = tff.FFModel(tff.FFConfig(device="cpu", batch_size=kw["batch"],
                                 **cfg))
    _build(m, builder, kw)
    m.compile(tff.SGDOptimizer(lr=lr), loss, [])
    if weights is not None:
        params_from_numpy(m, _tree(weights))
    step = m.executor.build_train_step()
    bs, losses = kw["batch"], []
    for i in range(steps):
        m.state, partials = step(m.state, [data["x0"][i * bs:(i + 1) * bs]],
                                 data["y"][i * bs:(i + 1) * bs], i)
        losses.append(float(partials["loss"]))
    return losses, params_to_numpy(m)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sp_kernels_match_jax(runs, n, impl, causal):
    """ring_attention (K and V rotating round the group by point-to-point
    sends) and ulysses_attention (two all-to-alls around chunked
    attention on h/n heads) on each rank's sequence block: the output and
    the gradients of q, k and v, gathered whole, against JAX's functions
    under shard_map on n devices."""
    run = runs["runs"][n]
    run.ok(f"kernels{n}")
    got = run.arrays(f"kernels{n}")
    want = runs["refs"]["kernels"][n]
    tag = f"{impl}_{int(causal)}"
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[f"{tag}/{name}"],
                                   want[f"{tag}/{name}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{tag}/{name}")


@pytest.mark.parametrize("name", sorted(SP_CASES))
def test_mha_sequence_parallel_matches_jax(runs, name):
    """The MHA model at sp 2 (ring; Ulysses) and dp 2 x sp 2 (ring): the
    op runs per shard on (data, seq) blocks of the sequence, never
    falling back; the forward and 2 train steps match JAX's on the same
    mesh from the same weights."""
    n, impl, cfg = SP_CASES[name]
    run = runs["runs"][n]
    out = run.ok(name)
    assert out["mesh"]["seq"] == 2
    assert out["mesh"]["data"] == n // 2
    assert out["mesh_paths"] == {impl: 2}
    b = ATT["batch"] // (n // 2)
    s = ATT["seq"] // 2
    assert set(map(tuple, out["local_q"].values())) == {
        (b, s, ATT["heads"], ATT["embed"] // ATT["heads"])}
    assert not [w for w in out["warnings"] if "falls back" in w]
    losses, fwd, want = runs["refs"][name]
    np.testing.assert_allclose(out["losses"], losses, rtol=RTOL, atol=ATOL)
    got = run.arrays(name)
    np.testing.assert_allclose(got["f/out"], fwd, rtol=RTOL, atol=ATOL)
    _assert_weights(got, want)
    # every weight is replicated over "seq": its gradient is summed there
    assert out["collectives"].get("grad/all_reduce/seq", 0) > 0


@pytest.mark.parametrize("name,kw,data,reason", [
    ("sp2_heads", ATT3, "att3", "per-device head count divisible"),
    ("sp2_shape", ATT15, "att15", "batch, heads and seq divisible")])
def test_sp_fallbacks_warn_with_jax_reasons(runs, monkeypatch, name, kw,
                                            data, reason):
    """A requested Ulysses whose local heads (3) do not divide the seq
    axis warns "sp_heads", a ring whose sequence (15) does not divide it
    "sp_shape"; each warns once per op and runs chunked attention on the
    seq mesh, and 2 steps match one device's dense path."""
    monkeypatch.setenv("FF_ATTENTION_IMPL", "dense")
    want_losses, want = _one_device("attention", kw, runs["data"][data], 2,
                                    0.1)
    run = runs["runs"][2]
    out = run.ok(name)
    sp = [w for w in out["warnings"] if "sequence parallelism" in w]
    assert len(sp) == 1 and reason in sp[0], out["warnings"]
    assert "ring" not in out["mesh_paths"]
    assert "ulysses" not in out["mesh_paths"]
    assert out["mesh_paths"]["chunked"] == 2
    np.testing.assert_allclose(out["losses"], want_losses, rtol=RTOL,
                               atol=ATOL)
    _assert_weights(run.arrays(name), want)


def test_sp_mesh_fallback_counts_and_dedups(monkeypatch, tmp_path):
    """tests/test_workload_zoo.py's fallback test in both packages: with
    FF_ATTENTION_IMPL=ring and no seq-sharded mesh the op warns
    "sequence parallelism" once per op (a second call of the same op is
    silent, another op warns) and counts every call under
    ff_attention_fallback_total{reason="sp_mesh"}."""
    import torch

    from flexflow_tpu import obs as jobs
    from flexflow_tpu.ops import attention as jmha
    from flexflow_tpu.ops.registry import FwdCtx as JCtx
    from flexflow_tpu_torch import obs as tobs
    from flexflow_tpu_torch.ops import attention as tmha
    from flexflow_tpu_torch.ops.registry import FwdCtx as TCtx

    monkeypatch.setenv("FF_ATTENTION_IMPL", "ring")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 16).astype(np.float32)
    w = {n: (0.1 * rng.randn(*shape)).astype(np.float32) for n, shape in
         (("wq", (16, 2, 8)), ("wk", (16, 2, 8)), ("wv", (16, 2, 8)),
          ("wo", (2, 8, 16)), ("bias_o", (16,)))}
    counts = {}
    for pkg, mha, obs, ctx_cls, arr in (
            ("jax", jmha, jobs, JCtx, jnp.asarray),
            ("torch", tmha, tobs, TCtx, torch.from_numpy)):
        params = mha.MultiHeadAttentionParams(embed_dim=16, num_heads=2)
        weights = {n: arr(a) for n, a in w.items()}
        xs = [arr(x)] * 3
        if pkg == "jax":
            mha.reset_attention_fallback_warnings()
        else:
            mha._FALLBACK_WARNED.clear()
        kw = ({} if pkg == "jax" else
              {"flight_recorder": False, "anomaly_detection": False})
        with obs.session(obs.TelemetryConfig(dir=str(tmp_path / pkg),
                                             **kw)):
            with pytest.warns(UserWarning, match="sequence parallelism"):
                mha._forward(params, weights, xs, ctx_cls(op_name="layer0"))
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                mha._forward(params, weights, xs, ctx_cls(op_name="layer0"))
            with pytest.warns(UserWarning, match="layer1"):
                mha._forward(params, weights, xs, ctx_cls(op_name="layer1"))
            c = obs.active().metrics.find("ff_attention_fallback_total",
                                          reason="sp_mesh")
            counts[pkg] = c.value
    assert counts == {"jax": 3, "torch": 3}


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_expert_parallel_matches_jax(runs, name):
    """The small MoE at expert 2: merged with data 2 (the searched
    winner's all-to-all reshards the batch-sharded tokens onto hidden
    shards over "expert", the data axis renamed), solo beside data 2 (the
    manual lowering shards group_by's capacity dim over "expert") and
    with fsdp 2 (weights gathered on use): 2 steps with the balance loss
    match JAX's run of the same strategy; the dispatch mask is built on
    the gathered assignments."""
    n, batch, cfg, rewrites = MOE_CASES[name]
    run = runs["runs"][n]
    out = run.ok(name)
    jm = runs["jax"][name]
    assert {k: v for k, v in out["mesh"].items() if v > 1} == {
        k: int(v) for k, v in jm.executor.mesh.shape.items() if v > 1}
    assert out["mesh"]["expert"] == 2
    coll = out["collectives"]
    if rewrites:
        # the winner's one all-to-all a step, over the expert axis
        assert out["mesh"]["data"] == 1
        assert coll["act/all_to_all/expert"] == 2
        # the experts' kernels row-sharded over "expert"
        assert sum(p == ["S(0)"]
                   for p in out["weight_placements"].values()) == 4
    else:
        assert "act/all_to_all/expert" not in coll
    if "fsdp_degree" in cfg:
        assert coll["weight/all_gather/fsdp"] > 0
    assert out["gathered"]["dispatch_mask"] > 0
    losses, _, want = runs["refs"][name]
    np.testing.assert_allclose(out["losses"], losses, rtol=RTOL, atol=ATOL)
    _assert_weights(run.arrays(name), want)


def test_seq_winner_runs_at_its_degrees(runs):
    """The flagship's winner with a seq axis (partition_seq_ring, under
    enable_sequence_parallel) on 2 ranks: a "seq" axis of 2 (it used to
    raise), every attention op through the ring, and 2 steps match one
    device's."""
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setenv("FF_ATTENTION_IMPL", "dense")
    try:
        want_losses, want = _one_device("transformer", TF,
                                        runs["data"]["tf"], 2, 0.01)
    finally:
        monkeypatch.undo()
    run = runs["runs"][2]
    out = run.ok("seq_winner")
    assert {k: v for k, v in out["mesh"].items() if v > 1} == {"seq": 2}
    assert out["mesh_paths"] == {"ring": 2 * TF["layers"]}
    np.testing.assert_allclose(out["losses"], want_losses, rtol=RTOL,
                               atol=ATOL)
    _assert_weights(run.arrays("seq_winner"), want)


@pytest.mark.parametrize("mesh", sorted(SCAN_MESHES))
def test_scan_over_a_mesh(runs, mesh):
    """fit(iterations_per_dispatch=3) over 6 batches on a 4-rank mesh (dp
    4, dp 2 x tp 2, fsdp 2; the overlapped sync on by default) runs the
    train scan where it used to raise: bit-equal to the stepwise fit on
    the same mesh (the same collectives), and within rtol 1e-5 of JAX's
    fit with the same iterations_per_dispatch on the same mesh."""
    run = runs["runs"][4]
    scan = run.ok(f"scan_{mesh}_{SCAN_SPD}")
    step = run.ok(f"scan_{mesh}_1")
    assert scan["collectives"] == step["collectives"] != {}
    if mesh == "dp4":
        assert scan["overlap_issued_in_backward"] > 0
    a, b = (run.arrays(f"scan_{mesh}_{s}") for s in (SCAN_SPD, 1))
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    _assert_weights(a, runs["refs"][f"scan_{mesh}"])
