"""Serving and state over a device mesh in flexflow_tpu_torch, against the
JAX package: decode at a strategy's degrees, the batcher in lockstep
across ranks, checkpoints that re-shard, the canary and the verifier on
a mesh, and the dense op's local route under sequence parallelism.

The ranks run as gloo subprocesses (flexflow_tpu_torch/runtime/
mesh_run.py running tests/torch_mesh_cases.py, OMP_NUM_THREADS=1, a
150 s launch timeout that kills every rank; two rank groups at a time,
the 2-rank restore group after the 4-rank group that saves). The JAX
references run in this process on the conftest's CPU devices, their
weights carried into the port by name (`params_from_numpy`).

  - (a) the causal LM of tests/test_decode_search.py (vocab 29, width
    16, 2 heads) decodes through `compile_decode(strategy_path=...)` at
    tp 2 (heads over "model"), at tp 2 with the output dense's kernel
    sharded by rows, and at dp 2 (slots over "data") from one
    strategy_io file that both packages import: the tokens equal JAX's
    and the logits agree to atol 1e-4 (the tolerance of
    tests/test_torch_port_generate.py); each rank's KV cache holds half
    the heads (or slots); the collectives of a one-token step, counted
    by the executor, are every collective DTensor ran (CommDebugMode),
    none gathers a cache, and a column-sharded output that a row-sharded
    kernel reads is not gathered;
  - (b) `compile_decode()` searched on 4 ranks: the winner's views equal
    JAX's `decode_searched_views` and its cost is within rel 1e-12;
  - an attention built from primitive ops decodes through prefix caches
    at dp 2, and an encoder-decoder's greedy and beam generation at dp 2
    and tp 2 give one device's tokens;
  - (c) the batcher on 2 ranks with the decode executor swapped in: five
    ragged requests, each answer equal to `incremental_generate` on the
    same mesh and to JAX's tokens, on both ranks; `offer` on rank 1 is
    refused, naming rank 0; and six requests over a shared system prompt
    (two verbatim repeats): both ranks attach the same shared pages and
    take the same prefill-memo hits, with equal stats and page pools;
  - (d) a checkpoint saved at dp 2 x fsdp 2 with ZeRO-1 on 4 ranks
    restores bit-equal at tp 2 on 2 ranks and on one device without a
    group; a weight placed unevenly is restored replicated and named in
    `replicated` (as JAX's `_put_resharded` reports it); `fit
    (checkpoint_dir=)` stopped on one rank stops both, and resumed it is
    bit-equal to an uninterrupted run;
  - (e) a clean canaried `fit` is bit-equal to a plain one; a bit
    flipped on rank 1 alone raises CanaryMismatchError on both ranks;
    `fit(verify_strategy="preflight")` passes at dp 2 x tp 2;
  - serving follows weights that move under it (a `fit` step under the
    overlapped sync, a restore), under mixed precision, on one rank and
    at dp 2 and tp 2: each decode bit-equal to a fresh model's;
  - (f) the flagship's small cut at sp 2 (ring and Ulysses) takes the
    dense op's local route, gathers no dense operand, and trains
    bit-equal to the route through DTensor's matmul.
"""
import concurrent.futures
import json
import pathlib
import types

import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu_torch.parallel import strategies as tstrategies
from flexflow_tpu_torch.pcg.lowering import layers_to_pcg
from flexflow_tpu_torch.runtime.checkpoint import restore_checkpoint
from flexflow_tpu_torch.runtime.mesh_run import launch
from flexflow_tpu_torch.runtime.strategy_io import export_strategy
from flexflow_tpu_torch.runtime.weights import params_to_numpy
from torch_mesh_cases import build as _build

ATOL = 1e-4
COST_RTOL = 1e-12
TIMEOUT = 150
CASES = str(pathlib.Path(__file__).with_name("torch_mesh_cases.py"))
LM = {"batch": 2, "seq": 16, "vocab": 29, "hidden": 16, "heads": 2}
MAX_LEN, NEW = 16, 5
KINDS = ["tp", "tp_rows", "dp"]  # the decode strategies of `_strategy`
TF = {"batch": 4, "seq": 16, "hidden": 32, "heads": 4, "layers": 2}
S2S = {"batch": 2, "seq": 8, "hidden": 16, "heads": 2, "vocab": 23}
CKPT_OPT = {"lr": 0.1, "momentum": 0.9}
SPARSE = "sparse_categorical_crossentropy"


def _jax_lm(workers):
    cfg = jff.FFConfig()
    cfg.batch_size = LM["batch"]
    cfg.workersPerNode = workers
    m = jff.FFModel(cfg)
    ids = m.create_tensor((LM["batch"], LM["seq"]), jff.DataType.DT_INT32)
    t = m.embedding(ids, LM["vocab"], LM["hidden"],
                    jff.AggrMode.AGGR_MODE_NONE)
    t = m.multihead_attention(t, t, t, LM["hidden"], LM["heads"],
                              causal=True)
    t = m.dense(t, LM["hidden"], jff.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, LM["vocab"]))
    m.compile(jff.SGDOptimizer(lr=0.01),
              jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [jff.MetricsType.METRICS_ACCURACY])
    return m


def _jax_generate(ex, params, prompts, new):
    """tests/torch_mesh_cases.py `generate` on a JAX decode executor."""
    import jax.numpy as jnp

    bs, plen = prompts.shape
    init, step = ex.build_decode(bs, MAX_LEN)
    caches = init(params)
    out = np.zeros((bs, plen + new), np.int32)
    out[:, :plen] = prompts
    logits, caches = step(params, caches, jnp.int32(0),
                          [jnp.asarray(prompts)])
    rows = [np.asarray(logits)[:, -1]]
    out[:, plen] = rows[-1].argmax(-1)
    for t in range(plen, plen + new - 1):
        logits, caches = step(params, caches, jnp.int32(t),
                              [jnp.asarray(out[:, t:t + 1])])
        rows.append(np.asarray(logits)[:, 0])
        out[:, t + 1] = rows[-1].argmax(-1)
    return out, np.stack(rows)


def _strategy(path, kind):
    """A strategy_io file of the LM at degree 2: "tp" (heads, columns and
    the embedding's width over "model"), "tp_rows" (tp with the output
    dense's kernel sharded by rows instead, Megatron's pair with the
    hidden dense) or "dp" (the batch over "data")."""
    from flexflow_tpu_torch.ff_types import OperatorType

    m = tff.FFModel(tff.FFConfig(batch_size=LM["batch"], device="cpu"))
    _build(m, "lm", LM)
    graph, _ = layers_to_pcg(m.layers)
    if kind == "dp":
        tstrategies.apply_data_parallel(graph, 2, axis_idx=0)
    else:
        tstrategies.apply_tensor_parallel(graph, 2, axis_idx=1)
    if kind == "tp_rows":
        out = [op for op in graph.topo_order()
               if op.op_type == OperatorType.OP_LINEAR][-1]
        kernel = out.weights[0].dims
        kernel[0].degree, kernel[0].parallel_idx = 2, 1
        kernel[1].degree, kernel[1].parallel_idx = 1, -1
    export_strategy(graph, types.SimpleNamespace(views={}, cost=None), path)
    return path


def _machine_file(d, workers):
    p = d / f"machine_{workers}.cfg"
    p.write_text(f"num_nodes = 1\nnum_gpus_per_node = {workers}\n"
                 "intra_node_bandwidth = 90e9\ninter_node_bandwidth = 25e9\n")
    return str(p)


class _Run:
    def __init__(self, d, nprocs, future):
        self.dir, self.nprocs, self.future = pathlib.Path(d), nprocs, future

    def result(self, name, rank=0):
        self.future.result(timeout=2 * TIMEOUT + 60)
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
    d = tmp_path_factory.mktemp("mesh_serving")
    rng = np.random.RandomState(0)
    jm = _jax_lm(2)
    weights = {op: {n: np.asarray(a) for n, a in ws.items()}
               for op, ws in jm.state.params.items()}
    np.savez(d / "lm_weights.npz", **{f"{op}/{n}": a
                                     for op, ws in weights.items()
                                     for n, a in ws.items()})
    ordered = [op.name for op in jm.executor.topo if op.weights]
    np.savez(d / "lm_weights_pos.npz", **{
        f"{ordered.index(op)}/{n}": a for op, ws in weights.items()
        for n, a in ws.items()})
    prompts = rng.randint(0, LM["vocab"], (LM["batch"], 4)).astype(np.int32)
    np.savez(d / "prompts.npz", p=prompts, new=np.int64(NEW),
             src=rng.randint(0, S2S["vocab"], (2, S2S["seq"])).astype(
                 np.int32))
    requests = [[rng.randint(0, LM["vocab"], n).tolist(), k]
                for n, k in ((3, 5), (7, 3), (1, 6), (5, 4), (2, 2))]
    # a shared 8-token system prompt (two pages of 4) with suffixes, and
    # two verbatim repeats (their own generator: `rng`'s draws stay put)
    srng = np.random.RandomState(1)
    system = srng.randint(0, LM["vocab"], 8).tolist()
    shared = [[system + srng.randint(0, LM["vocab"], n).tolist(), k]
              for n, k in ((2, 4), (0, 5), (3, 3))]
    shared += [list(shared[0]), list(shared[1]), [system + [1], 4]]
    np.savez(d / "dense3.npz", x0=rng.randn(24, 12).astype(np.float32),
             y=rng.randint(0, 4, (24, 1)).astype(np.int32))
    np.savez(d / "mlp5.npz", x0=rng.randn(16, 12).astype(np.float32),
             y=rng.randint(0, 5, (16, 1)).astype(np.int32))
    np.savez(d / "lm_data.npz", x0=rng.randint(
        0, LM["vocab"], (LM["batch"], LM["seq"])).astype(np.int32),
        y=rng.randint(0, LM["vocab"], (LM["batch"], LM["seq"], 1)).astype(
            np.int32))
    data = {"prompts": prompts, "requests": requests, "shared": shared}
    serve = {"builder": "lm", "builder_kwargs": LM, "mode": "serve",
             "config": {"batch_size": LM["batch"]}, "loss": SPARSE,
             "weights": str(d / "lm_weights.npz"),
             "prompts": str(d / "prompts.npz"), "max_len": MAX_LEN}
    dense = {"builder": "dense_softmax", "builder_kwargs": {"batch": 8},
             "data": str(d / "dense3.npz"), "loss": SPARSE}
    ckpt = dict(dense, optimizer=CKPT_OPT, opt_state=True,
                path=str(d / "ck_dp2fsdp2"))
    mlp5 = {"builder": "mlp", "loss": SPARSE, "optimizer": CKPT_OPT,
            "builder_kwargs": {"batch": 8, "width": 12, "hidden": 16,
                               "classes": 5},
            "config": {"batch_size": 8}, "data": str(d / "mlp5.npz"),
            "path": str(d / "ck_mlp5"), "opt_state": True}
    moved = dict(serve, mode="serve_moved", data=str(d / "lm_data.npz"),
                 lr=0.5, config={"batch_size": LM["batch"],
                                 "allow_mixed_precision": True})
    sp = {"builder": "transformer", "builder_kwargs": TF, "steps": 2,
          "config": {"batch_size": 4, "sequence_parallel_degree": 2},
          "random_data": {"x_shapes": [[4, 16, 32]], "y_shape": [4, 16, 32],
                          "seed": 3}}
    four = [
        dict(ckpt, name="ckpt_save", mode="ckpt_save", steps=2,
             config={"batch_size": 8, "fsdp_degree": 2}),
        dict(serve, name="serve_searched", strategy=None,
             weights=str(d / "lm_weights_pos.npz"), weights_by_position=True,
             config={"batch_size": LM["batch"], "search_budget": 3,
                     "machine_model_file": _machine_file(d, 4)}),
        dict(dense, name="verify_dp2tp2", mode="fit",
             config={"batch_size": 8, "tensor_parallel_degree": 2},
             fit={"verify_strategy": "preflight"}),
    ]
    two = [
        dict(serve, name="serve_tp", strategy=_strategy(
            str(d / "tp.json"), "tp"),
            batcher={"slots": 2, "requests": requests}),
        dict(serve, name="serve_tp_shared", strategy=str(d / "tp.json"),
             batcher={"slots": 2, "requests": shared}, batcher_only=True),
        dict(serve, name="serve_dp", strategy=_strategy(
            str(d / "dp.json"), "dp")),
        dict(serve, name="serve_tp_rows", strategy=_strategy(
            str(d / "tp_rows.json"), "tp_rows")),
        dict(serve, name="serve_prim", builder="prim_lm", weights=None,
             compile_decode=False),
        *[{"name": f"seq2seq_{kind}", "builder": "seq2seq",
           "builder_kwargs": S2S, "mode": "seq2seq", "loss": "mse",
           "config": dict({"batch_size": 2}, **cfg), "new": NEW,
           "prompts": str(d / "prompts.npz")}
          for kind, cfg in (("dp", {}),
                            ("tp", {"tensor_parallel_degree": 2}))],
        *[dict(sp, name=f"sp_{impl}{route}", env={"FF_ATTENTION_IMPL": impl},
               **({"dense_route": "matmul"} if route else {}))
          for impl in ("ring", "ulysses") for route in ("", "_matmul")],
        dict(dense, name="fit_resume", mode="fit_resume", epochs=2,
             config={"batch_size": 8}, path=str(d / "ck_resume"),
             faults={"0": [["preempt", {"at_step": 3, "graceful": False}]]}),
        dict(dense, name="canary_clean", mode="canary",
             config={"batch_size": 8}),
        dict(dense, name="canary_flip", mode="canary",
             config={"batch_size": 8},
             faults={"1": [["bitflip", {"at_step": 1}]]}),
        dict(moved, name="serve_moved_dp", path=str(d / "ck_moved_dp")),
        dict(moved, name="serve_moved_tp", path=str(d / "ck_moved_tp"),
             strategy=str(d / "tp.json")),
    ]
    one = [dict(moved, name="serve_moved_one", path=str(d / "ck_moved_1"))]
    restore = [
        dict(ckpt, name="ckpt_restore_tp2", mode="ckpt_restore",
             config={"batch_size": 8, "tensor_parallel_degree": 2}),
        dict(mlp5, name="ckpt_save_mlp5", mode="ckpt_save", steps=1),
        dict(mlp5, name="ckpt_restore_uneven", mode="ckpt_restore",
             uneven=["op_linear_1", "kernel", 1]),
    ]
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

        out[name] = _Run(gd, n, pool.submit(go))

    start("four", 4, four)
    start("two", 2, two)
    start("one", 1, one)
    start("restore", 2, restore, after=out["four"])
    yield {"runs": out, "data": data, "jax": jm, "dir": d}
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_decode(runs):
    """JAX's decode of the prompts at tp 2, at tp 2 with the output
    dense row-sharded and at dp 2 (its decode executor over 2 CPU
    devices, the same strategy files), and its
    incremental_generate of every batcher request."""
    from flexflow_tpu.runtime import serving as jserving

    jm, d = runs["jax"], runs["dir"]
    out = {}
    for kind in KINDS:
        jm.compile_decode(strategy_path=str(d / f"{kind}.json"))
        out[kind] = _jax_generate(jm.decode_executor, jm.state.params,
                                  runs["data"]["prompts"], NEW)
    out["requests"] = [jserving.incremental_generate(
        jm, np.asarray(p, np.int32)[None], max_new_tokens=n,
        max_len=MAX_LEN)[0].tolist() for p, n in runs["data"]["requests"]]
    out["shared"] = [jserving.incremental_generate(
        jm, np.asarray(p, np.int32)[None], max_new_tokens=n,
        max_len=MAX_LEN)[0].tolist() for p, n in runs["data"]["shared"]]
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_decode_at_a_strategys_degrees_matches_jax(runs, jax_decode, kind):
    run = runs["runs"]["two"]
    outs = run.ok(f"serve_{kind}")
    axis = "data" if kind == "dp" else "model"
    assert outs[0]["decode_executor"] == "MeshExecutor"
    assert outs[0]["decode_mesh"][axis] == 2
    want_tokens, want_logits = jax_decode[kind]
    for o in outs:
        assert o["tokens"] == want_tokens.tolist()
        # the training executor (dp 2 by default) decodes the same
        assert o["inc_tokens"] == want_tokens.tolist()
        assert o["decode_paths"]["decode_local_map"] > 0
    np.testing.assert_allclose(run.arrays(f"serve_{kind}")["logits"],
                               want_logits, atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_each_rank_holds_its_strips_of_the_cache(runs, kind):
    """tp 2: every slot, one of the 2 heads; dp 2: one of the 2 slots,
    every head."""
    tp = kind != "dp"
    for o in runs["runs"]["two"].ok(f"serve_{kind}"):
        (k, v), = o["cache_local"].values()
        assert k == v
        assert k == ([2, MAX_LEN, 1, 8] if tp else [1, MAX_LEN, 2, 8])
        (pl,), = [set(p) for p in o["cache_placements"].values()]
        assert pl == ("S(2)" if tp else "S(0)")


@pytest.mark.parametrize("kind", KINDS)
def test_a_tokens_collectives_are_counted_and_gather_no_cache(runs, kind):
    """The executor counts every collective of a one-token step (DTensor
    ran no other: CommDebugMode's counts equal them): at tp 2 the
    attention output's all-reduce and the all-gathers of the two
    column-sharded outputs (embedding, hidden dense: the output dense's
    kernel is whole); with the output dense's kernel row-sharded the
    hidden dense's output stays sharded into it and its partial sums
    are all-reduced instead; at dp 2 the logits' all-gather. Nothing
    moves a KV cache ("kv/...")."""
    for o in runs["runs"]["two"].ok(f"serve_{kind}"):
        got = o["step_collectives"]
        want = {"tp": {"act/all_reduce/model": 1, "act/all_gather/model": 2},
                "tp_rows": {"act/all_reduce/model": 2,
                            "act/all_gather/model": 1},
                "dp": {"out/all_gather/data": 1}}[kind]
        assert got == want
        kinds = {"all_reduce": 0, "all_gather": 0}
        for k, v in got.items():
            kinds[k.split("/")[1]] += v
        comms = o["step_comms"]
        assert sum(comms.values()) == sum(got.values())
        assert comms.get("c10d_functional.all_reduce", 0) \
            == kinds["all_reduce"]
        assert not any(k.startswith("kv/") for k in got)


def test_primitive_attention_decodes_on_a_data_mesh(runs):
    """Attention built from primitive ops (batch_matmul, a baked tril
    mask, softmax) decodes through prefix caches held whole on every rank
    and the mask made beside the batch-sharded scores: at dp 2 its tokens
    equal one device's and its logits agree to 1e-5."""
    from torch_mesh_cases import generate

    run = runs["runs"]["two"]
    outs = run.ok("serve_prim")
    assert outs[0]["decode_mesh"]["data"] == 2
    m = tff.FFModel(tff.FFConfig(batch_size=LM["batch"], device="cpu"))
    _build(m, "prim_lm", LM)
    m.compile(loss_type=SPARSE)
    toks, logits, _, _ = generate(m.executor, m.params,
                                  runs["data"]["prompts"], NEW, MAX_LEN)
    for o in outs:
        assert o["tokens"] == toks.tolist()
    np.testing.assert_allclose(run.arrays("serve_prim")["logits"], logits,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_encoder_decoder_generation_on_a_mesh(runs, kind):
    """An encoder-decoder (cross-attention against encoder K/V projected
    once, position constants, layer norms) at dp 2 and at tp 2:
    `incremental_seq2seq_generate` and `incremental_beam_generate` (2
    beams, reordered on every rank's cache strips) give one device's
    tokens on every rank."""
    from flexflow_tpu_torch.runtime import serving

    outs = runs["runs"]["two"].ok(f"seq2seq_{kind}")
    assert outs[0]["mesh"]["data" if kind == "dp" else "model"] == 2
    m = tff.FFModel(tff.FFConfig(batch_size=2, device="cpu"))
    _build(m, "seq2seq", S2S)
    m.compile(loss_type="mse")
    with np.load(runs["dir"] / "prompts.npz") as z:
        src = z["src"]
    greedy = serving.incremental_seq2seq_generate(m, src, max_new_tokens=NEW)
    beams = serving.incremental_beam_generate(
        m, np.zeros((len(src), 1), np.int32), num_beams=2,
        max_new_tokens=NEW, encoder_ids=src)
    for o in outs:
        assert o["greedy"] == greedy.tolist()
        assert o["beams"] == beams.tolist()


def test_searched_decode_on_four_ranks_matches_jax(runs, monkeypatch,
                                                   jax_decode):
    """`compile_decode()` on a group of 4 searches for 4 devices: the
    winner's views and cost are JAX's for a 4-worker machine, every rank
    runs it, and it decodes JAX's tokens."""
    monkeypatch.setattr(jcm, "load_default_calibration", lambda: None)
    cfg = jff.FFConfig()
    cfg.batch_size, cfg.workersPerNode, cfg.search_budget = LM["batch"], 1, 3
    cfg.machine_model_file = _machine_file(runs["dir"], 4)
    jm = jff.FFModel(cfg)
    ids = jm.create_tensor((LM["batch"], LM["seq"]), jff.DataType.DT_INT32)
    t = jm.embedding(ids, LM["vocab"], LM["hidden"],
                     jff.AggrMode.AGGR_MODE_NONE)
    t = jm.multihead_attention(t, t, t, LM["hidden"], LM["heads"],
                               causal=True)
    t = jm.dense(t, LM["hidden"], jff.ActiMode.AC_MODE_RELU)
    jm.softmax(jm.dense(t, LM["vocab"]))
    jm.compile(jff.SGDOptimizer(lr=0.01),
               jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [jff.MetricsType.METRICS_ACCURACY])
    jm.compile_decode()
    pos = {op.guid: i for i, op in enumerate(jm.decode_graph.topo_order())}
    want = sorted((pos.get(g, -1), v.start_device_id, list(v.dim),
                   list(v.stride))
                  for g, v in jm.decode_searched_views.items())
    outs = runs["runs"]["four"].ok("serve_searched")
    for o in outs:
        assert o["decode_executor"] == "MeshExecutor"
        assert o["decode_views"] == [list(v) for v in want]
        np.testing.assert_allclose(o["decode_cost"],
                                   jm.decode_searched_cost, rtol=COST_RTOL)
        assert o["tokens"] == jax_decode["tp"][0].tolist()


def test_batcher_in_lockstep_answers_as_incremental_generate(runs,
                                                             jax_decode):
    """Every rank answers each request as `incremental_generate` and JAX
    do; rank 0's decisions go out as an object only in the iterations
    that admit a request or stop (one integer in the others)."""
    outs = runs["runs"]["two"].ok("serve_tp")
    n = len(runs["data"]["requests"])
    for o in outs:
        assert o["decode_strategy_active"]
        assert o["batcher"] == o["batcher_inc"] == jax_decode["requests"]
        assert o["batcher_stats"]["finished"] == n
        assert 2 <= o["batcher_object_broadcasts"] <= n + 1
        assert o["batcher_object_broadcasts"] < o["batcher_stats"][
            "iterations"]


def test_lockstep_batcher_shares_prefixes_on_every_rank(runs, jax_decode):
    """Shared prompt pages and prefill-memo hits in lockstep at tp 2: rank
    0's plan carries each admission's shared pages, the follower attaches
    the same pages, and its memo, seeing the same admissions in the same
    order, takes the same hits; every answer equals `incremental_generate`
    and JAX's, on both ranks."""
    outs = runs["runs"]["two"].ok("serve_tp_shared")
    for o in outs:
        assert o["decode_strategy_active"]
        assert o["batcher"] == o["batcher_inc"] == jax_decode["shared"]
        assert o["batcher_audit"]["ok"]
        assert o["batcher_audit"]["pages_resident"] == 0
    assert outs[0]["batcher_stats"] == outs[1]["batcher_stats"]
    assert outs[0]["batcher_pool"] == outs[1]["batcher_pool"]
    stats = outs[0]["batcher_stats"]
    assert stats["finished"] == len(runs["data"]["shared"])
    assert stats["prefix_hits"] >= 4 and stats["prefill_skips"] >= 2


def test_offer_on_a_follower_is_refused(runs):
    o = runs["runs"]["two"].ok("serve_tp")[1]
    assert "offer them on rank 0" in o["follower_offer"]


def _saved(runs):
    a = runs["runs"]["four"].arrays("ckpt_save")
    return {k: v for k, v in a.items() if k.startswith(("w/", "o/"))}


def test_checkpoint_reshards_onto_tensor_parallel_ranks(runs):
    """Saved at dp 2 x fsdp 2 (weights and their ZeRO-1 slots sharded) on
    4 ranks, restored at tp 2 on 2: every leaf bit-equal to the state
    gathered at save."""
    save = runs["runs"]["four"].ok("ckpt_save")[0]
    assert save["mesh"]["fsdp"] == 2 and any(
        "S(" in "".join(p) for p in save["weight_placements"].values())
    run = runs["runs"]["restore"]
    outs = run.ok("ckpt_restore_tp2")
    assert outs[0]["mesh"]["model"] == 2
    assert outs[0]["report"] == {"unmatched_model": [],
                                 "unmatched_checkpoint": [],
                                 "replicated": []}
    got = run.arrays("ckpt_restore_tp2")
    saved = _saved(runs)
    assert set(saved) <= set(got)
    for k, v in saved.items():
        assert np.array_equal(got[k], v), k


def test_checkpoint_restores_on_one_device(runs):
    runs["runs"]["four"].ok("ckpt_save")
    m = tff.FFModel(tff.FFConfig(batch_size=8, device="cpu"))
    _build(m, "dense_softmax", {"batch": 8})
    m.compile(tff.SGDOptimizer(**CKPT_OPT), SPARSE)
    restore_checkpoint(m, str(runs["dir"] / "ck_dp2fsdp2"),
                       strict_topology=False)
    assert m._restore_report["replicated"] == []
    saved = _saved(runs)
    for op, ws in params_to_numpy(m).items():
        for n, a in ws.items():
            assert np.array_equal(a, saved[f"w/{op}/{n}"]), (op, n)
    for k, tree in m.state.opt_state.items():
        if isinstance(tree, dict):
            for op, ws in tree.items():
                for n, t in ws.items():
                    assert np.array_equal(t.numpy(),
                                          saved[f"o/{k}/{op}/{n}"])


def test_uneven_weight_is_restored_replicated(runs):
    """A weight placed Shard over 2 ranks along its 5 columns (uneven) is
    restored replicated and named in `replicated`, with JAX's warning
    text; `_put_resharded` of 3 rows onto a 4-row Shard(0) placement
    replicates as JAX's does; the values are the saved ones."""
    run = runs["runs"]["restore"]
    outs = run.ok("ckpt_restore_uneven")
    for o in outs:
        assert o["report"]["replicated"] == ["op_linear_1/kernel"]
        assert o["restored_placements"]["op_linear_1/kernel"] == ["R"]
        assert o["put_placements"] == ["R"]
        assert o["put_value"] == np.arange(9.0).reshape(3, 3).tolist()
        assert any("replicating instead" in m for m in o["log"])
    saved = run.arrays("ckpt_save_mlp5")
    got = run.arrays("ckpt_restore_uneven")
    for k in saved:
        if k.startswith(("w/", "o/")):
            assert np.array_equal(got[k], saved[k]), k


def test_resumed_fit_on_a_mesh_is_bit_equal(runs):
    """A preemption on rank 0 alone stops both ranks before step 3; a
    fresh model resumed from the checkpoints ends bit-equal to one
    uninterrupted fit."""
    run = runs["runs"]["two"]
    outs = run.ok("fit_resume")
    for o in outs:
        assert o["errors"] == ["stopped: TrainingPreempted"]
    a = run.arrays("fit_resume")
    plain = {k[len("plain/"):]: v for k, v in a.items()
             if k.startswith("plain/")}
    assert plain
    for k, v in plain.items():
        assert np.array_equal(a[f"resumed/{k}"], v), k


def test_clean_canary_on_a_mesh_equals_plain_fit(runs):
    run = runs["runs"]["two"]
    for o in run.ok("canary_clean"):
        assert o["errors"] == []
    a = run.arrays("canary_clean")
    plain = {k[len("plain/"):]: v for k, v in a.items()
             if k.startswith("plain/")}
    for k, v in plain.items():
        assert np.array_equal(a[f"canary/{k}"], v), k


def test_a_bit_flipped_on_one_rank_fails_the_canary_on_every_rank(runs):
    for o in runs["runs"]["two"].ok("canary_flip"):
        assert o["errors"] == ["canary: CanaryMismatchError"]


def test_verify_preflight_on_a_dp_tp_mesh(runs):
    outs = runs["runs"]["four"].ok("verify_dp2tp2")
    assert (outs[0]["mesh"]["data"], outs[0]["mesh"]["model"]) == (2, 2)
    assert all(o["train_all"] > 0 for o in outs)


@pytest.mark.parametrize("name,group", [("one", "one"), ("dp", "two"),
                                        ("tp", "two")])
def test_serving_follows_weights_that_move(runs, name, group):
    """Under mixed precision (bf16 copies of the weights cached for
    serving), a model decodes, takes a `fit` step and decodes again, is
    restored from a checkpoint taken before the step and decodes again:
    on one rank, at dp 2 with the overlapped sync (each rank updates the
    slices it owns, then gathers them) and decoding at tp 2 (the
    weights placed anew for the decode executor). Each decode after a
    move is bit-equal to a fresh model's at the same weights, and the
    step moved the logits."""
    run = runs["runs"][group]
    outs = run.ok(f"serve_moved_{name}")
    assert outs[0]["executor"] == "MeshExecutor" and outs[0]["mixed"]
    assert (outs[0]["overlap_weights"] > 0) == (name != "one")
    a = run.arrays(f"serve_moved_{name}")
    assert not np.array_equal(a["fit"], a["before"])
    assert np.array_equal(a["fit"], a["fresh_fit"])
    assert np.array_equal(a["restored"], a["before"])


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_dense_runs_on_local_shards_when_the_sequence_is_sharded(runs,
                                                                 impl):
    run = runs["runs"]["two"]
    local = run.ok(f"sp_{impl}")
    matmul = run.ok(f"sp_{impl}_matmul")
    for o in local:
        assert o["mesh"]["seq"] == 2
        assert o["mesh_paths"][impl] > 0
        assert o["dense_routes"]["local"] > 0
        assert not any("linear" in k or "dense" in k for k in o["gathered"])
    for o in matmul:
        assert o["dense_routes"] == {}
    assert local[0]["losses"] == matmul[0]["losses"]
    a, b = run.arrays(f"sp_{impl}"), run.arrays(f"sp_{impl}_matmul")
    for k in a:
        assert np.array_equal(a[k], b[k]), k
