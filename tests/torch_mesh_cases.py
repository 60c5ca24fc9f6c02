"""The cases the multi-process mesh tests run on every rank.

`python -m flexflow_tpu_torch.runtime.mesh_run --device cpu
tests/torch_mesh_cases.py spec.json out_dir` runs, on each rank, each
case of a JSON spec in order:

    {"name": ..., "builder": "transformer" | "dense_softmax" | "bn_cnn"
     | "dropout_mlp" | "mlp" | "search_mlp" | "attention" | "bert"
     | "moe" | "moe_small" | "overlap_mlp" | "block_stack"
     | "nonuniform" | "budgeted" | "lm" | "prim_lm" | "seq2seq",
     "builder_kwargs": {...},
     "config": {FFConfig fields}, "config_by_rank": {"1": {...}},
     "rewrites": [[substitution generator, degree], ...] (the searched
     winner those rewrites make, `fixed_winner`; with a search budget),
     "env": {variables set for the case alone}, "loss": "mse" | ...,
     "metrics": [...], "lr": 0.01 (SGD's rate), "optimizer": {SGD's
     fields, or "adam": true and Adam's}, "weights": "<npz of op/weight>",
     "data": "<npz of x0, x1, ..., y>", "rank_data": "<npz rank 1+ use>",
     "init_weights": "<npz of op/weight>" (the weights `_compiled` starts
     from),
     "weights_by_position": true (the npz keys are "<i>/<weight>", i the
     op's place among the weighted ops in topo order: a searched winner
     whose op names differ between the packages),
     "random_data": {"x_shapes": [...], "y_shape": [...], "seed": 0},
     "mode": "steps" | "guard" | "fit" | "decode" | "verify"
     | "compile_decode" | "compile" | "var_mean" | "sp_kernels" | "gpipe"
     | "hybrid" | "serve" | "ckpt_save" | "ckpt_restore" | "fit_resume"
     | "canary" | "serve_moved" | "seq2seq" | "elastic_save"
     | "elastic_resume" | "slice_failover" | "hung_step" | "tuner_swap"
     | "shrunk_mesh",
     "steps": 3, "epochs": 1, "fit": {fit keywords},
     "same_batch": true (every step on the first batch),
     "guard": {"init_loss_scale": 4.0, "poison_step": 1} (StepGuardConfig's
     scale; the step whose gradients are poisoned, -1 for none),
     "forward": true (then the forward of the first batch),
     "opt_state": true (rank 0 also writes the optimizer slots whole),
     "faults": {"<rank>": [[site, {FaultInjector.inject keywords}]]} (a
     FaultInjector for that rank's fit; "fit" and "canary"),
     "dense_route": "matmul" (the dense op's product through DTensor's
     matmul, the route before `_local_product`)}

"steps" runs the executor's train step on the first `steps` batches
(every rank passes the SAME global batch; the step seed is the step
index; past the data, the batches repeat) and records each step's loss
and its seconds (the loss read synchronises); "guard" does so with the
step guard armed and the second step's gradients poisoned with NaN, and
records the global gradient norms and the skips; "fit" runs FFModel.fit;
"serve", "ckpt_save", "ckpt_restore", "fit_resume", "canary" and
"serve_moved" are the serving and state cases (`_serve_case`,
`_ckpt_restore_case`, `_fit_resume_case`, `_canary_case`,
`_serve_moved_case`); "elastic_save", "elastic_resume",
"slice_failover", "hung_step", "tuner_swap" and "shrunk_mesh" are the
elastic runtime's and the tuner's (`_elastic_save_case` ...
`_shrunk_mesh_case`);
"var_mean" runs parallel/mesh.py `var_mean` on DTensors of a seeded
array (no model) under CommDebugMode and records the collectives;
"sp_kernels" runs ring and Ulysses attention alone over the group
(`_sp_kernels_case`); "gpipe" runs the GPipe schedule alone
(`_gpipe_case`), "hybrid" builds a hybrid mesh (`_hybrid_case`), and
"verify" runs `verify_strategy` on the compiled model (its verdict).
With "forward", the serving forward of the first batch runs after them
(on the state's buffers) and rank 0 keeps its output whole.
Each rank writes `<out_dir>/<name>.rank<r>.json` (the error, if the case
raised, else the losses, the mesh, the gradient redistributes and the
executor's collectives, the attention mesh routes and local q shapes,
the ops run on gathered operands, each weight's local shape and
placements, and the overlapped sync's eligible weights, hooks, slot
shapes and schedule audit) and
rank 0 writes the final weights and buffers whole to
`<out_dir>/<name>.npz` (`params_to_numpy`: gathered, never one shard).
A case that raises is recorded and the next case runs; the warnings a
case raised are recorded with it. The tests build their one-device
references with the same `build`.
"""
import contextlib
import json
import os
import time
import traceback
import warnings


def build(model, name: str, kw: dict):
    """Build model `name` into `model`; a frontend model returns its
    PyTorchModel, whose weights are loaded after compile."""
    from flexflow_tpu_torch.ff_types import ActiMode, DataType

    if name == "transformer":
        from flexflow_tpu_torch.models import build_transformer

        build_transformer(model, kw["batch"], kw["seq"], kw["hidden"],
                          kw["heads"], kw["layers"])
    elif name == "dense_softmax":
        # tests/test_sharding.py test_dp_matches_single_device's model
        x = model.create_tensor((kw["batch"], 12), DataType.DT_FLOAT)
        t = model.dense(x, 16, ActiMode.AC_MODE_RELU)
        t = model.dense(t, 4)
        model.softmax(t)
    elif name == "dropout_mlp":
        # a Dropout op: its mask is drawn over the global shape
        x = model.create_tensor((kw["batch"], 12), DataType.DT_FLOAT)
        t = model.dense(x, 16, ActiMode.AC_MODE_RELU)
        t = model.dropout(t, 0.5)
        t = model.dense(t, 4)
        model.softmax(t)
    elif name == "mlp":
        x = model.create_tensor((kw["batch"], kw.get("width", 784)),
                                DataType.DT_FLOAT)
        t = model.dense(x, kw.get("hidden", 256), ActiMode.AC_MODE_RELU)
        t = model.dense(t, kw.get("classes", 10))
        model.softmax(t)
    elif name == "overlap_mlp":
        # tests/test_perf_overlap.py _small_model
        x = model.create_tensor((kw["batch"], 16), DataType.DT_FLOAT)
        t = model.dense(x, 32, ActiMode.AC_MODE_RELU)
        model.dense(t, 16, ActiMode.AC_MODE_NONE)
    elif name == "search_mlp":
        # tests/test_torch_port_search.py mlp_model: on a 4-worker machine
        # its winner is tensor parallel, with Combine ops
        x = model.create_tensor((kw["batch"], 512), DataType.DT_FLOAT)
        t = model.dense(x, 1024, ActiMode.AC_MODE_RELU)
        model.dense(t, 256)
    elif name == "bn_cnn":
        x = model.create_tensor((kw["batch"], 3, 8, 8), DataType.DT_FLOAT)
        t = model.conv2d(x, 8, 3, 3, 1, 1, 1, 1)
        t = model.batch_norm(t)
        t = model.pool2d(t, 2, 2, 2, 2, 0, 0)
        t = model.conv2d(t, 8, 3, 3, 1, 1, 1, 1)
        t = model.batch_norm(t)
        t = model.flat(t)
        t = model.dense(t, 10)
        model.softmax(t)
    elif name == "attention":
        e, h = kw["embed"], kw["heads"]
        x = model.create_tensor((kw["batch"], kw["seq"], e),
                                DataType.DT_FLOAT)
        t = model.multihead_attention(x, x, x, e, h,
                                      dropout=kw.get("dropout", 0.0),
                                      causal=kw.get("causal", False))
        model.dense(t, e)
    elif name == "moe":
        # the zoo's MoE: top-k gating, GroupBy's capacity-limited dispatch
        # over the whole batch, Aggregate with the balance loss
        from flexflow_tpu_torch.models import build_moe

        build_moe(model, kw["batch"], input_dim=32, num_classes=4,
                  num_exp=4, num_select=2, hidden=16, lambda_bal=0.04)
    elif name == "moe_small":
        # tests/test_workload_zoo.py _moe_graph's MoE: 4 experts, top-2,
        # capacity factor 1.2
        from flexflow_tpu_torch.models import build_moe

        build_moe(model, kw["batch"], input_dim=16, num_classes=4,
                  num_exp=4, num_select=2, hidden=16, alpha=1.2)
    elif name == "block_stack":
        # FFModel.transformer_blocks at the config's pipe degree
        x = model.create_tensor((kw["batch"], kw["seq"], kw["hidden"]),
                                DataType.DT_FLOAT)
        model.transformer_blocks(x, kw["hidden"], kw["heads"],
                                 kw["layers"], name="encoder_stack")
    elif name == "lm":
        # tests/test_decode_search.py build_lm: a causal LM
        from flexflow_tpu_torch.ff_types import AggrMode

        ids = model.create_tensor((kw["batch"], kw["seq"]),
                                  DataType.DT_INT32)
        t = model.embedding(ids, kw["vocab"], kw["hidden"],
                            AggrMode.AGGR_MODE_NONE)
        for _ in range(kw.get("layers", 1)):
            t = model.multihead_attention(t, t, t, kw["hidden"], kw["heads"],
                                          causal=True)
            t = model.dense(t, kw["hidden"], ActiMode.AC_MODE_RELU)
        model.softmax(model.dense(t, kw["vocab"]))
    elif name == "prim_lm":
        # chip_smoke.py build_primitive_decoder's block, small: attention
        # from dense, reshape, transpose, batch_matmul, a baked tril mask
        # and softmax (decoded through prefix caches)
        import numpy as np

        from flexflow_tpu_torch.ff_types import AggrMode

        b, n, d, h = kw["batch"], kw["seq"], kw["hidden"], kw["heads"]
        ids = model.create_tensor((b, n), DataType.DT_INT32)
        x = model.embedding(ids, kw["vocab"], d, AggrMode.AGGR_MODE_NONE)
        mask = np.where(np.tril(np.ones((n, n), bool)), 0.0, -1e9) \
            .astype(np.float32)[None, None]

        def heads(t):
            return model.transpose(model.reshape(model.dense(t, d),
                                                 (b, n, h, d // h)),
                                   (0, 2, 1, 3))

        q, k, v = heads(x), heads(x), heads(x)
        sc = model.batch_matmul(q, model.transpose(k, (0, 1, 3, 2)))
        sc = model.add(model.scalar_multiply(sc, 1.0 / np.sqrt(d // h)),
                       model.create_constant_tensor(mask, DataType.DT_FLOAT))
        a = model.batch_matmul(model.softmax(sc, axis=-1), v)
        a = model.reshape(model.transpose(a, (0, 2, 1, 3)), (b, n, d))
        x = model.layer_norm(model.add(x, model.dense(a, d)))
        model.softmax(model.dense(x, kw["vocab"]))
    elif name == "seq2seq":
        # tests/test_torch_port_generate.py build_seq2seq, one block a
        # side: an encoder, a causal decoder with cross-attention,
        # position constants
        import numpy as np

        from flexflow_tpu_torch.ff_types import AggrMode

        b, n, d, h, vocab = (kw[k] for k in ("batch", "seq", "hidden",
                                              "heads", "vocab"))
        src = model.create_tensor((b, n), DataType.DT_INT32)
        tgt = model.create_tensor((b, n), DataType.DT_INT32)
        pos = np.random.RandomState(9).randn(1, n, d).astype(np.float32)

        def embed(ids):
            e = model.embedding(ids, vocab, d, AggrMode.AGGR_MODE_NONE)
            return model.add(e, model.create_constant_tensor(
                pos, DataType.DT_FLOAT))

        e = embed(src)
        e = model.layer_norm(model.add(e, model.multihead_attention(
            e, e, e, d, h)))
        x = embed(tgt)
        x = model.layer_norm(model.add(x, model.multihead_attention(
            x, x, x, d, h, causal=True)))
        x = model.layer_norm(model.add(x, model.multihead_attention(
            x, e, e, d, h)))
        model.dense(x, vocab)
    elif name == "nonuniform":
        # tests/test_pipeline.py _build_nonuniform: a conv tower into an
        # MLP with a residual add (nothing a block stack expresses)
        x = model.create_tensor((kw["batch"], 3, 16, 16), DataType.DT_FLOAT)
        t = model.conv2d(x, 8, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
        t = model.pool2d(t, 2, 2, 2, 2, 0, 0)
        t = model.flat(t)
        t = model.dense(t, 64, ActiMode.AC_MODE_RELU)
        skip = t
        t = model.dense(t, 64)
        t = model.add(t, skip)
        model.dense(t, 10)
    elif name == "budgeted":
        # tests/test_pipeline.py _build_budgeted: a deep dense stack
        x = model.create_tensor((kw["batch"], kw["width"]),
                                DataType.DT_FLOAT)
        t = x
        for _ in range(kw["layers"]):
            t = model.dense(t, kw["width"], ActiMode.AC_MODE_RELU)
        t = model.dense(t, 10)
        model.softmax(t)
    elif name == "bert":
        # BERT through the PyTorch frontend: attention and hidden dropout
        import torch

        from flexflow_tpu_torch.frontends.torch import PyTorchModel
        from flexflow_tpu_torch.models import BertEncoder

        torch.manual_seed(0)
        module = BertEncoder(kw["layers"], kw["hidden"], kw["heads"],
                             kw["ffn"], kw["dropout"], kw["dropout"])
        x = model.create_tensor((kw["batch"], kw["seq"], kw["hidden"]))
        pt = PyTorchModel(module)
        pt.torch_to_ff(model, [x])
        # run_case loads the module's weights once the model is compiled
        return pt
    else:
        raise ValueError(f"unknown builder {name!r}")


@contextlib.contextmanager
def fixed_winner(rewrites, package="flexflow_tpu_torch"):
    """While open, the strategy search of `package` returns the graph
    that the substitutions `rewrites` ([[generator name, degree], ...],
    each applied once, its first rewrite taken) make of the model's
    lowering, priced by the search's own cost: a searched winner that
    does not depend on the costs. Nothing is patched for None."""
    if not rewrites:
        yield
        return
    import importlib

    sub = importlib.import_module(f"{package}.search.substitution")

    def optimize(self, graph, res):
        for name, degree in rewrites:
            graph = next(getattr(sub, name)(degree).apply(graph))
        return graph, self.search.graph_cost(graph, res)

    old = sub.GraphSearchHelper.graph_optimize
    sub.GraphSearchHelper.graph_optimize = optimize
    try:
        yield
    finally:
        sub.GraphSearchHelper.graph_optimize = old


# ops/linear.py's `_local_product`, which a "dense_route" case replaces
_LOCAL_PRODUCT: dict = {}


def run_case(case: dict, rank: int, device: str) -> dict:
    import numpy as np

    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                    SGDOptimizer)
    from flexflow_tpu_torch.ops import attention as att
    from flexflow_tpu_torch.parallel import mesh as pmesh
    from flexflow_tpu_torch.runtime.weights import (net_state_to_numpy,
                                                    params_from_numpy,
                                                    params_to_numpy)

    cfg_kw = dict(case.get("config", {}))
    cfg_kw.update(case.get("config_by_rank", {}).get(str(rank), {}))
    for k, v in case.get("env", {}).items():
        os.environ[k] = str(v)
    from flexflow_tpu_torch.ops import linear

    linear.ROUTES.clear()
    # the dense route of this case alone
    _LOCAL_PRODUCT.setdefault("fn", linear._local_product)
    linear._local_product = (
        (lambda x, w: None) if case.get("dense_route") == "matmul"
        else _LOCAL_PRODUCT["fn"])
    att.MESH_PATHS.clear()
    att.MESH_LOCAL_Q.clear()
    att._FALLBACK_WARNED.clear()
    pmesh.GATHERED.clear()
    if case.get("mode") == "var_mean":
        return _var_mean_case(case, rank, device)
    if case.get("mode") == "sp_kernels":
        return _sp_kernels_case(case, rank, device)
    if case.get("mode") == "gpipe":
        return _gpipe_case(case, rank, device)
    if case.get("mode") == "hybrid":
        return _hybrid_case(case, rank, device)
    if case.get("mode") in _MODES:
        return _MODES[case["mode"]](case, rank, device)
    model = FFModel(FFConfig(device=device, **cfg_kw))
    source = build(model, case["builder"], case.get("builder_kwargs", {}))
    opt = dict(case.get("optimizer", {"lr": case.get("lr", 0.01)}))
    opt = (AdamOptimizer(**{k: v for k, v in opt.items() if k != "adam"})
           if opt.get("adam") else SGDOptimizer(**opt))
    with fixed_winner(case.get("rewrites")):
        model.compile(opt, case.get("loss", "mse"), case.get("metrics", []))
    if source is not None:
        source.load_weights(model)
    weighted = [op.name for op in model.executor.topo if op.weights]
    if case.get("weights"):
        with np.load(case["weights"]) as z:
            tree = {}
            for key in z.files:
                op, n = key.split("/", 1)
                if case.get("weights_by_position"):
                    op = weighted[int(op)]
                tree.setdefault(op, {})[n] = z[key]
        params_from_numpy(model, tree)
    out: dict = {"losses": [], "opt_init": _slots(model)}
    data_path = case.get("data")
    if rank > 0 and case.get("rank_data"):
        data_path = case["rank_data"]
    xs, y = [], None
    if data_path:
        with np.load(data_path) as z:
            xs = [z[f"x{i}"] for i in range(sum(
                1 for f in z.files if f.startswith("x")))]
            y = z["y"]
    elif "random_data" in case:
        rd = case["random_data"]
        rng = np.random.RandomState(rd.get("seed", 0))
        xs = [rng.randn(*shape).astype(np.float32)
              for shape in rd["x_shapes"]]
        y = rng.randn(*rd["y_shape"]).astype(np.float32)
    mode = case.get("mode", "steps")
    ex = model.executor
    bs = model.config.batch_size
    if mode == "steps":
        step = ex.build_train_step()
        out["step_s"] = []
        for i in range(case.get("steps", 1)):
            j = 0 if case.get("same_batch") else i % max(1, len(y) // bs)
            batch = [a[j * bs:(j + 1) * bs] for a in xs + [y]]
            t0 = time.perf_counter()
            model.state, partials = step(model.state, batch[:-1], batch[-1],
                                         i)
            out["losses"].append(float(partials["loss"]))
            out["step_s"].append(time.perf_counter() - t0)
    elif mode == "guard":
        # the step guard armed, the second step's gradients poisoned
        import torch

        from flexflow_tpu_torch.runtime.resilience import StepGuardConfig

        gcfg = dict({"init_loss_scale": 4.0, "poison_step": 1},
                    **case.get("guard", {}))
        ex.set_step_guard(StepGuardConfig(
            init_loss_scale=gcfg["init_loss_scale"]))
        model.state.guard = ex.init_guard_state()
        step = ex.build_train_step()
        out["grad_norms"], out["skipped"] = [], []
        for i in range(case.get("steps", 1)):
            j = 0 if case.get("same_batch") else i
            batch = [a[j * bs:(j + 1) * bs] for a in xs + [y]]
            poison = torch.tensor(
                float("nan") if i == gcfg["poison_step"] else 1.0,
                device=ex.device)
            model.state, partials = step(model.state, batch[:-1], batch[-1],
                                         i, poison)
            out["losses"].append(float(partials["loss"]))
            out["grad_norms"].append(float(partials["grad_norm"]))
            out["skipped"].append(float(partials["skipped"]))
    elif mode == "fit":
        pm = model.fit(xs, y, batch_size=bs, epochs=case.get("epochs", 1),
                       verbose=rank == 0, fault_injector=_faults(case, rank),
                       **case.get("fit", {}))
        out["train_all"] = pm.train_all
    elif mode == "verify":
        from flexflow_tpu_torch.runtime.verify import verify_strategy

        v = verify_strategy(model, (xs, y), steps=case.get("steps", 2))
        out["verdict"] = {"ok": v.ok, "steps": v.steps,
                          "loss_diffs": v.loss_diffs,
                          "max_param_diff": v.max_param_diff,
                          "diverging_op": v.diverging_op}
    elif mode == "decode":
        ex.build_decode(bs, 4)
    elif mode == "compile_decode":
        model.compile_decode()
    elif mode == "serve":
        out.update(_serve_case(case, model, rank))
    elif mode == "ckpt_save":
        for i in range(case.get("steps", 1)):
            batch = [a[i * bs:(i + 1) * bs] for a in xs + [y]]
            model.state, _ = ex.build_train_step()(model.state, batch[:-1],
                                                   batch[-1], i)
        from flexflow_tpu_torch.runtime.checkpoint import save_checkpoint

        save_checkpoint(model, case["path"])
    elif mode == "seq2seq":
        out.update(_seq2seq_case(case, model, rank))
    elif mode == "ckpt_restore":
        out.update(_ckpt_restore_case(case, model, rank))
    mesh = ex.mesh
    out.update(
        mesh=None if mesh is None else mesh.shape,
        replicas=getattr(mesh, "replicas", 1),
        executor=type(ex).__name__,
        grad_syncs=getattr(ex, "grad_syncs", 0),
        collectives=dict(getattr(ex, "collectives", {})),
        overlap_issued_in_backward=getattr(
            ex, "overlap_issued_in_backward", 0),
        overlap_weights=sorted(f"{op}/{n}"
                               for op, n in ex._overlap_specs()),
        opt_slots=_slots(model),
        mesh_paths=dict(att.MESH_PATHS),
        dense_routes=dict(linear.ROUTES),
        local_q=dict(att.MESH_LOCAL_Q),
        gathered=dict(pmesh.GATHERED),
        searched_pipeline_degree=model.searched_pipeline_degree,
        pipe_ticks=ex._pipe_ticks,
        pipeline_stages=(None if ex.pipeline_plan is None else
                         [[op.name for op in st]
                          for st in ex.pipeline_plan.stages]),
        weight_digest=_digest(model),
        searched_views=None if model.searched_views is None else sorted(
            (pos, v.start_device_id, list(v.dim), list(v.stride))
            for pos, v in _views_by_position(model)),
        local_shapes={f"{op}/{n}": list(pmesh.local(w).shape)
                      for op, ws in model.params.items()
                      for n, w in ws.items()},
        weight_placements={
            f"{op}/{n}": [str(p) for p in getattr(w, "placements", ())]
            for op, ws in model.params.items() for n, w in ws.items()})
    if case.get("schedule"):
        # the analyzer's audit of the overlapped step's schedule, then
        # the schedule with the overlapped sync off
        from flexflow_tpu_torch.analysis.schedule import \
            schedule_race_diagnostics

        sched = ex.overlap_schedule()
        out["schedule_len"] = 0 if sched is None else len(sched)
        out["schedule_ok"] = (sched is not None
                              and schedule_race_diagnostics(sched).ok)
        ex.set_overlap_grad_sync(False)
        out["schedule_off"] = ex.overlap_schedule() is None
    fwd = None
    if case.get("forward"):
        fwd = ex.build_forward()(model.params, [a[:bs] for a in xs],
                                 model.state.net_state)
        fwd = fwd.detach().float().cpu().numpy()
    weights = params_to_numpy(model)
    buffers = net_state_to_numpy(model)
    extra = out.pop("serve_arrays", {})
    if rank == 0:
        arrays = {f"w/{op}/{n}": a for op, ws in weights.items()
                  for n, a in ws.items()}
        arrays.update({f"p/{weighted.index(op)}/{n}": a
                       for op, ws in weights.items() for n, a in ws.items()})
        arrays.update({f"s/{op}/{n}": a for op, bufs in buffers.items()
                       for n, a in bufs.items()})
        if fwd is not None:
            arrays["f/out"] = fwd
        arrays.update(extra)
        out["arrays"] = arrays
    if case.get("opt_state"):
        # every rank joins the gathers; rank 0 keeps them
        slots = {f"o/{k}/{op}/{n}": pmesh.full(t).detach().cpu().numpy()
                 for k, tree in model.state.opt_state.items()
                 if isinstance(tree, dict)
                 for op, ws in tree.items() for n, t in ws.items()}
        if rank == 0:
            out["arrays"].update(slots)
    return out


def _faults(case, rank):
    """This rank's FaultInjector of `case["faults"]`, or None."""
    plans = case.get("faults", {}).get(str(rank))
    if not plans:
        return None
    from flexflow_tpu_torch.runtime.resilience import FaultInjector

    fi = FaultInjector()
    for site, kw in plans:
        fi.inject(site, **kw)
    return fi


def generate(ex, params, prompts, new, max_len):
    """`incremental_generate`'s loop over executor `ex` (its prefill, then
    one token a step at per-row positions): (tokens, each step's logits
    of the position it predicts from, (b, vocab) f32, stacked), the
    caches and the step."""
    import numpy as np

    from flexflow_tpu_torch.parallel.mesh import local

    bs, plen = prompts.shape
    total = plen + new
    init, step = ex.build_decode(bs, max_len)
    caches = init(params)
    out = np.zeros((bs, total), np.int32)
    out[:, :plen] = prompts
    logits, caches = step(params, caches, 0, [prompts])
    rows = [local(logits)[:, -1].float().numpy()]
    out[:, plen] = rows[-1].argmax(-1)
    for t in range(plen, total - 1):
        logits, caches = step(params, caches, np.full(bs, t, np.int32),
                              [out[:, t:t + 1]])
        rows.append(local(logits)[:, 0].float().numpy())
        out[:, t + 1] = rows[-1].argmax(-1)
    return out, np.stack(rows), caches, step


def _serve_case(case, model, rank):
    """compile_decode (from `case["strategy"]`, a strategy_io file, else
    searched), then on the decode executor `generate` over the prompts
    of `case["prompts"]` (its tokens and logits, each attention cache's
    local shape and placements, the collectives one more one-token step
    ran, counted by the executor and seen by CommDebugMode),
    `incremental_generate` on the training executor, and with
    `case["batcher"]` ({"requests": [[prompt, new], ...], "slots"}) the
    continuous batcher in lockstep: rank 0 offers the requests, another
    rank's `offer` is refused; every rank's answers (a follower's
    mirrors), the iterations that broadcast decisions as an object, its
    stats, page-pool counters and audit, and `incremental_generate` of
    each request on the mesh. `case["batcher_only"]` runs compile_decode
    and the batcher alone."""
    import collections

    import numpy as np
    from torch.distributed.tensor.debug import CommDebugMode

    from flexflow_tpu_torch.ops import attention as att
    from flexflow_tpu_torch.parallel.mesh import local
    from flexflow_tpu_torch.runtime import serving

    out = {}
    dex = (model.compile_decode(strategy_path=case.get("strategy"))
           if case.get("compile_decode", True) else model.executor)
    bat = case.get("batcher")
    if case.get("batcher_only"):
        out.update(_batcher_case(model, rank, bat, case["max_len"]))
        return out
    out["decode_mesh"] = dex.mesh.shape
    out["decode_executor"] = type(dex).__name__
    out["decode_cost"] = model.decode_searched_cost
    graph = model.decode_graph or model.graph
    pos = {op.guid: i for i, op in enumerate(graph.topo_order())}
    out["decode_views"] = sorted(
        (pos.get(g, -1), v.start_device_id, list(v.dim), list(v.stride))
        for g, v in (model.decode_searched_views or {}).items())
    with np.load(case["prompts"]) as z:
        prompts, new = z["p"], int(z["new"])
    max_len = case["max_len"]
    att.MESH_PATHS.clear()
    toks, logits, caches, step = generate(dex, model.params, prompts, new,
                                          max_len)
    out["tokens"] = toks.tolist()
    out["decode_paths"] = dict(att.MESH_PATHS)
    out["cache_local"] = {op: [list(local(c).shape) for c in kv]
                          for op, kv in caches["mha"].items()}
    out["cache_global"] = {op: [list(c.shape) for c in kv]
                           for op, kv in caches["mha"].items()}
    out["cache_placements"] = {
        op: [str(p) for p in kv[0].placements]
        for op, kv in caches["mha"].items()}
    # one more one-token step, its collectives counted both ways
    t = prompts.shape[1] + new - 1
    before = collections.Counter(dex.collectives)
    with CommDebugMode() as comm:
        step(model.params, caches, np.full(len(toks), t, np.int32),
             [toks[:, -1:]])
    out["step_collectives"] = dict(collections.Counter(dex.collectives)
                                   - before)
    out["step_comms"] = {str(k): v for k, v in
                         comm.get_comm_counts().items()}
    out["inc_tokens"] = serving.incremental_generate(
        model, prompts, max_new_tokens=new, max_len=max_len).tolist()
    out["serve_arrays"] = {"logits": logits}
    if bat:
        out.update(_batcher_case(model, rank, bat, max_len))
    return out


def _batcher_case(model, rank, bat, max_len):
    """The continuous batcher in lockstep (`_serve_case`)."""
    import numpy as np

    from flexflow_tpu_torch.runtime import serving

    out = {}
    q = serving.AdmissionQueue(16)
    b = serving.ContinuousBatcher(model, serving.ServingConfig(
        max_len=max_len, slots=bat["slots"], page_size=4), q)
    out["decode_strategy_active"] = b.decode_strategy_active
    # the iterations that broadcast rank 0's decisions as an object
    sent = []
    plain_broadcast = serving.rdist.broadcast_object
    serving.rdist.broadcast_object = lambda *a: sent.append(1) or \
        plain_broadcast(*a)
    b.start()
    reqs = [serving.GenerationRequest(np.asarray(p, np.int32), n,
                                      deadline_s=120.0)
            for p, n in bat["requests"]]
    if rank == 0:
        for r in reqs:
            q.offer(r)
        answers = [r.result(timeout=120).tolist() for r in reqs]
    else:
        try:
            q.offer(reqs[0])
            out["follower_offer"] = "accepted"
        except serving.ServingConfigError as e:
            out["follower_offer"] = str(e)
    b.stop(timeout=120)
    serving.rdist.broadcast_object = plain_broadcast
    out["batcher_object_broadcasts"] = len(sent)
    if rank != 0:
        answers = [m.result(timeout=1).tolist()
                   for m in b.mirrors.values()]
    out["batcher"] = answers
    out["batcher_stats"] = dict(b.stats)
    out["batcher_pool"] = dict(b.pool.stats)
    out["batcher_audit"] = b.pool.audit().to_dict()
    out["batcher_inc"] = [serving.incremental_generate(
        model, np.asarray(p, np.int32)[None], max_new_tokens=n,
        max_len=max_len)[0].tolist() for p, n in bat["requests"]]
    return out


def _ckpt_restore_case(case, model, rank):
    """restore_checkpoint(case["path"]) into the compiled model, matching
    weights by name (the strategies differ); with `case["uneven"]` the
    named weight first re-placed `Shard(dim)` over the mesh's first axis,
    a placement its shape does not divide. The report, the checkpoint
    module's log, and `_put_resharded` of an uneven array on its own."""
    import torch
    from torch.distributed.tensor import Shard

    from flexflow_tpu_torch.parallel import mesh as pmesh
    from flexflow_tpu_torch.runtime import checkpoint as ck

    import logging

    out = {"log": []}
    handler = logging.Handler()
    handler.emit = lambda rec: out["log"].append(rec.getMessage())
    logging.getLogger("flexflow_tpu_torch.runtime.checkpoint").addHandler(
        handler)
    mesh = model.executor.mesh
    uneven = case.get("uneven")
    if uneven:
        op, n, dim = uneven
        w = model.state.params[op][n]
        pl = [Shard(dim)] + list(w.placements[1:])
        model.state.params[op][n] = pmesh.distribute(
            pmesh.full(w).detach(), mesh, pl)
        like = pmesh.distribute(torch.zeros(4, 3), mesh,
                                [Shard(0)] + list(mesh.replicate()[1:]))
        put = ck._put_resharded(
            torch.arange(9, dtype=torch.float32).reshape(3, 3), like)
        out["put_placements"] = [str(p) for p in put.placements]
        out["put_value"] = pmesh.full(put).tolist()
    try:
        out["step"] = ck.restore_checkpoint(model, case["path"],
                                            strict_topology=False)
    finally:
        logging.getLogger("flexflow_tpu_torch.runtime.checkpoint") \
            .removeHandler(handler)
    out["report"] = model._restore_report
    out["restored_placements"] = {
        f"{op}/{n}": [str(p) for p in w.placements]
        for op, ws in model.state.params.items() for n, w in ws.items()}
    return out


def _seq2seq_case(case, model, rank):
    """`incremental_seq2seq_generate` and `incremental_beam_generate` (2
    beams) on the compiled encoder-decoder over the case's source ids:
    the tokens, and the decode mesh."""
    import numpy as np

    from flexflow_tpu_torch.runtime import serving

    with np.load(case["prompts"]) as z:
        src = z["src"]
    return {"greedy": serving.incremental_seq2seq_generate(
                model, src, max_new_tokens=case["new"]).tolist(),
            "beams": serving.incremental_beam_generate(
                model, np.zeros((len(src), 1), np.int32), num_beams=2,
                max_new_tokens=case["new"], encoder_ids=src).tolist()}


def _fit_resume_case(case, rank, device):
    """`fit(checkpoint_dir=...)` stopped by `case["faults"]` (a preemption
    on one rank stops every rank), then a fresh model resumed from the
    directory to the end, against one fit without a stop: each rank's
    error, and rank 0 writes both runs' weights ("resumed/...",
    "plain/...")."""
    from flexflow_tpu_torch.runtime.weights import params_to_numpy

    out = {"errors": []}
    xs, y = _case_data(case)
    arrays = {}
    for run, kw in (("stopped", {"fault_injector": _faults(case, rank)}),
                    ("resumed", {}), ("plain", None)):
        model = _compiled(case, device)
        fit_kw = {} if kw is None else dict(
            kw, checkpoint_dir=case["path"], checkpoint_every_n_steps=1)
        try:
            model.fit(xs, y, batch_size=model.config.batch_size,
                      epochs=case.get("epochs", 2), verbose=False, **fit_kw)
        except Exception as e:  # recorded: the stopped run raises
            out["errors"].append(f"{run}: {type(e).__name__}")
        if run != "stopped":
            arrays.update({f"{run}/{op}/{n}": a for op, ws in
                           params_to_numpy(model).items()
                           for n, a in ws.items()})
    return dict(out, arrays=arrays) if rank == 0 else out


def _canary_case(case, rank, device):
    """A canaried `fit` (every step re-executed and compared bitwise)
    with this rank's `case["faults"]`, against a plain fit: each rank's
    error type, and rank 0 writes both runs' weights ("canary/...",
    "plain/...")."""
    from flexflow_tpu_torch.runtime.verify import CanaryConfig
    from flexflow_tpu_torch.runtime.weights import params_to_numpy

    out = {"errors": []}
    xs, y = _case_data(case)
    arrays = {}
    for run in ("canary", "plain"):
        model = _compiled(case, device)
        kw = {} if run == "plain" else {
            "canary": CanaryConfig(every_n_steps=1),
            "fault_injector": _faults(case, rank)}
        try:
            model.fit(xs, y, batch_size=model.config.batch_size,
                      epochs=case.get("epochs", 1), verbose=False, **kw)
        except Exception as e:  # recorded: a flipped bit raises
            out["errors"].append(f"{run}: {type(e).__name__}")
        arrays.update({f"{run}/{op}/{n}": a for op, ws in
                       params_to_numpy(model).items() for n, a in ws.items()})
    return dict(out, arrays=arrays) if rank == 0 else out


def _serve_moved_case(case, rank, device):
    """Serving while the weights move under it: the case's model (its
    config: mixed precision, the mesh's overlapped sync) decodes the
    prompts through `case["strategy"]`'s decode executor (its own
    executor without one), is saved, takes one `fit` step and decodes
    again, is restored and decodes again. Each later decode is held
    bit for bit against a fresh model's at the same weights on the same
    mesh (the saved weights: the first decode). Rank 0 writes the
    decodes' logits ("before", "fit", "fresh_fit", "restored")."""
    import numpy as np

    from flexflow_tpu_torch.runtime.checkpoint import (restore_checkpoint,
                                                       save_checkpoint)
    from flexflow_tpu_torch.runtime.weights import (params_from_numpy,
                                                    params_to_numpy)

    with np.load(case["prompts"]) as z:
        prompts, new = z["p"], int(z["new"])
    xs, y = _case_data(case)

    def served(seed_weights=None):
        model = _compiled(case, device)
        if seed_weights is not None:
            params_from_numpy(model, seed_weights)
        dex = (model.compile_decode(strategy_path=case["strategy"])
               if case.get("strategy") else model.executor)
        return model, lambda: generate(dex, model.params, prompts, new,
                                       case["max_len"])[1]

    with np.load(case["weights"]) as z:
        seed = {}
        for key in z.files:
            op, n = key.split("/", 1)
            seed.setdefault(op, {})[n] = z[key]
    model, decode = served(seed)
    logits = {"before": decode()}
    save_checkpoint(model, case["path"])
    model.fit(xs, y, batch_size=model.config.batch_size, epochs=1,
              verbose=False)
    logits["fit"] = decode()
    logits["fresh_fit"] = served(params_to_numpy(model))[1]()
    restore_checkpoint(model, case["path"])
    logits["restored"] = decode()
    ex = model.executor
    out = {"mesh": ex.mesh.shape, "executor": type(ex).__name__,
           "overlap_weights": len(ex._overlap_specs()),
           "mixed": model.config.allow_mixed_precision}
    return dict(out, arrays=logits) if rank == 0 else out


def _compiled(case, device):
    """A fresh model of `case` ("builder", "config", "optimizer"/"lr",
    "loss"), compiled: every one starts from the same seeded weights, or
    from `case["init_weights"]` (an npz of "<op>/<weight>") where given."""
    import numpy as np

    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.runtime.weights import params_from_numpy

    model = FFModel(FFConfig(device=device, **case.get("config", {})))
    build(model, case["builder"], case.get("builder_kwargs", {}))
    opt = dict(case.get("optimizer", {"lr": case.get("lr", 0.01)}))
    model.compile(SGDOptimizer(**opt), case.get("loss", "mse"))
    if case.get("init_weights"):
        with np.load(case["init_weights"]) as z:
            tree = {}
            for key in z.files:
                op, n = key.split("/", 1)
                tree.setdefault(op, {})[n] = z[key]
        params_from_numpy(model, tree)
    return model


def _case_data(case):
    import numpy as np

    with np.load(case["data"]) as z:
        xs = [z[f"x{i}"] for i in range(sum(
            1 for f in z.files if f.startswith("x")))]
        return xs, z["y"]


def _params_arrays(model, prefix):
    """{"<prefix>/<op>/<weight>": a copy of the weight whole (every rank
    joins the gathers; a copy: on the CPU the array would share the
    weight's memory, which later steps update in place)."""
    import numpy as np

    from flexflow_tpu_torch.runtime.weights import params_to_numpy

    return {f"{prefix}/{op}/{n}": np.array(a, copy=True) for op, ws in
            params_to_numpy(model).items() for n, a in ws.items()}


def _elastic_save_case(case, rank, device):
    """`fit(checkpoint_dir=..., checkpoint_every_n_steps=1)` stopped by
    this rank's `case["faults"]` (a host loss): the error raised ("raised"), its surviving
    devices and checkpoint, and the newest checkpoint's sidecar topology.
    Rank 0 writes the weights at the stop ("stopped/...")."""
    from flexflow_tpu_torch.runtime.checkpoint import load_checkpoint_meta

    xs, y = _case_data(case)
    model = _compiled(case, device)
    out = {"raised": None}
    try:
        model.fit(xs, y, batch_size=model.config.batch_size,
                  epochs=case.get("epochs", 2), verbose=False,
                  checkpoint_dir=case["path"], checkpoint_every_n_steps=1,
                  fault_injector=_faults(case, rank))
    except Exception as e:  # recorded: the host loss raises
        out.update(raised=type(e).__name__,
                   surviving_devices=getattr(e, "surviving_devices", None),
                   checkpoint=getattr(e, "checkpoint_path", None))
    if out["checkpoint"]:
        out["topology"] = load_checkpoint_meta(out["checkpoint"])["topology"]
    arrays = _params_arrays(model, "stopped")
    return dict(out, arrays=arrays) if rank == 0 else out


def _elastic_resume_case(case, rank, device):
    """`restore_elastic` of `case["path"]` on this (smaller) group, then
    `fit(elastic=True)` on to the end: the restored step and the mesh,
    and rank 0 writes the restored ("restored/...") and final
    ("final/...") weights."""
    from flexflow_tpu_torch.runtime.elastic import restore_elastic

    xs, y = _case_data(case)
    model, info = restore_elastic(lambda: _compiled(case, device),
                                  case["path"])
    arrays = _params_arrays(model, "restored")
    model.fit(xs, y, batch_size=model.config.batch_size,
              epochs=case.get("epochs", 2), verbose=False,
              checkpoint_dir=case["path"], elastic=True)
    arrays.update(_params_arrays(model, "final"))
    out = {"step": info.step, "final_step": model.state.step,
           "mesh": model.executor.mesh.shape,
           "saved_devices": info.meta["topology"]["num_devices"]}
    return dict(out, arrays=arrays) if rank == 0 else out


def _slice_failover_case(case, rank, device):
    """`fit(elastic=True)` with this rank's `case["faults"]` (a slice
    loss): the survivors shrink in-process, recompile and resume; a lost
    rank re-raises. Each rank's error, final step, mesh ranks, the
    trajectory's event kinds before the failover, the fault domains and
    the survivability verdict at compile; rank 0 writes the final
    weights ("final/...")."""
    from flexflow_tpu_torch.analysis.perf import perf_diagnostics
    from flexflow_tpu_torch.search.survivability import \
        strategy_survivability

    xs, y = _case_data(case)
    model = _compiled(case, device)
    cm = model._build_cost_model()
    surv = strategy_survivability(model.graph, model.searched_views or {},
                                  machine=cm.machine)
    rep = perf_diagnostics(model.graph, model.searched_views or {},
                           machine=cm.machine)
    out = {"raised": None,
           "slices": [list(s) for s in model.fault_domains.slices]
           if model.fault_domains else None,
           "penalty": cm.survivability_penalty,
           "survivable": surv.survivable,
           "ffa601": len(rep.by_code("FFA601"))}
    traj = model.search_trajectory
    fi = _faults(case, rank)
    try:
        model.fit(xs, y, batch_size=model.config.batch_size,
                  epochs=case.get("epochs", 3), verbose=False,
                  checkpoint_dir=case["path"], checkpoint_every_n_steps=1,
                  fault_injector=fi, elastic=True)
    except Exception as e:  # recorded: a lost rank re-raises
        out["raised"] = type(e).__name__
    out.update(step=model.state.step,
               kinds=[ev.get("kind") for ev in traj.events],
               fired=dict(fi.fired) if fi else {},
               mesh_ranks=sorted(model.executor.mesh.device_mesh.mesh
                                 .flatten().tolist()))
    if out["raised"] is None:
        arrays = _params_arrays(model, "final")
        if rank == 0:
            out["arrays"] = arrays
    return out


def _hung_step_case(case, rank, device):
    """A monitored `fit` (HealthMonitor over `allreduce_heartbeat`) with
    this rank's `case["faults"]` (a hung step): the error, its info's
    kind, the checkpoint path, the checkpoints on disk and the beats the
    monitor saw."""
    from flexflow_tpu_torch.runtime.elastic import (HealthMonitor,
                                                    allreduce_heartbeat)
    from flexflow_tpu_torch.runtime.resilience import CheckpointManager

    xs, y = _case_data(case)
    model = _compiled(case, device)
    mon = HealthMonitor(heartbeat_fn=allreduce_heartbeat(),
                        **case["monitor"])
    out = {"raised": None}
    try:
        model.fit(xs, y, batch_size=model.config.batch_size,
                  epochs=case.get("epochs", 2), verbose=False,
                  checkpoint_dir=case["path"], checkpoint_every_n_steps=100,
                  fault_injector=_faults(case, rank), health_monitor=mon)
    except Exception as e:  # recorded: the hang raises
        out.update(raised=type(e).__name__, step=getattr(e, "step", None),
                   kind=getattr(e, "info", {}).get("kind"),
                   checkpoint=getattr(e, "checkpoint_path", None))
    out.update(steps_on_disk=CheckpointManager(case["path"]).list_steps(),
               running=mon.running, beat_s=getattr(mon, "last_beat_s", None))
    return out


def _tuner_swap_case(case, rank, device):
    """`fit(tuner=TunerConfig(**case["tuner"]))` with the search fixed to
    `case["rewrites"]`' winner: each rank's swap history and outcomes,
    the live mesh after the fit, and rank 0 writes the final weights
    ("final/...")."""
    from flexflow_tpu_torch.runtime.tuner import TunerConfig

    xs, y = _case_data(case)
    model = _compiled(case, device)
    with fixed_winner(case["rewrites"]):
        model.fit(xs, y, batch_size=model.config.batch_size,
                  epochs=case.get("epochs", 2), verbose=False,
                  tuner=TunerConfig(**case["tuner"]),
                  fault_injector=_faults(case, rank))
    t = model._tuner
    out = {"history": [{k: v for k, v in h.items() if k != "detail"}
                       for h in t.swap_history],
           "outcomes": t.outcomes, "mesh": model.executor.mesh.shape,
           "replicas": model.executor.mesh.replicas}
    arrays = _params_arrays(model, "final")
    return dict(out, arrays=arrays) if rank == 0 else out


def _shrunk_mesh_case(case, rank, device):
    """Every rank enters `shrunk_devices(case["shrink"])`; the survivors
    compile `case` there (its mesh built from the survivors' groups
    alone) and train `case["steps"]` steps on the first batch: the mesh,
    its DeviceMesh's dims and ranks, the losses, and rank 0 writes the
    weights ("final/..."); a lost rank records that it was lost."""
    import torch

    from flexflow_tpu_torch.runtime import distributed as rdist
    from flexflow_tpu_torch.runtime.elastic import shrunk_devices

    xs, y = _case_data(case)
    with shrunk_devices(case["shrink"]) as ranks:
        if torch.distributed.get_rank() not in ranks:
            return {"lost": True}
        model = _compiled(case, device)
        ex = model.executor
        bs = model.config.batch_size
        step = ex.build_train_step()
        losses = []
        for i in range(case.get("steps", 2)):
            model.state, partials = step(model.state, [xs[0][:bs]], y[:bs],
                                         i)
            losses.append(float(partials["loss"]))
        out = {"lost": False, "mesh": ex.mesh.shape,
               "dims": list(ex.mesh.device_mesh.shape),
               "ranks": ex.mesh.device_mesh.mesh.tolist(),
               "world": rdist.process_count(), "losses": losses,
               "live": ex.mesh_is_live()}
        arrays = _params_arrays(model, "final")
    out["live_after"] = ex.mesh_is_live()
    return dict(out, arrays=arrays) if rank == 0 else out


_MODES = {"fit_resume": _fit_resume_case, "canary": _canary_case,
          "serve_moved": _serve_moved_case,
          "elastic_save": _elastic_save_case,
          "elastic_resume": _elastic_resume_case,
          "slice_failover": _slice_failover_case,
          "hung_step": _hung_step_case, "tuner_swap": _tuner_swap_case,
          "shrunk_mesh": _shrunk_mesh_case}


def _digest(model) -> str:
    """A hash of this rank's local weight shards: ranks holding the same
    shards (replicas over an axis) must hash alike."""
    import hashlib

    from flexflow_tpu_torch.parallel import mesh as pmesh

    h = hashlib.sha256()
    for ws in model.params.values():
        for w in ws.values():
            h.update(pmesh.local(w).detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _slots(model):
    """{slot/op/weight: [local shape, placements]} of the optimizer's
    weight-shaped slots."""
    from flexflow_tpu_torch.parallel import mesh as pmesh

    st = model.state.opt_state
    return {f"{k}/{op}/{n}": [list(pmesh.local(t).shape),
                              [str(p) for p in getattr(t, "placements", ())]]
            for k, tree in (st.items() if isinstance(st, dict) else ())
            if isinstance(tree, dict)
            for op, ws in tree.items() for n, t in ws.items()}


def _var_mean_case(case, rank, device):
    """parallel/mesh.py `var_mean` on a seeded (b, c, h, w) array sharded
    as `case["shard"]` ({mesh axis: tensor dim}) over a mesh of
    `case["mesh"]`, reduced over `case["dims"]`: its values whole (rank 0
    writes them) and the collectives CommDebugMode saw."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from flexflow_tpu_torch.parallel import mesh as pmesh

    m = pmesh.build_mesh(case["mesh"], device)
    x = torch.as_tensor(np.random.RandomState(0).randn(
        *case["shape"]).astype(np.float32))
    pl = [Shard(case["shard"][a]) if a in case["shard"] else Replicate()
          for a in m.live_axes]
    xd = pmesh.distribute(x, m, pl)
    with CommDebugMode() as comm:
        var, mean = pmesh.var_mean(xd, case["dims"],
                                   keepdim=case.get("keepdim", False))
    out = {"comms": {str(k): v for k, v in
                     comm.get_comm_counts().items()},
           "gathered": dict(pmesh.GATHERED),
           "placements": [str(p) for p in var.placements]}
    whole = {"var": pmesh.full(var).numpy(), "mean": pmesh.full(mean).numpy()}
    if rank == 0:
        out["arrays"] = whole
    return out


def _sp_kernels_case(case, rank, device):
    """kernels/attention.py `ring_attention` and `ulysses_attention` over
    the whole group as one "seq" axis, on this rank's sequence block of
    seeded (b, s, h, d) arrays q, k, v and a cotangent g (the arrays of
    `case["data"]`): for each of `case["impls"]` and causal off and on,
    the output and the gradients of sum(out * g) for q, k and v, each
    gathered whole over the group (rank 0 writes them as
    "<impl>_<causal>/<out|dq|dk|dv>")."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.kernels import attention as katt

    world = dist.get_world_size()
    with np.load(case["data"]) as z:
        whole = {k: torch.as_tensor(z[k]) for k in ("q", "k", "v", "g")}
    sl = whole["q"].shape[1] // world
    blk = {k: t[:, rank * sl:(rank + 1) * sl].contiguous()
           for k, t in whole.items()}
    arrays = {}
    for impl in case["impls"]:
        fn = getattr(katt, f"{impl}_attention")
        kw = {"chunk_size": case["chunk_size"]} if impl == "ring" else {}
        for causal in (False, True):
            leaves = [blk[k].clone().requires_grad_() for k in "qkv"]
            out = fn(*leaves, dist.group.WORLD, causal=causal, **kw)
            grads = torch.autograd.grad((out * blk["g"]).sum(), leaves)
            for name, t in zip(("out", "dq", "dk", "dv"),
                               (out.detach(),) + grads):
                parts = [torch.empty_like(t) for _ in range(world)]
                dist.all_gather(parts, t.contiguous())
                arrays[f"{impl}_{int(causal)}/{name}"] = \
                    torch.cat(parts, dim=1).numpy()
    return {"arrays": arrays} if rank == 0 else {}


def _gpipe_case(case, rank, device):
    """parallel/pipeline.py `gpipe_mesh` alone over a mesh of
    `case["mesh"]`: the stacked blocks of `case["data"]` (wq ... w2 with a
    leading layer dim, and x) in f32, Shard(0) over "pipe" and over
    "data", `case["n_micro"]` micro-batches; the output and the
    gradients of sum(out ** 2) for every weight and x, gathered whole
    (rank 0 writes "out", "d<weight>", "dx")."""
    import functools

    import numpy as np
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from flexflow_tpu_torch.ops.pipeline import _encoder_block
    from flexflow_tpu_torch.parallel import mesh as pmesh
    from flexflow_tpu_torch.parallel.pipeline import gpipe_mesh

    m = pmesh.build_mesh(case["mesh"], device)
    with np.load(case["data"]) as z:
        arrs = {k: torch.as_tensor(z[k]) for k in z.files}
    names = [k for k in arrs if k != "x"]

    def place(t, axis):
        return pmesh.distribute(t, m, [Shard(0) if a == axis else Replicate()
                                       for a in m.live_axes])

    ws = {k: place(arrs[k], "pipe").requires_grad_() for k in names}
    x = place(arrs["x"], "data").requires_grad_()
    head_dim = arrs["wq"].shape[-1]
    block = functools.partial(_encoder_block, head_dim=head_dim,
                              compute_dtype=None)
    out = gpipe_mesh(block, ws, x, mesh=m, n_stages=m.shape["pipe"],
                     n_micro=case["n_micro"])
    grads = torch.autograd.grad((out * out).sum(), [x] + [ws[k]
                                                          for k in names])
    whole = {"out": pmesh.full(out).detach().numpy(),
             "dx": pmesh.full(grads[0]).numpy()}
    whole.update({f"d{k}": pmesh.full(g).numpy()
                  for k, g in zip(names, grads[1:])})
    res = {"placements": {k: [str(p) for p in w.placements]
                          for k, w in ws.items()},
           "local_rows": int(pmesh.local(ws["wq"]).shape[0])}
    if rank == 0:
        res["arrays"] = whole
    return res


def _hybrid_case(case, rank, device):
    """parallel/mesh.py `build_hybrid_mesh(case["ici"], case["dcn"])`:
    its axis order, sizes and DeviceMesh dims, and this rank's
    coordinate."""
    from flexflow_tpu_torch.parallel import mesh as pmesh

    m = pmesh.build_hybrid_mesh(case["ici"], case["dcn"], device)
    return {"axis_names": list(m.axis_names), "shape": m.shape,
            "live_axes": list(m.live_axes),
            "coordinate": list(m.device_mesh.get_coordinate())}


def _views_by_position(model):
    pos = {op.guid: i for i, op in enumerate(model.graph.topo_order())}
    return [(pos.get(g, -1), v) for g, v in model.searched_views.items()]


def run(rank: int, world: int, device: str, args) -> int:
    import numpy as np

    spec, out_dir = args
    with open(spec) as f:
        cases = json.load(f)
    for case in cases:
        t0 = time.perf_counter()
        env = dict(os.environ)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                out = run_case(case, rank, device)
            except Exception as e:  # recorded; the next case runs
                out = {"error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()}
        # a case's env does not reach the next case
        os.environ.clear()
        os.environ.update(env)
        out["warnings"] = [str(w.message) for w in rec]
        out["seconds"] = time.perf_counter() - t0
        arrays = out.pop("arrays", None)
        if arrays is not None:
            np.savez(os.path.join(out_dir, f"{case['name']}.npz"), **arrays)
        with open(os.path.join(out_dir,
                               f"{case['name']}.rank{rank}.json"), "w") as f:
            json.dump(out, f)
        print(f"[rank {rank}/{world}] {case['name']}: "
              f"{out.get('error', 'ok')} ({out['seconds']:.1f} s)",
              flush=True)
    return 0
