"""The serving fleet of flexflow_tpu_torch against the JAX package, on the
CPU: the batcher with prefix sharing and the prefill memo, admission
control (TokenBucket, the queue's sheds), request tracing and the SLO
monitor, ReplicaSet failover with a warm spare, BatchScheduler, and the
decode retune (the tuner's serving leg).

The causal LM of tests/test_serving.py (vocab 29, width 16, 2 heads, one
block, max_len 16) is built in both packages, its weights carried from
the JAX model by `params_from_numpy`; pages of 4 positions, so an 8-token
shared prefix is two full pages.

Exact throughout: tokens, `prefix_hits`, `prefill_skips` and the page
pools' counters equal JAX's batcher on the same requests in the same
order; TokenBucket's AIMD trajectory under one injected clock and
`record_request_stages`' decomposition of the same timestamps equal
JAX's. The threaded tests wait on events with generous timeouts and
assert no wall time.
"""
import dataclasses
import json
import threading
import time
import zlib

import numpy as np
import pytest

import flexflow_tpu as jff
from flexflow_tpu.obs import request_trace as jrt
from flexflow_tpu.runtime import serving as jsv
from flexflow_tpu_torch import FFConfig, FFModel, obs
from flexflow_tpu_torch.ff_types import ActiMode, AggrMode, DataType
from flexflow_tpu_torch.obs import request_trace as trt
from flexflow_tpu_torch.runtime import serving as tsv
from flexflow_tpu_torch.runtime.resilience import FaultInjector
from flexflow_tpu_torch.runtime.weights import params_from_numpy

VOCAB, SEQ, HIDDEN, HEADS = 29, 16, 16, 2
WAIT = 180.0  # seconds an event may take under a loaded test run


def _build(m, dt, acti, aggr, batch=2):
    ids = m.create_tensor((batch, SEQ), dt.DT_INT32)
    t = m.embedding(ids, VOCAB, HIDDEN, aggr.AGGR_MODE_NONE)
    t = m.multihead_attention(t, t, t, HIDDEN, HEADS, causal=True)
    t = m.dense(t, HIDDEN, acti.AC_MODE_RELU)
    return m.softmax(m.dense(t, VOCAB))


def _jax_lm():
    cfg = jff.FFConfig()
    cfg.batch_size = 2
    cfg.search_budget = 1
    m = jff.FFModel(cfg)
    _build(m, jff.DataType, jff.ActiMode, jff.AggrMode)
    m.compile(jff.SGDOptimizer(lr=0.01),
              jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [jff.MetricsType.METRICS_ACCURACY])
    return m


def _weights(jm):
    return {op: {n: np.asarray(a) for n, a in ws.items()}
            for op, ws in jm.state.params.items()}


def _port_lm(weights, search_budget=None):
    cfg = dict(batch_size=2, device="cpu")
    if search_budget is not None:
        cfg["search_budget"] = search_budget
    m = FFModel(FFConfig(**cfg))
    _build(m, DataType, ActiMode, AggrMode)
    m.compile()
    params_from_numpy(m, weights)
    return m


@pytest.fixture(scope="module")
def lms():
    jm = _jax_lm()
    w = _weights(jm)
    return jm, w, _port_lm(w)


def _cfg(mod, **kw):
    base = dict(max_len=SEQ, slots=2, page_size=4, default_deadline_s=120.0)
    base.update(kw)
    if mod is jsv:
        base["precompile"] = False  # JAX's jit of every bucket: slow here
    return mod.ServingConfig(**base)


def _shared_requests(seed=11):
    """An 8-token system prompt (two full pages) with suffixes of 0-3
    tokens, two verbatim repeats among them, and two unrelated prompts."""
    rng = np.random.RandomState(seed)
    system = rng.randint(0, VOCAB, 8).tolist()
    prompts = [system + rng.randint(0, VOCAB, n).tolist()
               for n in (2, 0, 3, 1)]
    prompts += [prompts[0], prompts[1], rng.randint(0, VOCAB, 5).tolist(),
                system + [1, 2], rng.randint(0, VOCAB, 9).tolist(),
                prompts[2]]
    news = [4, 5, 3, 4, 4, 5, 3, 4, 2, 3]
    return [np.asarray(p, np.int32) for p in prompts], news


def _serve(mod, model, prompts, news, **kw):
    """All requests offered before the batcher starts, so both packages
    admit them in one order."""
    q = mod.AdmissionQueue(32)
    b = mod.ContinuousBatcher(model, _cfg(mod, **kw), q)
    reqs = [mod.GenerationRequest(p, n, deadline_s=120.0)
            for p, n in zip(prompts, news)]
    for r in reqs:
        q.offer(r)
    b.start()
    try:
        return [np.asarray(r.result(timeout=WAIT)) for r in reqs], b
    finally:
        b.stop()


@pytest.mark.parametrize("share,entries", [(True, 8), (True, 1),
                                           (False, 8)])
def test_batcher_with_shared_prefixes_matches_jax(lms, share, entries):
    jm, _, tm = lms
    prompts, news = _shared_requests()
    kw = dict(share_prefixes=share, prefix_cache_entries=entries, slots=3)
    jout, jb = _serve(jsv, jm, prompts, news, **kw)
    tout, tb = _serve(tsv, tm, prompts, news, **kw)
    for p, n, j, t in zip(prompts, news, jout, tout):
        np.testing.assert_array_equal(t, j)
        ref = tsv.incremental_generate(tm, p[None], max_new_tokens=n,
                                       max_len=SEQ)[0]
        np.testing.assert_array_equal(t, ref)
    for k in ("prefix_hits", "prefill_skips", "prefills", "admitted",
              "finished", "stranded_requeued"):
        assert tb.stats[k] == jb.stats[k], k
    assert tb.pool.stats == jb.pool.stats
    if share:
        assert tb.stats["prefix_hits"] >= 5
        assert tb.stats["prefill_skips"] >= (3 if entries > 1 else 0)
    else:
        assert tb.stats["prefix_hits"] == tb.stats["prefill_skips"] == 0
    rep = tb.pool.audit()
    assert rep.ok and rep.pages_resident == 0


def test_memo_hit_copies_the_strip_and_leaves_the_memo_intact(lms):
    """A prefill memo hit is copied into the running batch: decode steps
    that write the batch's strip leave the memoized strip as it was."""
    _, _, tm = lms
    prompts, news = _shared_requests()
    q = tsv.AdmissionQueue(8)
    b = tsv.ContinuousBatcher(tm, _cfg(tsv, slots=2), q)
    p = prompts[0]
    first = tsv.GenerationRequest(p, 4)
    q.offer(first)
    b.start()
    try:
        first.result(timeout=WAIT)
        ((key, (tok, strip)),) = b._prefix_cache.items()
        snap = {op: [c.clone() for c in kv]
                for op, kv in strip["mha"].items()}
        again = tsv.GenerationRequest(p, 6)
        q.offer(again)
        out = again.result(timeout=WAIT)
    finally:
        b.stop()
    assert b.stats["prefill_skips"] == 1
    for op, kv in strip["mha"].items():
        for a, s in zip(kv, snap[op]):
            assert a.equal(s)
            assert all(a.data_ptr() != c.data_ptr()
                       for c in b._caches["mha"][op])
    ref = tsv.incremental_generate(tm, p[None], max_new_tokens=6,
                                   max_len=SEQ)[0]
    np.testing.assert_array_equal(out, ref)


def test_serving_config_matches_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jsv.ServingConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tsv.ServingConfig)}
    assert tf == jf
    for kw in (dict(max_len=16), dict(max_len=33, slots=3, page_size=8),
               dict(max_len=16, num_pages=5, watermark=0.2)):
        j, t = jsv.ServingConfig(**kw).kv_config(), \
            tsv.ServingConfig(**kw).kv_config()
        assert (t.num_pages, t.page_size, t.watermark) == \
            (j.num_pages, j.page_size, j.watermark)
    for bad in (dict(max_len=1), dict(max_len=8, slots=0),
                dict(max_len=8, max_queue_depth=0)):
        with pytest.raises(jsv.ServingConfigError):
            jsv.ServingConfig(**bad)
        with pytest.raises(tsv.ServingConfigError):
            tsv.ServingConfig(**bad)


def test_token_bucket_aimd_trajectory_matches_jax():
    """The same acquisitions and adapt calls under one injected clock:
    every grant, every rate, and the admission-rate gauge."""
    rng = np.random.RandomState(0)
    now = [0.0]
    tb = tsv.TokenBucket(3.0, 4, clock=lambda: now[0])
    jb = jsv.TokenBucket(3.0, 4, clock=lambda: now[0])
    trace = []
    for i in range(300):
        now[0] += float(rng.exponential(0.2))
        if i % 7 == 3:
            p95 = float("nan") if i % 5 == 0 else float(rng.uniform(0, 2))
            a, b = tb.adapt(p95, 1.0), jb.adapt(p95, 1.0)
        else:
            n = float(rng.choice([1.0, 0.5, 2.0]))
            a, b = tb.try_acquire(n), jb.try_acquire(n)
        assert a == b, i
        trace.append(a)
        assert tb.rate == jb.rate and tb._tokens == jb._tokens
    assert (tb.min_rate, tb.max_rate) == (jb.min_rate, jb.max_rate)
    assert True in trace and False in trace


def _stage_requests(mod):
    """Requests with fixed lifecycle timestamps, one per path through
    the decomposition (never admitted, no first token, one token, many)."""
    out = []
    for sub, adm, first, fin, new in ((0.0, None, None, 1.0, 4),
                                      (0.0, 0.5, None, 2.0, 4),
                                      (1.0, 1.25, 1.5, 1.5, 1),
                                      (2.0, 2.5, 3.0, 5.5, 6),
                                      (3.0, 3.5, 3.6, 3.9, 3)):
        r = mod.GenerationRequest(np.arange(3), new)
        r.submitted_t, r.admitted_t, r.first_token_t, r.finished_t = \
            sub, adm, first, fin
        out.append(r)
    return out


def test_record_request_stages_and_slo_monitor_match_jax(tmp_path):
    from flexflow_tpu.obs import TelemetryConfig as JTel
    from flexflow_tpu.obs import session as jsession

    results = []
    for mod, rt, sess in (
            (tsv, trt, lambda d: obs.session(obs.TelemetryConfig(
                dir=d, flight_recorder=False, anomaly_detection=False))),
            (jsv, jrt, lambda d: jsession(JTel(dir=d)))):
        slo = rt.SLOMonitor(ttft_target_s=0.75, latency_p99_target_s=2.0,
                            window=4)
        with sess(str(tmp_path / mod.__name__)) as tel:
            stages = [rt.record_request_stages(
                r, generated=g, slo=slo, replica=rep)
                for r, g, rep in zip(_stage_requests(mod),
                                     (None, 3, 1, 6, None),
                                     ("r0", None, "r1", "r0", "r1"))]
            hist = {}
            for stage in ("total", "queue", "prefill", "decode", "stall",
                          "tpot"):
                for rep in ("r0", "r1"):
                    h = tel.metrics.find("ff_request_stage_seconds",
                                         stage=stage, replica=rep)
                    if h is not None:
                        hist[(stage, rep)] = (h.count, round(h.sum, 12))
            viol = {(s, r): tel.metrics.counter(
                "ff_slo_violations_total", slo=s, replica=r).value
                for s in ("ttft", "p99_latency") for r in ("r0", "r1")}
        results.append((stages, hist, viol, slo.snapshot(),
                        slo.violation_rate(), slo.should_scale_up(
                            threshold=0.1, min_samples=2),
                        slo.latency_quantile(0.95), slo.sample_count))
    assert results[0] == results[1]
    assert results[0][1] and sum(results[0][2].values()) > 0
    assert not trt.SLOMonitor().enabled


def test_request_sampling_matches_jax(tmp_path):
    ids = [f"{i:012x}" for i in range(0, 4000, 7)]
    for rate in (0.0, 0.01, 0.3, 0.5, 1.0, 2.0):
        assert [trt._sampled(i, rate) for i in ids] == \
            [jrt._sampled(i, rate) for i in ids]
    assert trt._sampled("abc", 0.5) == (zlib.crc32(b"abc") % 10_000 < 5000)
    assert trt.mint_request_trace("abc") is trt.NULL_REQUEST_TRACE
    cfg = obs.TelemetryConfig(dir=str(tmp_path), request_sample_rate=0.3,
                              flight_recorder=False, anomaly_detection=False)
    with obs.session(cfg):
        minted = [trt.mint_request_trace(i) for i in ids]
    assert [m.sampled for m in minted] == [jrt._sampled(i, 0.3)
                                           for i in ids]
    assert all(m is trt.NULL_REQUEST_TRACE for m in minted if not m.sampled)


def test_request_trace_lanes_and_shed_counter(lms, tmp_path):
    """A sampled request's queue span, admission, prefill (skipped on a
    memo hit), decode iterations and completion land on its replica's
    lane; every shed reason is counted."""
    _, _, tm = lms
    cfg = obs.TelemetryConfig(dir=str(tmp_path), flight_recorder=False,
                              anomaly_detection=False)
    p = np.arange(8, dtype=np.int32) % VOCAB
    with obs.session(cfg) as tel:
        q = tsv.AdmissionQueue(2)
        b = tsv.ContinuousBatcher(tm, _cfg(tsv), q, name="rA")
        reqs = [tsv.GenerationRequest(p, 3), tsv.GenerationRequest(p, 3)]
        for r in reqs:
            q.offer(r)
        with pytest.raises(tsv.QueueFullError):
            q.offer(tsv.GenerationRequest(p, 3))
        with pytest.raises(tsv.DeadlineExceededError):
            q.offer(tsv.GenerationRequest(p, 3, deadline_s=-1.0))
        b.start()
        try:
            for r in reqs:
                r.result(timeout=WAIT)
            late = tsv.GenerationRequest(p, 3, deadline_s=0.0)
            q._q.append(late)  # expired while queued
            with pytest.raises(tsv.DeadlineExceededError) as e:
                late.result(timeout=WAIT)
            assert e.value.stage == "dequeue"
        finally:
            b.stop()
        shed = {r: tel.metrics.counter("ff_serving_shed_total",
                                       reason=r).value
                for r in ("queue_full", "deadline")}
        lanes = dict(tel.tracer.lane_names)
    assert shed == {"queue_full": 1.0, "deadline": 2.0}
    assert ("requests", "rA") in lanes and ("requests", "admission") in lanes
    events = [json.loads(line) for line in
              open(tmp_path / "events.jsonl") if line.strip()]
    mine = [e for e in events if e.get("cat") == "requests"
            and e.get("args", {}).get("request") == reqs[1].id]
    names = [e["name"] for e in mine]
    for n in ("queue", "admit", "prefill", "decode", "complete"):
        assert n in names, names
    prefill = next(e for e in mine if e["name"] == "prefill")
    assert prefill["args"]["skipped"] is True
    assert {e["tid"] for e in mine if e["name"] == "decode"} == \
        {lanes[("requests", "rA")]}


@pytest.fixture
def recorded(monkeypatch):
    """Every ContinuousBatcher built during the test."""
    made = []
    init = tsv.ContinuousBatcher.__init__

    def rec(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(tsv.ContinuousBatcher, "__init__", rec)
    return made


def _wait_for(cond, timeout=WAIT):
    t0 = time.monotonic()
    while not cond() and time.monotonic() - t0 < timeout:
        time.sleep(0.02)
    return cond()


def test_replica_set_failover_exactly_once_with_a_spare(lms, tmp_path,
                                                        recorded):
    """Two replicas and a warm spare on one queue; replica0 dies at its
    third iteration while every slot holds the shared prefix. Its slots
    go back to the front of the queue; each request is answered once,
    exactly as JAX's incremental_generate; the spare (restored from the
    first replica's checkpoint) replaces it; every pool that ever existed
    ends audit-clean with no resident page."""
    jm, w, _ = lms
    prompts, news = _shared_requests(seed=13)
    fi = FaultInjector()
    fi.inject("replica_death", at_step=2, replica="replica0",
              exc=tsv.ReplicaDeathError("injected mid shared decode"))
    finishes = []
    rs = tsv.ReplicaSet(lambda: _port_lm(w), _cfg(tsv, slots=3),
                        replicas=2, ckpt_dir=str(tmp_path / "ck"),
                        fault_injector=fi, health_timeout_s=120.0,
                        restart_backoff_s=0.01, warm_spares=1).start()
    try:
        # both replicas warmed up before traffic, so each takes a share
        assert _wait_for(lambda: all(b._caches is not None
                                     for b in recorded))
        reqs = [rs.submit(p, max_new_tokens=n, deadline_s=WAIT)
                for p, n in zip(prompts, news)]
        for r in reqs:
            orig = r._finish
            r._finish = (lambda o, r: lambda **kw: finishes.append(
                (r.id, o(**kw))) or finishes[-1][1])(orig, r)
        outs = [r.result(timeout=WAIT) for r in reqs]
        assert _wait_for(lambda: rs.stats["restarts"] >= 1
                         and rs.replica_count() == 2)
    finally:
        rs.stop()
    for p, n, o in zip(prompts, news, outs):
        ref = jsv.incremental_generate(jm, p[None], max_new_tokens=n,
                                       max_len=SEQ)[0]
        np.testing.assert_array_equal(o, np.asarray(ref))
    assert fi.fired["replica_death"] == 1
    assert rs.stats["spares_used"] == 1 and rs.stats["restarts"] == 1
    assert rs.stats["requeued"] >= 1
    assert max(r.generation for r in reqs) >= 1
    won = [rid for rid, ok in finishes if ok]
    assert sorted(won) == sorted(r.id for r in reqs)  # each answered once
    names = [b.name for b in recorded]
    assert "spare0" in names and "replica0" in names
    dead = next(b for b in recorded if b.name == "replica0")
    assert dead.dead and dead.stats["stranded_requeued"] >= 1
    for b in recorded:
        rep = b.pool.audit()
        assert rep.ok and rep.pages_resident == 0, (b.name, rep.to_dict())
    assert sum(b.stats["prefix_hits"] for b in recorded) >= 3
    # the set keeps the dead replica's record beside the live ones
    agg = rs.aggregate_stats()
    assert sorted(agg["kv_pool_audits"]) == ["replica1", "spare0"]
    assert all(a["ok"] for a in agg["kv_pool_audits"].values())
    gone = agg["retired"]["replica0"]
    assert gone["stats"] == dead.stats and gone["kv_pool_audit"]["ok"]
    assert gone["requeued"] == dead.stats["stranded_requeued"]
    assert all(gone["died_t"] <= r.finished_t for r in reqs
               if r.generation >= 1)


def test_a_failover_keeps_the_dead_replicas_capacity_reserved(lms,
                                                              tmp_path):
    """From the moment a dead replica leaves rotation, its restart counts
    as capacity (the autoscaler reads replica_count() plus the pending
    restarts): read while its terminal spool is written, after the
    forensics dump, the set still holds 2. A gap there let an autoscaler
    tick with the requeued requests queued scale up on top of the
    restart, one replica past max_replicas (a card run: 3 live of 2)."""
    _, w, _ = lms
    fi = FaultInjector()
    fi.inject("replica_death", at_step=1, replica="replica0",
              exc=tsv.ReplicaDeathError("injected"))
    rs = tsv.ReplicaSet(lambda: _port_lm(w), _cfg(tsv), replicas=2,
                        ckpt_dir=str(tmp_path / "ck"), fault_injector=fi,
                        health_timeout_s=120.0, restart_backoff_s=0.01,
                        warm_spares=1)
    seen = []
    spool = rs._write_replica_spool

    def watched(batcher, status="live"):
        if status == "dead":
            seen.append(rs.replica_count() + rs._pending_restarts)
        return spool(batcher, status)

    rs._write_replica_spool = watched
    rs.start()
    rng = np.random.RandomState(5)
    try:
        ps = [rng.randint(0, VOCAB, 3).astype(np.int32) for _ in range(4)]
        for r in [rs.submit(p, max_new_tokens=4, deadline_s=WAIT)
                  for p in ps]:
            r.result(timeout=WAIT)
        assert _wait_for(lambda: rs.stats["restarts"] >= 1
                         and rs.replica_count() == 2)
    finally:
        rs.stop()
    assert fi.fired["replica_death"] == 1
    assert seen == [2]
    assert rs.stats["scale_ups"] == 0 and rs.stats["spares_used"] == 1


def test_a_failed_teardown_releases_the_reserved_restart(lms, tmp_path):
    """The restart reserved as a dead replica leaves rotation is released
    when the teardown after it raises and no restart thread starts: the
    set counts no phantom replica and keeps its restart budget."""
    _, w, _ = lms
    rs = tsv.ReplicaSet(lambda: _port_lm(w), _cfg(tsv), replicas=2,
                        ckpt_dir=str(tmp_path / "ck"),
                        health_timeout_s=120.0, restart_backoff_s=0.01)

    def broken(batcher, status="live"):
        if status == "dead":
            raise OSError("spool disk gone")

    rs._write_replica_spool = broken
    rs.start()
    try:
        rep = rs._replicas["replica0"]
        with pytest.raises(OSError, match="spool disk gone"):
            rs._fail_replica(rep.batcher, tsv.ReplicaDeathError("injected"))
        assert rs._pending_restarts == 0 and rs._restarts == 0
        assert rs.replica_count() == 1
    finally:
        rs.stop()


def test_slow_worker_hang_fails_over_to_the_spare(lms, tmp_path, recorded):
    """`slow_worker` stalls replica0's second decode iteration far past
    the watchdog's timeout: the HealthMonitor declares it hung, its
    wedged thread's slots are stolen back to the queue, the spare takes
    over, and every request is still answered once and exactly."""
    _, w, tm = lms
    fi = FaultInjector()
    fi.inject("slow_worker", at_step=1, replica="replica0", delay_s=6.0)
    rs = tsv.ReplicaSet(lambda: _port_lm(w), _cfg(tsv, slots=3),
                        replicas=1, ckpt_dir=str(tmp_path / "ck"),
                        fault_injector=fi, health_timeout_s=1.0,
                        compile_grace_s=WAIT, restart_backoff_s=0.01,
                        warm_spares=1).start()
    rng = np.random.RandomState(6)
    try:
        ps = [rng.randint(0, VOCAB, 4).astype(np.int32) for _ in range(3)]
        reqs = [rs.submit(p, max_new_tokens=5, deadline_s=WAIT) for p in ps]
        outs = [r.result(timeout=WAIT) for r in reqs]
        assert _wait_for(lambda: rs.stats["spares_used"] == 1)
    finally:
        rs.stop()
    assert fi.fired["slow_worker"] == 1
    for p, o in zip(ps, outs):
        np.testing.assert_array_equal(o, tsv.incremental_generate(
            tm, p[None], max_new_tokens=5, max_len=SEQ)[0])
    assert all(r.generation >= 1 for r in reqs)
    dead = next(b for b in recorded if b.name == "replica0")
    assert dead.dead and dead.stats["stranded_requeued"] == 3
    for b in recorded:
        rep = b.pool.audit()
        assert rep.ok and rep.pages_resident == 0, (b.name, rep.to_dict())


def test_replica_set_elastic_restart_without_spares(lms, tmp_path):
    """No spare: the replacement is rebuilt through restore_elastic from
    the set's checkpoint, within the restart budget."""
    _, w, tm = lms
    fi = FaultInjector()
    fi.inject("replica_death", at_step=1, replica="replica0",
              exc=tsv.ReplicaDeathError("injected"))
    rs = tsv.ReplicaSet(lambda: _port_lm(w), _cfg(tsv), replicas=1,
                        ckpt_dir=str(tmp_path / "ck"), fault_injector=fi,
                        health_timeout_s=120.0, restart_backoff_s=0.01,
                        max_replica_restarts=1).start()
    rng = np.random.RandomState(4)
    try:
        ps = [rng.randint(0, VOCAB, 3).astype(np.int32) for _ in range(4)]
        outs = [r.result(timeout=WAIT) for r in
                [rs.submit(p, max_new_tokens=4, deadline_s=WAIT)
                 for p in ps]]
        assert _wait_for(lambda: rs.stats["restarts"] >= 1)
        assert rs.replica_names() == ["replica1"]
    finally:
        rs.stop()
    for p, o in zip(ps, outs):
        np.testing.assert_array_equal(o, tsv.incremental_generate(
            tm, p[None], max_new_tokens=4, max_len=SEQ)[0])
    assert rs.stats["spares_used"] == 0 and rs._restarts == 1


def test_replica_set_admission_sheds_and_refusals(lms):
    _, w, _ = lms
    rs = tsv.ReplicaSet(lambda: _port_lm(w),
                        _cfg(tsv, rate_limit=1.0, rate_burst=2),
                        replicas=1, health_timeout_s=120.0)
    with pytest.raises(tsv.ServingConfigError):
        rs.submit(np.zeros(2, np.int32))  # not started
    rs.start()
    try:
        ok = shed = 0
        for _ in range(6):
            try:
                rs.submit(np.zeros(2, np.int32), max_new_tokens=2)
                ok += 1
            except tsv.RateLimitedError as e:
                assert e.reason == "rate_limited"
                shed += 1
        assert ok >= 2 and shed >= 3
    finally:
        rs.stop(timeout=0.2)


def test_replica_set_stop_aborts_pending_typed(lms):
    _, w, _ = lms
    rs = tsv.ReplicaSet(lambda: _port_lm(w), _cfg(tsv), replicas=1,
                        health_timeout_s=120.0).start()
    reqs = [rs.submit(np.zeros(2, np.int32), max_new_tokens=3)
            for _ in range(5)]
    rs.stop(timeout=0.0)
    for r in reqs:
        assert r.done()
        if r.error is not None:
            assert isinstance(r.error, tsv.RequestShedError)
            assert r.error.reason == "aborted"


def test_generation_request_owner_check_matches_jax():
    out = []
    for mod in (jsv, tsv):
        r = mod.GenerationRequest(np.arange(3), 4)
        gen = r.generation
        out.append((r._requeue_bump(),
                    r._finish(tokens=np.arange(5), generation=gen),
                    r.done(),
                    r._finish(tokens=np.arange(5), generation=gen + 1),
                    r._requeue_bump(), r.result(0.1).tolist()))
    assert out[0] == out[1]
    with pytest.raises(TimeoutError):
        tsv.GenerationRequest(np.arange(2), 1).result(timeout=0.01)


def _dense(mod, batch=4):
    if mod is jsv:
        cfg = jff.FFConfig()
        cfg.batch_size = batch
        m = jff.FFModel(cfg)
        x = m.create_tensor((batch, 6), jff.DataType.DT_FLOAT)
        m.softmax(m.dense(m.dense(x, 16, jff.ActiMode.AC_MODE_RELU), 3))
        m.compile(jff.SGDOptimizer(lr=0.01),
                  jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        return m
    m = FFModel(FFConfig(batch_size=batch, device="cpu"))
    x = m.create_tensor((batch, 6), DataType.DT_FLOAT)
    m.softmax(m.dense(m.dense(x, 16, ActiMode.AC_MODE_RELU), 3))
    m.compile()
    return m


@pytest.fixture(scope="module")
def dense_pair():
    jm = _dense(jsv)
    tm = _dense(tsv)
    params_from_numpy(tm, _weights(jm))
    return jm, tm


def test_batch_scheduler_answers_as_jax(dense_pair):
    jm, tm = dense_pair
    rng = np.random.RandomState(2)
    xs = [rng.randn(6).astype(np.float32) for _ in range(7)]
    js = jsv.BatchScheduler(jm, max_delay_s=0.05).start()
    ts = tsv.BatchScheduler(tm, max_delay_s=0.05).start()
    try:
        got = [None] * len(xs)

        def ask(i):
            got[i] = ts.infer([xs[i]], timeout=WAIT)

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        want = [js.infer([x], timeout=WAIT) for x in xs]
    finally:
        js.stop()
        ts.stop()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)
    assert ts.stats["requests"] == len(xs)
    assert ts.stats["batches"] < len(xs)  # some requests shared a batch
    assert ts.stats["degraded"] == 0


def test_batch_scheduler_sheds_and_bound(dense_pair):
    _, tm = dense_pair
    s = tsv.BatchScheduler(tm, max_delay_s=0.001, max_queue_depth=2)
    x = np.zeros(6, np.float32)
    expired = s.submit([x], deadline=time.monotonic() - 1.0)
    live = s.submit([x], deadline=time.monotonic() + WAIT)
    with pytest.raises(tsv.QueueFullError):
        s.submit([x])
    s.start()
    try:
        assert live.event.wait(WAIT) and live.error is None
        assert expired.event.wait(WAIT)
        assert isinstance(expired.error, tsv.DeadlineExceededError)
        assert expired.error.stage == "dequeue"
        assert s.stats["shed"] == 2
    finally:
        s.stop()


def test_batch_scheduler_serving_worker_site_and_restarts(dense_pair):
    """`serving_worker` kills the worker on its first batch: the request
    is re-run degraded (counted); with a restart budget concurrent
    callers agree on one backoff window and all get answers; without one
    the scheduler stays degraded."""
    jm, tm = dense_pair
    x = np.linspace(-1, 1, 6).astype(np.float32)
    want = np.asarray(jsv.BatchScheduler(jm)._infer_direct([x]))
    fi = FaultInjector()
    fi.inject("serving_worker", at_step=0, exc=RuntimeError("crash"))
    s = tsv.BatchScheduler(tm, fault_injector=fi, max_worker_restarts=0)
    s.start()
    try:
        np.testing.assert_allclose(s.infer([x], timeout=WAIT), want,
                                   atol=1e-6)
        assert fi.fired["serving_worker"] == 1
        assert s.stats["degraded_retries"] >= 1 and s.stats["degraded"] >= 1
        assert not s.worker_alive() and not s._maybe_restart_worker()
    finally:
        s.stop()
    fi = FaultInjector()
    fi.inject("serving_worker", at_step=0, exc=RuntimeError("crash"))
    s = tsv.BatchScheduler(tm, fault_injector=fi, max_worker_restarts=2,
                           restart_backoff_s=0.05)
    s.start()
    results = []

    def caller():
        try:
            results.append(s.infer([x], timeout=WAIT))
        except BaseException as e:  # collected for the assertion
            results.append(e)

    threads = [threading.Thread(target=caller) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    try:
        assert len(results) == 4
        for r in results:
            assert isinstance(r, np.ndarray), r
            np.testing.assert_allclose(r, want, atol=1e-6)
        assert s.stats["worker_restarts"] <= 2
        assert _wait_for(lambda: s._maybe_restart_worker())
        np.testing.assert_allclose(s.infer([x], timeout=WAIT), want,
                                   atol=1e-6)
        assert s.worker_alive()
    finally:
        s.stop()


def test_decode_retune_stays_exact_and_is_counted(tmp_path, lms):
    """Prompt lengths drift: the batcher re-runs compile_decode between
    batches (the tuner's serving leg); whatever it decides, later answers
    stay exact and the attempt is counted with leg="serving"."""
    from flexflow_tpu_torch.runtime.tuner import SWAP_METRIC

    _, w, _ = lms
    tm = _port_lm(w, search_budget=1)
    cfg = _cfg(tsv, decode_retune=True, decode_retune_threshold=0.5,
               decode_retune_min_admissions=2,
               decode_retune_cooldown_iters=1)
    rng = np.random.RandomState(3)
    tel_cfg = obs.TelemetryConfig(dir=str(tmp_path), flight_recorder=False,
                                  anomaly_detection=False)
    with obs.session(tel_cfg) as tel:
        q = tsv.AdmissionQueue(16)
        b = tsv.ContinuousBatcher(tm, cfg, q).start()
        try:
            def ask(plen, new):
                p = rng.randint(0, VOCAB, plen).astype(np.int32)
                r = tsv.GenerationRequest(p, new)
                q.offer(r)
                return p, new, r

            cases = [ask(2, 3) for _ in range(2)]
            for _, _, r in cases:
                r.result(timeout=WAIT)
            cases += [ask(12, 3) for _ in range(3)]
            for _, _, r in cases[2:]:
                r.result(timeout=WAIT)
            assert _wait_for(lambda: b.stats["decode_retunes"] >= 1)
            assert not b._prefix_cache or b.decode_strategy_active is False
            cases += [ask(12, 4), ask(3, 4)]
            for p, n, r in cases:
                np.testing.assert_array_equal(
                    r.result(timeout=WAIT),
                    tsv.incremental_generate(tm, p[None], max_new_tokens=n,
                                             max_len=SEQ)[0])
        finally:
            b.stop()
        served = sum(tel.metrics.counter(SWAP_METRIC, outcome=oc,
                                         leg="serving").value
                     for oc in ("committed", "rolled_back", "quarantined"))
    assert served == b.stats["decode_retunes"] >= 1


def test_fleet_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys, flexflow_tpu_torch.runtime.serving,"
            " flexflow_tpu_torch.runtime.kvcache,"
            " flexflow_tpu_torch.obs.request_trace,"
            " flexflow_tpu_torch.frontends.keras_exp.models,"
            " flexflow_tpu_torch.frontends.keras_exp.keras2onnx_min;"
            " bad = sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'flexflow_tpu.'))"
            " or m in ('flexflow_tpu', 'tensorflow'));"
            " print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
