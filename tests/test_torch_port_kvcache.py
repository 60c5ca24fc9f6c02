"""flexflow_tpu_torch's page pool against the JAX package's: the same
seeded sequence of calls must give the same results, the same page
tables, refcounts, content index, typed failures and counters on both,
and the same audit verdicts.

  - reserve / touch / release without prompt tokens (the slot/page
    accounting);
  - with prefix sharing: reserve(tokens=, writable=) attaching published
    pages, publish, note_write (copy-on-write, unpublish on write),
    match_prefix, release decrefs, a watermark, and the four fault sites
    (kv_exhaustion, shared_page_corruption, release_race, cow_fault)
    armed by the same FaultInjector plans on both sides; the whole
    `to_state()` must be equal after every call;
  - the offline audit of corrupted states (every violation kind);
  - the `selftest` and `audit` CLI: exit codes and JSON verdicts;
  - `kv_page_bytes` on a small LM.
Everything here is exact: the pool is integer bookkeeping.
"""
import json
import subprocess
import sys

import numpy as np
import pytest

from flexflow_tpu.runtime import kvcache as jkv
from flexflow_tpu.runtime.resilience import FaultInjector as JFaults
from flexflow_tpu_torch.runtime import kvcache as tkv
from flexflow_tpu_torch.runtime.resilience import FaultInjector as TFaults

STATS = ("reservations", "exhaustions", "released", "accounting_errors")
SITES = ("kv_exhaustion", "shared_page_corruption", "release_race",
         "cow_fault")


def _call(pool, mod, op, *args, **kw):
    try:
        out = getattr(pool, op)(*args, **kw)
    except mod.KVCacheExhaustedError as e:
        return ("exhausted", e.pages_needed, e.pages_free, e.never_fits)
    except mod.SharedPageCorruptionError as e:
        return ("corrupt", e.kind)
    except mod.KVCacheAccountingError as e:
        return ("accounting", e.kind)
    except (KeyError, ValueError) as e:
        return (type(e).__name__,)
    if isinstance(out, (jkv.ReserveResult, tkv.ReserveResult)):
        out = (out.pages, out.shared_pages, out.matched_tokens)
    return ("ok", out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_matches_jax_under_a_random_workload(seed):
    rng = np.random.RandomState(seed)
    cfg = dict(num_pages=24, page_size=4)
    jp = jkv.PagePool(jkv.KVCacheConfig(**cfg))
    tp = tkv.PagePool(tkv.KVCacheConfig(**cfg))
    live, ids = [], 0
    for _ in range(300):
        r = rng.rand()
        if r < 0.3 or not live:
            seq = f"s{ids}"
            ids += 1
            args = (seq, rng.randint(1, 40))
            a = _call(jp, jkv, "reserve", *args)
            b = _call(tp, tkv, "reserve", *args)
            if a[0] == "ok":
                live.append(seq)
        else:
            seq = live[rng.randint(len(live))]
            op = rng.choice(["touch", "release", "release_twice"])
            if op == "touch":
                args = (seq, rng.randint(1, 40))
            else:
                args = (seq,)
                live.remove(seq)
            a = _call(jp, jkv, op.replace("_twice", ""), *args)
            b = _call(tp, tkv, op.replace("_twice", ""), *args)
            if op == "release_twice":
                assert a == b
                a = _call(jp, jkv, "release", *args)
                b = _call(tp, tkv, "release", *args)
        assert a == b
        assert jp.pages_free == tp.pages_free
        assert jp.pages_in_use == tp.pages_in_use
    for seq in live:
        assert jp.page_table(seq) == tp.page_table(seq)
    assert {k: jp.stats[k] for k in STATS} == {k: tp.stats[k] for k in STATS}
    assert jp.audit().ok and tp.audit().ok
    for seq in live:
        jp.release(seq)
        tp.release(seq)
    assert tp.pages_free == cfg["num_pages"] and tp.audit().ok


def test_config_validation_matches_jax():
    for bad in (dict(num_pages=0), dict(num_pages=4, page_size=0),
                dict(num_pages=4, watermark=1.0),
                dict(num_pages=4, watermark=-0.1),
                dict(num_pages=1, watermark=0.5),
                dict(num_pages=4, kv_dtype="no_such_dtype")):
        with pytest.raises(ValueError):
            jkv.KVCacheConfig(**bad)
        with pytest.raises(ValueError):
            tkv.KVCacheConfig(**bad)
    for tokens in (0, 1, 4, 5, 17):
        assert tkv.KVCacheConfig(num_pages=4).pages_for(tokens) == \
            jkv.KVCacheConfig(num_pages=4).pages_for(tokens)
    for n, w in ((10, 0.0), (10, 0.05), (10, 0.1), (64, 0.1), (7, 0.5)):
        assert tkv.KVCacheConfig(num_pages=n, watermark=w) \
            .held_back_pages() == \
            jkv.KVCacheConfig(num_pages=n, watermark=w).held_back_pages()


def test_audit_reports_a_corrupted_pool():
    pool = tkv.PagePool(tkv.KVCacheConfig(num_pages=8, page_size=4))
    pool.reserve("a", 10)
    pool.touch("a", 6)
    assert pool.audit().ok
    state = pool.to_state()
    pool._free.append(pool.page_table("a")[0])  # a page both free and bound
    kinds = [v.kind for v in pool.audit().violations]
    assert kinds == ["freed_page_resident", "page_count_mismatch",
                     "freed_page_bound"]
    state["free"].append(state["tables"]["a"][0])
    assert [v.kind for v in jkv.audit_state(state).violations] == kinds


def test_prefix_keys_match_jax():
    rng = np.random.RandomState(5)
    for n, ps in ((0, 4), (3, 4), (16, 4), (37, 8), (64, 16)):
        toks = rng.randint(-5, 50257, n).tolist()
        assert tkv.prefix_page_keys(toks, ps) == jkv.prefix_page_keys(toks,
                                                                      ps)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_shared_pool_matches_jax_with_faults_armed(seed):
    """A random reserve(tokens=, writable=) / touch / publish /
    note_write / match_prefix / release workload over four shared
    prefixes, a watermark, and every fault site armed now and then on
    both pools: each call's outcome, then the whole state (tables,
    refcounts, index, charges, stats), after every call."""
    rng = np.random.RandomState(seed)
    cfg = dict(num_pages=40, page_size=4, watermark=0.1)
    jf, tf = JFaults(), TFaults()
    jp = jkv.PagePool(jkv.KVCacheConfig(**cfg), fault_injector=jf)
    tp = tkv.PagePool(tkv.KVCacheConfig(**cfg), fault_injector=tf)
    prefixes = [rng.randint(0, 64, 12).tolist() for _ in range(4)]
    live, ids, seen = {}, 0, set()
    for step in range(400):
        if step % 23 == 7:
            site = SITES[rng.randint(len(SITES))]
            extra = {"never_fits": True} if rng.rand() < 0.3 else {}
            jf.inject(site, **extra)
            tf.inject(site, **extra)
        r = rng.rand()
        if r < 0.35 or not live:
            seq = f"s{ids}"
            ids += 1
            toks = prefixes[rng.randint(4)] + rng.randint(
                0, 64, rng.randint(0, 7)).tolist()
            kw = dict(tokens=toks, writable=bool(rng.rand() < 0.5))
            args = (seq, len(toks) + rng.randint(1, 10))
            calls = [("reserve", args, kw)]
            res = [_call(jp, jkv, "reserve", *args, **kw),
                   _call(tp, tkv, "reserve", *args, **kw)]
            if res[0][0] == "ok":
                live[seq] = toks
                calls += [("touch", (seq, len(toks)), {}),
                          ("publish", (seq, toks), {})]
                for op, a, k in calls[1:]:
                    res += [_call(jp, jkv, op, *a, **k),
                            _call(tp, tkv, op, *a, **k)]
        else:
            seq = sorted(live)[rng.randint(len(live))]
            op = rng.choice(["note_write", "match_prefix", "release",
                             "touch"])
            if op == "note_write":
                args = (seq, rng.randint(len(live[seq]) + 4))
            elif op == "match_prefix":
                args = (live[seq][:rng.randint(len(live[seq]) + 1)],)
            elif op == "touch":
                args = (seq, len(live[seq]) + rng.randint(0, 6))
            else:
                args = (seq,)
                del live[seq]
            res = [_call(jp, jkv, op, *args), _call(tp, tkv, op, *args)]
        for a, b in zip(res[0::2], res[1::2]):
            assert a == b, (step, a, b)
            seen.add(a[0] if a[0] != "ok" else "ok")
        assert tp.to_state() == jp.to_state(), step
        assert tp.snapshot() == jp.snapshot()
        for pid in range(cfg["num_pages"]):
            assert tp.page_refs(pid) == jp.page_refs(pid)
        if step % 50 == 49:
            assert tp.audit().to_dict() == jp.audit().to_dict()
    assert tf.fired == jf.fired
    assert {"ok", "exhausted", "accounting"} <= seen
    assert tp.stats["prefix_hits"] > 0 and tp.stats["published"] > 0
    for seq in sorted(live):
        assert _call(jp, jkv, "release", seq) == _call(tp, tkv, "release",
                                                       seq)
    assert tp.to_state() == jp.to_state()
    assert tp.audit().to_dict() == jp.audit().to_dict()


def test_copy_on_write_and_unpublish_on_write_match_jax():
    """Two holders of a published page: a write copies it private (one
    page from the writable headroom); then the last holder writing its
    published page takes it out of the index in place; a cow_fault
    leaves the pool as it was."""
    out = []
    for mod, faults in ((jkv, JFaults()), (tkv, TFaults())):
        pool = mod.PagePool(mod.KVCacheConfig(num_pages=8, page_size=4),
                            fault_injector=faults)
        toks = list(range(8))
        pool.reserve("a", 10, tokens=toks)
        pool.touch("a", 8)
        assert pool.publish("a", toks) == 2
        rr = pool.reserve("b", 10, tokens=toks, writable=True)
        assert (rr.shared_pages, rr.matched_tokens) == (2, 8)
        faults.inject("cow_fault")
        before = pool.to_state()
        with pytest.raises(mod.KVCacheAccountingError) as e:
            pool.note_write("b", 1)
        assert e.value.kind == "cow_fault"
        after = pool.to_state()
        after["stats"], before["stats"] = {}, {}
        assert after == before
        new = pool.note_write("b", 1)
        pool.release("a")
        gone = pool.note_write("b", 5)  # sole holder of a published page
        out.append((new, gone, pool.to_state(), pool.audit().to_dict()))
    assert out[0] == out[1]
    assert out[1][0] is not None and out[1][1] is None


def _states():
    pool = jkv.PagePool(jkv.KVCacheConfig(num_pages=12, page_size=4))
    toks = list(range(9))
    pool.reserve("a", 12, tokens=toks)
    pool.touch("a", 9)
    pool.publish("a", toks)
    pool.reserve("b", 12, tokens=toks)
    pool.touch("b", 9)
    clean = pool.to_state()
    a0 = clean["tables"]["a"][0]
    a2 = clean["tables"]["a"][2]

    def bad(fn):
        s = json.loads(json.dumps(clean))
        fn(s)
        return s

    yield clean
    yield bad(lambda s: s["free"].append(s["free"][0]))
    yield bad(lambda s: s["free"].append(99))
    yield bad(lambda s: s["free"].pop())
    yield bad(lambda s: s["pages"][str(a0)].update(refs=5))
    yield bad(lambda s: s["pages"][str(a2)].update(refs=0))
    yield bad(lambda s: s["tables"]["b"].append(a2))
    yield bad(lambda s: s["tables"]["a"].append(77))
    yield bad(lambda s: s["index"].update(deadbeef=3))
    yield bad(lambda s: s["index"].update(
        {next(iter(s["index"])): a2}))
    yield bad(lambda s: s["headroom"].update(a=50))
    yield bad(lambda s: s["headroom"].update(c=-1))
    yield bad(lambda s: s["tables"].update(z=[]))
    yield bad(lambda s: s["pages"][str(a2)].update(key="feed"))


def test_offline_audit_of_corrupted_states_matches_jax():
    kinds = set()
    for state in _states():
        j, t = jkv.audit_state(state), tkv.audit_state(state)
        assert t.to_dict() == j.to_dict()
        kinds |= {v.kind for v in t.violations}
    assert len(kinds) >= 12, kinds


def _cli(*args, cwd=None):
    r = subprocess.run([sys.executable, "-m",
                        "flexflow_tpu_torch.runtime.kvcache", *args],
                       capture_output=True, text=True, timeout=120, cwd=cwd)
    return r.returncode, r.stdout


def test_selftest_and_audit_cli_match_jax(tmp_path, capsys):
    rc, out = _cli("selftest", "--ops", "300", "--seed", "4")
    assert rc == 0, out
    assert jkv._run_selftest(300, 4, chaos=True) == 0
    jout = capsys.readouterr().out
    assert json.loads(out) == json.loads(jout)
    assert json.loads(out)["typed_errors"] > 0
    states = list(_states())
    paths = []
    for i, s in enumerate((states[0], states[4])):
        p = tmp_path / f"state{i}.json"
        p.write_text(json.dumps(s))
        paths.append(str(p))
    rc, out = _cli("audit", paths[0])
    assert rc == 0 and json.loads(out)["ok"]
    rc, out = _cli("audit", *paths)
    assert rc == 1
    assert jkv.main(["audit", *paths]) == 1
    assert out == capsys.readouterr().out
    rc, out = _cli()
    assert rc == 2


def test_kv_page_bytes_matches_jax():
    import flexflow_tpu as jff
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.ff_types import DataType

    def build(m, dt):
        ids = m.create_tensor((2, 8), dt.DT_INT32)
        t = m.embedding(ids, 16, 24)
        t = m.multihead_attention(t, t, t, 24, 3, causal=True)
        t = m.multihead_attention(t, t, t, 24, 2, kdim=8, vdim=4)
        m.dense(t, 16)

    cfg = jff.FFConfig()
    cfg.batch_size = 2
    jm = jff.FFModel(cfg)
    build(jm, jff.DataType)
    jm.compile(jff.SGDOptimizer(lr=0.01), jff.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    tm = FFModel(FFConfig(batch_size=2, device="cpu"))
    build(tm, DataType)
    tm.compile()
    for ps, dt in ((16, None), (4, "int8"), (8, "bfloat16")):
        assert tkv.kv_page_bytes(tm, ps, dt) == jkv.kv_page_bytes(jm, ps, dt)
    assert tkv.kv_page_bytes(tm, 16) > 0
    assert tkv.kv_page_bytes(object(), 16) is None
