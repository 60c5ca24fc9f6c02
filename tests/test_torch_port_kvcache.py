"""flexflow_tpu_torch's page pool against the JAX package's: the same
seeded sequence of reserve / touch / release calls must give the same
results, the same page tables, the same typed failures and the same
counters on both, and leave both audit-clean. The port keeps the slot/page
accounting only, so the JAX pool is driven without prompt tokens (no
prefix sharing) and without a watermark."""
import numpy as np
import pytest

from flexflow_tpu.runtime import kvcache as jkv
from flexflow_tpu_torch.runtime import kvcache as tkv

STATS = ("reservations", "exhaustions", "released", "accounting_errors")


def _call(pool, mod, op, *args, **kw):
    try:
        return ("ok", getattr(pool, op)(*args, **kw))
    except mod.KVCacheExhaustedError as e:
        return ("exhausted", e.pages_needed, e.pages_free, e.never_fits)
    except mod.KVCacheAccountingError as e:
        return ("accounting", e.kind)
    except (KeyError, ValueError) as e:
        return (type(e).__name__,)


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
                a = ("ok", a[1].pages)
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
    assert jp.audit().ok and tp.audit() == []
    for seq in live:
        jp.release(seq)
        tp.release(seq)
    assert tp.pages_free == cfg["num_pages"] and tp.audit() == []


def test_config_validation_matches_jax():
    for bad in (dict(num_pages=0), dict(num_pages=4, page_size=0)):
        with pytest.raises(ValueError):
            jkv.KVCacheConfig(**bad)
        with pytest.raises(ValueError):
            tkv.KVCacheConfig(**bad)
    for tokens in (0, 1, 4, 5, 17):
        assert tkv.KVCacheConfig(num_pages=4).pages_for(tokens) == \
            jkv.KVCacheConfig(num_pages=4).pages_for(tokens)


def test_audit_reports_a_corrupted_pool():
    pool = tkv.PagePool(tkv.KVCacheConfig(num_pages=8, page_size=4))
    pool.reserve("a", 10)
    pool.touch("a", 6)
    assert pool.audit() == []
    pool._free.append(pool.page_table("a")[0])  # a page both free and bound
    assert [k for k, _ in pool.audit()] == ["page_count_mismatch"]
