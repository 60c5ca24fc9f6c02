"""Paged KV-cache accounting.

The slot/page accounting of flexflow_tpu/runtime/kvcache.py's allocator
(PagePool and KVCacheConfig), with its own error base class. Continuous
batching admits requests at token granularity, so the scarce resource is
KV-cache memory: this pool turns cache growth into an admission signal.

  * memory is carved into fixed-size pages of `page_size` positions;
  * `reserve(seq_id, max_tokens)` charges a sequence's worst case up
    front, so an admitted request can never deadlock mid-decode waiting
    for a page held by another one;
  * `touch` materializes pages as the sequence grows, within its charge;
  * `release` returns them. Double release raises a typed
    KVCacheAccountingError.

The physical caches are dense per-slot strips (executor.build_decode), so
the JAX pool's content-addressed prefix sharing and copy-on-write would
save neither memory nor compute here; they come back with a paged
physical cache or the prefill-skip memo.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple


class KVCacheError(RuntimeError):
    """Base of the page pool's typed errors."""


class KVCacheExhaustedError(KVCacheError):
    """A reservation could not be satisfied. `never_fits` tells the
    admission controller to shed (the request exceeds the whole pool)
    rather than wait for retirements."""

    def __init__(self, msg: str, *, pages_needed: int = 0,
                 pages_free: int = 0, never_fits: bool = False):
        super().__init__(msg)
        self.pages_needed = pages_needed
        self.pages_free = pages_free
        self.never_fits = never_fits


class KVCacheAccountingError(KVCacheError):
    """A page-accounting invariant was violated: double release, or growth
    past the charged headroom."""

    def __init__(self, msg: str, *, kind: str = "accounting",
                 seq_id: Optional[str] = None):
        super().__init__(msg)
        self.kind = kind
        self.seq_id = seq_id


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Sizing of the page pool: `num_pages * page_size` token positions
    across all in-flight sequences."""

    num_pages: int
    page_size: int = 16

    def __post_init__(self):
        if self.num_pages <= 0:
            raise ValueError(f"num_pages must be positive: {self.num_pages}")
        if self.page_size <= 0:
            raise ValueError(f"page_size must be positive: {self.page_size}")

    def pages_for(self, tokens: int) -> int:
        return max(1, -(-int(tokens) // self.page_size))


class PagePool:
    """Thread-safe page allocator with per-sequence page tables. Per
    sequence: `reserve` at admission, `touch` as it grows, `release` at
    retirement."""

    def __init__(self, config: KVCacheConfig):
        self.config = config
        self._lock = threading.Lock()
        self._free: List[int] = list(range(config.num_pages))[::-1]
        self._tables: Dict[str, List[int]] = {}
        self._headroom: Dict[str, int] = {}
        self._limit: Dict[str, int] = {}
        self.stats = {"reservations": 0, "exhaustions": 0, "released": 0,
                      "accounting_errors": 0}

    # -- introspection -----------------------------------------------------
    @property
    def num_pages(self) -> int:
        return self.config.num_pages

    @property
    def pages_free(self) -> int:
        """Pages on the free list not promised to any admitted sequence."""
        with self._lock:
            return len(self._free) - sum(self._headroom.values())

    @property
    def pages_in_use(self) -> int:
        """Pages bound into sequences' tables."""
        with self._lock:
            return sum(len(t) for t in self._tables.values())

    def page_table(self, seq_id: str) -> tuple:
        with self._lock:
            return tuple(self._tables.get(seq_id, ()))

    def _account_error(self, msg: str, kind: str, seq_id: str):
        self.stats["accounting_errors"] += 1
        return KVCacheAccountingError(msg, kind=kind, seq_id=seq_id)

    # -- lifecycle ---------------------------------------------------------
    def reserve(self, seq_id: str, max_tokens: int) -> int:
        """Admit `seq_id` with a worst case of `max_tokens` positions;
        returns the pages charged. Raises KVCacheExhaustedError when the
        free, unpromised pages cannot cover the charge."""
        need = self.config.pages_for(max_tokens)
        with self._lock:
            if seq_id in self._limit:
                raise ValueError(f"sequence {seq_id!r} already reserved")
            avail = len(self._free) - sum(self._headroom.values())
            if need > avail:
                self.stats["exhaustions"] += 1
                raise KVCacheExhaustedError(
                    f"kv page pool exhausted: {need} page(s) needed for "
                    f"{seq_id}, {avail} admittable of {self.config.num_pages}",
                    pages_needed=need, pages_free=max(0, avail),
                    never_fits=need > self.config.num_pages)
            self._tables[seq_id] = []
            self._headroom[seq_id] = need
            self._limit[seq_id] = need
            self.stats["reservations"] += 1
        return need

    def touch(self, seq_id: str, tokens: int) -> List[int]:
        """Materialize pages so positions [0, tokens) are backed; returns
        the newly allocated page ids. Growth beyond the reservation is a
        caller bug and raises."""
        with self._lock:
            if seq_id not in self._limit:
                raise KeyError(f"sequence {seq_id!r} holds no reservation")
            table = self._tables[seq_id]
            need = self.config.pages_for(tokens)
            if need > self._limit[seq_id]:
                raise ValueError(
                    f"sequence {seq_id!r} grew to {need} page(s), beyond its "
                    f"reservation of {self._limit[seq_id]}")
            new = []
            while len(table) < need:
                if self._headroom[seq_id] <= 0:
                    raise self._account_error(
                        f"sequence {seq_id!r} materialization exceeds its "
                        "charged headroom", "headroom_underrun", seq_id)
                pid = self._free.pop()
                self._headroom[seq_id] -= 1
                table.append(pid)
                new.append(pid)
        return new

    def release(self, seq_id: str, *, missing_ok: bool = False) -> int:
        """Return `seq_id`'s pages and reservation; returns the pages
        freed. Releasing an unknown sequence raises unless `missing_ok`."""
        with self._lock:
            if seq_id not in self._limit:
                if missing_ok:
                    return 0
                raise self._account_error(
                    f"release of unknown or already-released sequence "
                    f"{seq_id!r}", "double_release", seq_id)
            table = self._tables.pop(seq_id)
            self._free.extend(table)
            del self._headroom[seq_id]
            del self._limit[seq_id]
            self.stats["released"] += 1
        return len(table)

    def audit(self) -> List[Tuple[str, str]]:
        """Invariant sweep; returns (kind, detail) violations, empty when
        the pool is sound: the free list and the tables partition the pool,
        headroom never exceeds the free list."""
        with self._lock:
            v: List[Tuple[str, str]] = []
            bound = [pid for t in self._tables.values() for pid in t]
            held = self._free + bound
            if len(set(held)) != len(held) or len(held) != self.num_pages:
                v.append(("page_count_mismatch",
                          f"{len(self._free)} free + {len(bound)} bound, "
                          f"{len(set(held))} distinct, of {self.num_pages}"))
            if sum(self._headroom.values()) > len(self._free):
                v.append(("headroom_exceeds_free",
                          f"{sum(self._headroom.values())} > "
                          f"{len(self._free)}"))
            return v
