"""Paged KV-cache allocation with content-addressed prefix sharing.

The PyTorch counterpart of flexflow_tpu/runtime/kvcache.py, whole.
Continuous batching (runtime/serving.py) admits requests at token
granularity, so the scarce resource is KV-cache memory: this pool turns
cache growth into an admission signal, and lets the system prompt shared
by many sessions be charged once.

  * memory is carved into fixed-size **pages** of `page_size` positions;
  * every FULL page of prompt tokens is **content-addressed** by a rolling
    hash chain ``h_{i+1} = sha1(h_i || block_i)``: a key commits to the
    whole prefix, so two sequences share a page only when everything
    before it matches too;
  * ``reserve(seq_id, max_tokens, tokens=...)`` attaches the already
    published pages of the prompt with their refcounts bumped and charges
    only the unshared remainder (``writable=True`` charges the full worst
    case, so every copy-on-write is pre-budgeted);
  * ``note_write`` before a write: a no-op on a private page, an
    unpublish on a published page with one holder, **copy-on-write** on a
    shared one, so shared pages never change;
  * ``release`` **decrefs**: a page goes back to the free list when its
    last holder retires. Double release is a typed
    ``KVCacheAccountingError`` (``ff_kv_accounting_errors_total``);
  * ``audit()`` proves the invariants (refcounts equal table bindings, no
    orphan or freed page bound, the index consistent, the headroom within
    the free list); ``python -m flexflow_tpu_torch.runtime.kvcache audit``
    runs the same sweep over ``dump_state()`` JSON, and ``selftest``
    hammers a pool with the fault sites armed.

The pool is host-side bookkeeping, as in the JAX package. The physical
decode caches are dense per-slot strips (`executor.build_decode`), so a
shared page is an accounting discount (more sessions admitted in the same
page budget); the batcher's prefill memo is what skips a repeated
prompt's compute (runtime/serving.py).

Fault sites (`FaultInjector`): ``kv_exhaustion`` fails a reservation as
if the pool were full; ``shared_page_corruption`` fails a chain's
integrity check (the chain is quarantined, admission degrades to
unshared); ``release_race`` synthesizes a racing second release (the
typed double release surfaces); ``cow_fault`` fails a copy-on-write
before any state changes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .resilience import ResilienceError


class KVCacheExhaustedError(ResilienceError):
    """A reservation could not be satisfied: the pool is out of pages (or
    the ``kv_exhaustion`` fault site simulated it). `never_fits` tells
    the admission controller to shed (the request exceeds the whole pool)
    rather than wait for retirements."""

    def __init__(self, msg: str, *, pages_needed: int = 0,
                 pages_free: int = 0, never_fits: bool = False):
        super().__init__(msg)
        self.pages_needed = pages_needed
        self.pages_free = pages_free
        self.never_fits = never_fits


class KVCacheAccountingError(ResilienceError):
    """A page-accounting invariant was violated: double release, a write
    without a reservation, copy-on-write without headroom, an injected
    ``cow_fault``/``release_race``, or an ``audit()`` failure. Every raise
    is counted in ``ff_kv_accounting_errors_total{kind=...}``."""

    def __init__(self, msg: str, *, kind: str = "accounting",
                 seq_id: Optional[str] = None):
        super().__init__(msg)
        self.kind = kind
        self.seq_id = seq_id


class SharedPageCorruptionError(KVCacheAccountingError):
    """A content-addressed chain failed its integrity check (the
    ``shared_page_corruption`` fault site). The chain is quarantined
    (unpublished, so no later admission attaches it) before this is
    raised."""


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Sizing of the page pool: `num_pages * page_size` token positions
    across all in-flight sequences; `watermark` holds back a fraction of
    the pages from admission. `kv_dtype` (a numpy dtype name) prices a
    page in `kv_page_bytes`; None defers to the executor's compute
    dtype."""

    num_pages: int
    page_size: int = 16
    watermark: float = 0.0
    kv_dtype: Optional[str] = None

    def __post_init__(self):
        if self.num_pages <= 0:
            raise ValueError(f"num_pages must be positive: {self.num_pages}")
        if self.page_size <= 0:
            raise ValueError(f"page_size must be positive: {self.page_size}")
        if not 0.0 <= self.watermark < 1.0:
            raise ValueError(f"watermark must be in [0, 1): {self.watermark}")
        if self.kv_dtype is not None:
            import numpy as np

            try:
                np.dtype(self.kv_dtype)
            except TypeError as e:
                raise ValueError(
                    f"kv_dtype {self.kv_dtype!r} is not a numpy dtype "
                    f"name: {e}") from e
        if self.watermark > 0.0 and self.held_back_pages() >= self.num_pages:
            raise ValueError(
                f"watermark {self.watermark} holds back every page of a "
                f"{self.num_pages}-page pool: nothing is admittable")

    def held_back_pages(self) -> int:
        """Pages the watermark withholds from admission, rounded up (a
        positive watermark always holds back at least one page)."""
        if self.watermark <= 0.0:
            return 0
        return max(1, int(math.ceil(self.num_pages * self.watermark - 1e-9)))

    def pages_for(self, tokens: int) -> int:
        return max(1, -(-int(tokens) // self.page_size))


_HASH_SEED = b"ffkv/1"


def prefix_page_keys(tokens: Sequence[int], page_size: int) -> List[str]:
    """Content-address every FULL `page_size` block of `tokens` with a
    rolling hash chain: ``h_{i+1} = sha1(h_i || block_i)``, key =
    ``hex(h)[:16]``. Chaining means a key commits to the entire prefix
    up to and including its block, so an index hit at block i implies
    blocks 0..i all match — prefix matching is a plain walk, no trie
    needed. A partial tail block gets no key: it is private by
    construction."""
    keys: List[str] = []
    h = _HASH_SEED
    for b in range(len(tokens) // page_size):
        block = tokens[b * page_size:(b + 1) * page_size]
        payload = h + b"".join(
            int(t).to_bytes(8, "little", signed=True) for t in block)
        h = hashlib.sha1(payload).digest()
        keys.append(h.hex()[:16])
    return keys


@dataclasses.dataclass(frozen=True)
class ReserveResult:
    """What `reserve()` admitted: `pages` newly charged against the
    budget, `shared_pages` attached from the content index with their
    refcounts bumped, covering the first `matched_tokens` positions."""

    pages: int
    shared_pages: int = 0
    matched_tokens: int = 0


class _Page:
    """Resident-page metadata: `refs` table bindings hold it; `key` is
    its content-index key when published (None while private)."""

    __slots__ = ("refs", "key")

    def __init__(self, refs: int = 1, key: Optional[str] = None):
        self.refs = refs
        self.key = key


@dataclasses.dataclass(frozen=True)
class AuditViolation:
    kind: str
    detail: str


@dataclasses.dataclass
class AuditReport:
    """Result of a pool invariant sweep; `ok` iff zero violations."""

    violations: List[AuditViolation]
    pages_resident: int
    pages_free: int
    bindings: int

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "pages_resident": self.pages_resident,
            "pages_free": self.pages_free,
            "bindings": self.bindings,
            "violations": [dataclasses.asdict(v) for v in self.violations],
        }


def _audit_structures(num_pages: int, free: List[int],
                      pages: Dict[int, Tuple[int, Optional[str]]],
                      tables: Dict[str, List[int]],
                      index: Dict[str, int],
                      headroom: Dict[str, int]) -> List[AuditViolation]:
    """The invariant checker proper, over plain structures so the live
    `PagePool.audit()` and the offline `audit_state()` CLI run the exact
    same sweep. Each violation kind names one way the pool can rot:
    leaks (page_count_mismatch/orphan_page), double frees
    (freed_page_resident/freed_page_bound), refcount corruption
    (refcount_mismatch/zero_ref_resident), index rot
    (index_dangling/index_mismatch/unindexed_published) and admission
    deadlock (headroom_exceeds_free)."""
    v: List[Tuple[str, str]] = []
    free_set = set(free)
    if len(free_set) != len(free):
        v.append(("free_list_duplicate",
                  f"{len(free) - len(free_set)} duplicate id(s) on the "
                  f"free list"))
    for pid in sorted(free_set):
        if not 0 <= pid < num_pages:
            v.append(("free_list_out_of_range", f"page {pid}"))
    overlap = free_set & set(pages)
    if overlap:
        v.append(("freed_page_resident",
                  f"page(s) {sorted(overlap)} both free and resident"))
    if len(free) + len(pages) != num_pages:
        v.append(("page_count_mismatch",
                  f"{len(free)} free + {len(pages)} resident != "
                  f"{num_pages} total (leak or double-free)"))
    bindings: Dict[int, int] = {}
    for seq, table in sorted(tables.items()):
        seen = set()
        for pid in table:
            bindings[pid] = bindings.get(pid, 0) + 1
            if pid in seen:
                v.append(("duplicate_binding",
                          f"sequence {seq!r} binds page {pid} twice"))
            seen.add(pid)
            if pid in free_set:
                v.append(("freed_page_bound",
                          f"sequence {seq!r} holds freed page {pid}"))
            elif pid not in pages:
                v.append(("unknown_page_bound",
                          f"sequence {seq!r} holds unknown page {pid}"))
    for pid in sorted(pages):
        refs, key = pages[pid]
        n = bindings.get(pid, 0)
        if refs != n:
            v.append(("refcount_mismatch",
                      f"page {pid}: refs={refs} but {n} binding(s)"))
        if refs <= 0:
            v.append(("zero_ref_resident",
                      f"page {pid} resident with refs={refs}"))
        elif n == 0:
            v.append(("orphan_page",
                      f"page {pid} resident with refs={refs} but no "
                      f"binding"))
        if key is not None and index.get(key) != pid:
            v.append(("unindexed_published",
                      f"page {pid} published as {key!r} but the index "
                      f"maps that key to {index.get(key)}"))
    for key in sorted(index):
        pid = index[key]
        if pid not in pages:
            v.append(("index_dangling",
                      f"key {key!r} -> non-resident page {pid}"))
        elif pages[pid][1] != key:
            v.append(("index_mismatch",
                      f"key {key!r} -> page {pid} which is published as "
                      f"{pages[pid][1]!r}"))
    total_headroom = sum(headroom.values())
    if total_headroom > len(free):
        v.append(("headroom_exceeds_free",
                  f"{total_headroom} page(s) of reservation headroom "
                  f"exceed {len(free)} free — an admitted sequence could "
                  f"deadlock mid-decode"))
    for seq in sorted(headroom):
        if headroom[seq] < 0:
            v.append(("negative_headroom",
                      f"sequence {seq!r}: {headroom[seq]}"))
        if seq not in tables:
            v.append(("charge_without_table",
                      f"sequence {seq!r} charged but has no page table"))
    for seq in sorted(tables):
        if seq not in headroom:
            v.append(("table_without_charge",
                      f"sequence {seq!r} has a page table but no charge"))
    return [AuditViolation(kind, detail) for kind, detail in v]


class PagePool:
    """Thread-safe refcounted page allocator with per-sequence page
    tables and a content-addressed shared-prefix index.

    Lifecycle per sequence: ``reserve(seq_id, max_tokens, tokens=...)``
    at admission (the hard budget check + prefix attach),
    ``touch(seq_id, tokens)`` as the sequence grows (materializes
    private pages out of the reservation headroom),
    ``note_write(seq_id, pos)`` before a token write lands (no-op on
    private pages, copy-on-write on shared ones),
    ``publish(seq_id, tokens)`` once the prompt is materialized (makes
    its full blocks matchable), ``release(seq_id)`` at
    retirement/shed/failover (decref; pages free at zero). All are
    O(pages) and safe to call from the batcher, admission and failover
    threads concurrently."""

    def __init__(self, config: KVCacheConfig, *, fault_injector=None):
        self.config = config
        self.fault_injector = fault_injector
        self._lock = threading.Lock()
        self._free: List[int] = list(range(config.num_pages))[::-1]
        self._pages: Dict[int, _Page] = {}
        self._tables: Dict[str, List[int]] = {}
        self._charged: Dict[str, int] = {}
        self._headroom: Dict[str, int] = {}
        self._limit: Dict[str, int] = {}
        self._index: Dict[str, int] = {}
        self.stats = {"reservations": 0, "exhaustions": 0, "released": 0,
                      "prefix_hits": 0, "shared_attached": 0,
                      "published": 0, "cow": 0, "unpublished_on_write": 0,
                      "accounting_errors": 0, "corruptions": 0,
                      "audits": 0}

    # -- introspection ---------------------------------------------------
    @property
    def num_pages(self) -> int:
        return self.config.num_pages

    @property
    def pages_free(self) -> int:
        """Physical pages not spoken for: on the free list and not
        promised to any admitted sequence's remaining headroom. Equals
        `num_pages - pages_reserved` when nothing is shared; with
        sharing it is the true admittable supply (shared-but-resident
        pages whose original charge retired are correctly excluded)."""
        with self._lock:
            return len(self._free) - sum(self._headroom.values())

    @property
    def pages_reserved(self) -> int:
        """Pages charged to admitted sequences (sharing discounts the
        charge, so this can be less than the sum of worst cases)."""
        with self._lock:
            return sum(self._charged.values())

    @property
    def pages_in_use(self) -> int:
        """Table BINDINGS across sequences — what `ff_kv_pages_in_use`
        reports. A page shared by k sequences counts k times here and
        once in `pages_resident`; the auditor proves the two views agree
        with the refcounts."""
        with self._lock:
            return sum(len(t) for t in self._tables.values())

    @property
    def pages_resident(self) -> int:
        """Physically materialized pages (each counted once)."""
        with self._lock:
            return len(self._pages)

    @property
    def pages_shared(self) -> int:
        """Resident pages bound by more than one sequence — the
        `ff_kv_pages_shared` gauge, i.e. the dedup win in pages."""
        with self._lock:
            return sum(1 for m in self._pages.values() if m.refs > 1)

    def snapshot(self) -> Dict[str, int]:
        """Consistent one-lock view of the pool's occupancy — the
        request flight recorder attaches this to kv_reserve/kv_release
        trace events, where separately-locked property reads could tear
        against a concurrent admission."""
        with self._lock:
            used = sum(len(t) for t in self._tables.values())
            reserved = sum(self._charged.values())
            headroom = sum(self._headroom.values())
            shared = sum(1 for m in self._pages.values() if m.refs > 1)
            return {"pages_in_use": used, "pages_reserved": reserved,
                    "pages_free": len(self._free) - headroom,
                    "pages_resident": len(self._pages),
                    "pages_shared": shared}

    def page_table(self, seq_id: str) -> tuple:
        with self._lock:
            return tuple(self._tables.get(seq_id, ()))

    def holds(self, seq_id: str) -> bool:
        with self._lock:
            return seq_id in self._charged

    def page_refs(self, page_id: int) -> int:
        """Refcount of a resident page (0 when free/unknown)."""
        with self._lock:
            meta = self._pages.get(page_id)
            return meta.refs if meta is not None else 0

    def _admittable_locked(self) -> int:
        # held-back watermark pages never count toward admission; the
        # supply is physical (free list minus outstanding headroom), so
        # shared residency is priced correctly
        return (len(self._free) - sum(self._headroom.values())
                - self.config.held_back_pages())

    def can_reserve(self, max_tokens: int,
                    tokens: Optional[Sequence[int]] = None) -> bool:
        need = self.config.pages_for(max_tokens)
        with self._lock:
            if tokens is not None:
                keys = prefix_page_keys(tokens, self.config.page_size)
                need -= len(self._match_locked(keys, need))
            return need <= self._admittable_locked()

    def never_fits(self, max_tokens: int) -> bool:
        """True when the demand exceeds the WHOLE pool — waiting for
        retirements can't help, so the request must be shed."""
        return self.config.pages_for(max_tokens) > (
            self.config.num_pages - self.config.held_back_pages()
        )

    # -- prefix sharing --------------------------------------------------
    def _match_locked(self, keys: List[str], limit: int) -> List[int]:
        pages: List[int] = []
        for key in keys[:limit]:
            pid = self._index.get(key)
            if pid is None:
                break  # chain hash: a miss here means no later block hits
            pages.append(pid)
        return pages

    def _quarantine_chain_locked(self, keys: List[str]) -> int:
        n = 0
        for key in keys:
            pid = self._index.pop(key, None)
            if pid is not None:
                meta = self._pages.get(pid)
                if meta is not None and meta.key == key:
                    meta.key = None
                n += 1
        return n

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[int, tuple]:
        """Longest already-materialized shared prefix of `tokens`:
        ``(matched_tokens, page_ids)``. Read-only — refcounts are bumped
        only by `reserve(..., tokens=...)`, which re-walks the index
        under its own lock (this view can go stale the moment the lock
        drops). Fault site ``shared_page_corruption`` fails the chain's
        integrity check here: the chain is quarantined and the typed
        error raised."""
        keys = prefix_page_keys(tokens, self.config.page_size)
        plan = None
        if self.fault_injector is not None and keys:
            plan = self.fault_injector.fire("shared_page_corruption")
        with self._lock:
            if plan is not None:
                n = self._quarantine_chain_locked(keys)
                self.stats["corruptions"] += 1
                self.stats["accounting_errors"] += 1
                self._note_typed("shared_page_corruption")
            else:
                pages = self._match_locked(keys, len(keys))
        if plan is not None:
            raise SharedPageCorruptionError(
                f"shared-prefix chain failed integrity check (fault "
                f"injection): {n} key(s) quarantined",
                kind="shared_page_corruption")
        return len(pages) * self.config.page_size, tuple(pages)

    def publish(self, seq_id: str, tokens: Sequence[int]) -> int:
        """Make `seq_id`'s materialized FULL blocks of `tokens`
        content-addressable so later admissions can attach them. Returns
        blocks newly published. Publishing is what freezes a page: any
        later write to it goes through copy-on-write."""
        keys = prefix_page_keys(tokens, self.config.page_size)
        published = 0
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                self.stats["accounting_errors"] += 1
                self._note_typed("publish_without_reservation")
                raise KVCacheAccountingError(
                    f"publish for {seq_id!r} which holds no reservation",
                    kind="publish_without_reservation", seq_id=seq_id)
            for i, key in enumerate(keys):
                if i >= len(table):
                    break  # block not materialized yet
                if key in self._index:
                    continue  # chain already published (possibly by us)
                meta = self._pages[table[i]]
                if meta.key is not None:
                    continue  # already addressed under different content
                meta.key = key
                self._index[key] = table[i]
                published += 1
            if published:
                self.stats["published"] += published
        if published:
            self._export()
        return published

    # -- lifecycle -------------------------------------------------------
    def reserve(self, seq_id: str, max_tokens: int, *,
                tokens: Optional[Sequence[int]] = None,
                writable: bool = False) -> ReserveResult:
        """Admit `seq_id` with a worst case of `max_tokens` positions.

        With `tokens` (the prompt) given, already-published prefix pages
        are attached refcounted and DISCOUNTED from the charge — the
        admittable budget only pays for the unshared remainder. With
        `writable=True` the FULL worst case is charged even when pages
        are attached, so every potential copy-on-write is pre-budgeted
        (use this when the caller intends to write inside the shared
        prefix). Raises KVCacheExhaustedError (never silently
        over-commits) when the admittable budget can't cover the charge;
        `never_fits` on the error distinguishes "wait" from "shed"."""
        need = self.config.pages_for(max_tokens)
        if self.fault_injector is not None:
            plan = self.fault_injector.fire("kv_exhaustion")
            if plan is not None:
                self.stats["exhaustions"] += 1
                raise KVCacheExhaustedError(
                    f"kv page pool exhausted (fault injection): "
                    f"{need} page(s) for {seq_id}",
                    pages_needed=need, pages_free=0,
                    never_fits=bool(plan.get("never_fits", False)),
                )
        keys: List[str] = []
        if tokens is not None:
            keys = prefix_page_keys(tokens, self.config.page_size)
        corrupt = None
        if self.fault_injector is not None and keys:
            corrupt = self.fault_injector.fire("shared_page_corruption")
        with self._lock:
            if seq_id in self._charged:
                raise ValueError(f"sequence {seq_id!r} already reserved")
            shared: List[int] = []
            if corrupt is not None:
                # integrity check failed: quarantine the chain and admit
                # unshared — a corrupt shared page must never be attached
                self._quarantine_chain_locked(keys)
                self.stats["corruptions"] += 1
                self.stats["accounting_errors"] += 1
                self._note_typed("shared_page_corruption")
            elif keys:
                shared = self._match_locked(keys, need)
            charge = need if writable else need - len(shared)
            avail = self._admittable_locked()
            if charge > avail:
                self.stats["exhaustions"] += 1
                raise KVCacheExhaustedError(
                    f"kv page pool exhausted: {charge} page(s) needed "
                    f"for {seq_id}, {avail} admittable of "
                    f"{self.config.num_pages}",
                    pages_needed=charge, pages_free=max(0, avail),
                    never_fits=charge > (self.config.num_pages
                                         - self.config.held_back_pages()),
                )
            for pid in shared:
                self._pages[pid].refs += 1
            self._tables[seq_id] = list(shared)
            self._charged[seq_id] = charge
            self._headroom[seq_id] = charge
            self._limit[seq_id] = need
            self.stats["reservations"] += 1
            if shared:
                self.stats["prefix_hits"] += 1
                self.stats["shared_attached"] += len(shared)
                self._note_prefix_hit(len(shared))
        self._export()
        return ReserveResult(
            pages=charge, shared_pages=len(shared),
            matched_tokens=len(shared) * self.config.page_size)

    def touch(self, seq_id: str, tokens: int) -> List[int]:
        """Materialize private pages so positions [0, tokens) are
        backed; returns the newly allocated page ids (empty when already
        covered, including by attached shared pages). Growth beyond the
        reservation is a caller bug and raises — the admission-time
        worst case is the contract that makes mid-decode deadlock
        impossible."""
        with self._lock:
            if seq_id not in self._charged:
                raise KeyError(f"sequence {seq_id!r} holds no reservation")
            table = self._tables[seq_id]
            need = self.config.pages_for(tokens)
            if need > self._limit[seq_id]:
                raise ValueError(
                    f"sequence {seq_id!r} grew to {need} page(s), beyond "
                    f"its reservation of {self._limit[seq_id]}"
                )
            new = []
            while len(table) < need:
                if self._headroom[seq_id] <= 0:
                    self.stats["accounting_errors"] += 1
                    self._note_typed("headroom_underrun")
                    raise KVCacheAccountingError(
                        f"sequence {seq_id!r} materialization exceeds its "
                        f"charged headroom",
                        kind="headroom_underrun", seq_id=seq_id)
                # free list can't underrun: every pop is covered by
                # charged headroom, and Σ headroom <= len(free) always
                pid = self._free.pop()
                self._pages[pid] = _Page()
                self._headroom[seq_id] -= 1
                table.append(pid)
                new.append(pid)
        if new:
            self._export()
        return new

    def note_write(self, seq_id: str, pos: int) -> Optional[int]:
        """Record that a token write is landing at position `pos`.
        Private page: no-op (returns None). Published page with a single
        holder: retracted from the content index and written in place.
        Shared page (refs > 1): COPY-ON-WRITE — a private page is
        allocated out of the reservation headroom, rebound in this
        sequence's table, and the shared page decref'd; returns the new
        page id. Fault site ``cow_fault`` fails the copy BEFORE any
        state mutates, so the pool stays audit-clean for the failover
        path."""
        block = int(pos) // self.config.page_size
        cow_pid = None
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                self.stats["accounting_errors"] += 1
                self._note_typed("write_without_reservation")
                raise KVCacheAccountingError(
                    f"write at position {pos} for {seq_id!r} which holds "
                    f"no reservation",
                    kind="write_without_reservation", seq_id=seq_id)
            if block >= len(table):
                return None  # not materialized yet; touch() allocates private
            pid = table[block]
            meta = self._pages[pid]
            if meta.refs == 1 and meta.key is None:
                return None  # already private
            if meta.refs == 1:
                # sole holder writing a published page: unpublish and
                # write in place — no copy needed
                self._index.pop(meta.key, None)
                meta.key = None
                self.stats["unpublished_on_write"] += 1
                return None
            plan = None
            if self.fault_injector is not None:
                plan = self.fault_injector.fire("cow_fault")
            if plan is not None:
                self.stats["accounting_errors"] += 1
                self._note_typed("cow_fault")
                raise KVCacheAccountingError(
                    f"copy-on-write fault injected for {seq_id!r} block "
                    f"{block}", kind="cow_fault", seq_id=seq_id)
            if self._headroom[seq_id] <= 0:
                self.stats["accounting_errors"] += 1
                self._note_typed("cow_without_headroom")
                raise KVCacheAccountingError(
                    f"copy-on-write for {seq_id!r} block {block} needs a "
                    f"page but the reservation has no headroom (reserve "
                    f"with writable=True to pre-budget shared-prefix "
                    f"writes)", kind="cow_without_headroom", seq_id=seq_id)
            cow_pid = self._free.pop()
            self._headroom[seq_id] -= 1
            self._pages[cow_pid] = _Page()
            table[block] = cow_pid
            meta.refs -= 1  # still >= 1: the other holders keep it
            self.stats["cow"] += 1
        from .. import obs
        obs.count("ff_kv_cow_total",
                  help="KV pages privatized by copy-on-write")
        self._export()
        return cow_pid

    def release(self, seq_id: str, *, missing_ok: bool = False) -> int:
        """Decref `seq_id`'s pages and return its reservation to the
        pool; a page goes back on the free list only at refcount zero.
        Returns pages physically freed. Releasing an unknown or
        already-released sequence raises a typed KVCacheAccountingError
        (counted in ``ff_kv_accounting_errors_total``) — failover and
        retirement must transfer ownership exactly once. Call sites that
        legitimately race a release they cannot observe (e.g. scale-down
        sweeping slots a dying serve loop already freed) pass
        ``missing_ok=True``."""
        with self._lock:
            if seq_id not in self._charged:
                if missing_ok:
                    return 0
                self.stats["accounting_errors"] += 1
                self._note_typed("double_release")
                raise KVCacheAccountingError(
                    f"release of unknown or already-released sequence "
                    f"{seq_id!r} — failover must transfer page ownership "
                    f"exactly once", kind="double_release", seq_id=seq_id)
            table = self._tables.pop(seq_id)
            freed = 0
            for pid in table:
                meta = self._pages[pid]
                meta.refs -= 1
                if meta.refs == 0:
                    if meta.key is not None:
                        self._index.pop(meta.key, None)
                    del self._pages[pid]
                    self._free.append(pid)
                    freed += 1
            del self._charged[seq_id]
            del self._headroom[seq_id]
            del self._limit[seq_id]
            self.stats["released"] += 1
        self._export()
        if self.fault_injector is not None:
            plan = self.fault_injector.fire("release_race")
            if plan is not None:
                # the injected race: a second releaser loses and must
                # surface as a typed accounting error, not corruption
                return self.release(seq_id)
        return freed

    # -- auditing --------------------------------------------------------
    def audit(self, *, raise_on_violation: bool = False) -> AuditReport:
        """Prove the pool's invariants (see `_audit_structures`). Run
        after every chaos leg; any violation bumps
        ``ff_kv_audit_violations_total`` and emits a structured event."""
        with self._lock:
            free = list(self._free)
            pages = {pid: (m.refs, m.key) for pid, m in self._pages.items()}
            tables = {s: list(t) for s, t in self._tables.items()}
            index = dict(self._index)
            headroom = dict(self._headroom)
            self.stats["audits"] += 1
        violations = _audit_structures(self.config.num_pages, free, pages,
                                       tables, index, headroom)
        report = AuditReport(
            violations=violations, pages_resident=len(pages),
            pages_free=len(free),
            bindings=sum(len(t) for t in tables.values()))
        if violations:
            from .. import obs
            obs.count("ff_kv_audit_violations_total", n=len(violations),
                      help="KV pool audit invariant violations")
            obs.event("kv_audit_violation", cat="serving",
                      total=len(violations), first=violations[0].kind)
            if raise_on_violation:
                raise KVCacheAccountingError(
                    f"pool audit failed: {len(violations)} violation(s); "
                    f"first: {violations[0].kind}: {violations[0].detail}",
                    kind="audit")
        return report

    def to_state(self) -> dict:
        """One-lock serializable snapshot of the full allocator state —
        `audit_state()` / the CLI run the same invariant sweep offline
        (post-mortem on a failed chaos leg, cross-process checks)."""
        with self._lock:
            return {
                "version": 1,
                "num_pages": self.config.num_pages,
                "page_size": self.config.page_size,
                "watermark": self.config.watermark,
                "free": list(self._free),
                "pages": {str(pid): {"refs": m.refs, "key": m.key}
                          for pid, m in self._pages.items()},
                "tables": {s: list(t) for s, t in self._tables.items()},
                "charged": dict(self._charged),
                "headroom": dict(self._headroom),
                "limit": dict(self._limit),
                "index": dict(self._index),
                "stats": dict(self.stats),
            }

    def dump_state(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_state(), f, indent=2, sort_keys=True)

    # -- metrics ---------------------------------------------------------
    def _note_typed(self, kind: str) -> None:
        from .. import obs
        obs.count("ff_kv_accounting_errors_total",
                  help="typed KV accounting errors (double release, COW "
                       "faults, corrupt shared chains)", kind=kind)

    def _note_prefix_hit(self, pages: int) -> None:
        from .. import obs
        obs.count("ff_kv_prefix_hits_total",
                  help="admissions that attached a shared KV prefix")
        obs.count("ff_kv_prefix_pages_attached_total", n=pages,
                  help="shared KV pages attached at admission")

    def _export(self) -> None:
        from .. import obs

        snap = self.snapshot()
        obs.gauge_set("ff_kv_pages_in_use", snap["pages_in_use"],
                      help="materialized KV-cache page bindings across "
                           "sequences")
        obs.gauge_set("ff_kv_pages_reserved", snap["pages_reserved"],
                      help="KV-cache pages committed to admitted sequences")
        obs.gauge_set("ff_kv_pages_shared", snap["pages_shared"],
                      help="resident KV pages bound by more than one "
                           "sequence")


def audit_state(state: dict) -> AuditReport:
    """Offline audit of a `PagePool.to_state()` / `dump_state()` JSON
    snapshot — the `python -m flexflow_tpu_torch.runtime.kvcache audit`
    entry point."""
    pages = {int(pid): (int(m["refs"]), m.get("key"))
             for pid, m in state.get("pages", {}).items()}
    tables = {s: [int(p) for p in t]
              for s, t in state.get("tables", {}).items()}
    headroom = {s: int(h) for s, h in state.get("headroom", {}).items()}
    violations = _audit_structures(
        int(state["num_pages"]), [int(p) for p in state.get("free", [])],
        pages, tables, dict(state.get("index", {})), headroom)
    return AuditReport(violations=violations, pages_resident=len(pages),
                       pages_free=len(state.get("free", [])),
                       bindings=sum(len(t) for t in tables.values()))


def kv_page_bytes(model, page_size: int,
                  kv_dtype: Optional[str] = None) -> Optional[int]:
    """Bytes one page costs across the model's self-attention layers
    (page_size * heads * (qk_head_dim + v_head_dim) * itemsize per
    layer), from the compiled graph. `kv_dtype` (a numpy dtype name)
    prices the page at that cache dtype; None takes the executor's
    compute dtype (f32 when unset). None when the graph has no fused
    multi-head attention."""
    import numpy as np
    import torch

    from ..ff_types import OperatorType

    ex = getattr(model, "executor", None)
    if ex is None:
        return None
    if kv_dtype is not None:
        itemsize = np.dtype(kv_dtype).itemsize
    else:
        cdt = getattr(ex, "compute_dtype", None)
        itemsize = (torch.empty((), dtype=cdt).element_size()
                    if cdt is not None else 4)
    total = 0
    for op in ex.topo:
        if getattr(op, "op_type", None) != OperatorType.OP_MULTIHEAD_ATTENTION:
            continue
        p = op.params
        total += page_size * p.num_heads * (p.qk_head_dim + p.v_head_dim) \
            * itemsize
    return total or None


# ----------------------------------------------------------------------
# auditor CLI: python -m flexflow_tpu_torch.runtime.kvcache {audit,selftest}
# The JSON verdict on stdout is the CLI's contract.
# ----------------------------------------------------------------------
def _run_selftest(ops: int, seed: int, chaos: bool) -> int:
    """Randomized reserve/COW/release lifecycle over shared prefixes,
    audited every 100 ops and once at the end; with chaos, all four fault
    sites are armed periodically and only typed errors may surface. Exit
    0 iff every audit is clean and the drained pool is empty."""
    import random

    rng = random.Random(seed)
    fi = None
    if chaos:
        from .resilience import FaultInjector
        fi = FaultInjector()
    pool = PagePool(KVCacheConfig(num_pages=64, page_size=4, watermark=0.1),
                    fault_injector=fi)
    prefixes = [[rng.randrange(256) for _ in range(16)] for _ in range(4)]
    live: Dict[str, List[int]] = {}
    violations = typed = 0
    sites = ("cow_fault", "release_race", "shared_page_corruption",
             "kv_exhaustion")
    for op in range(ops):
        if chaos and op % 97 == 13:
            fi.inject(rng.choice(sites), times=1)
        r = rng.random()
        try:
            if (r < 0.5 and len(live) < 12) or not live:
                seq = f"s{op}"
                toks = rng.choice(prefixes) + [
                    rng.randrange(256) for _ in range(rng.randrange(0, 8))]
                pool.reserve(seq, len(toks) + rng.randrange(1, 12),
                             tokens=toks, writable=True)
                pool.touch(seq, len(toks))
                pool.publish(seq, toks)
                live[seq] = toks
            elif r < 0.8:
                seq = rng.choice(sorted(live))
                pool.note_write(seq, rng.randrange(len(live[seq])))
            else:
                seq = rng.choice(sorted(live))
                del live[seq]
                pool.release(seq)
        except KVCacheExhaustedError:
            typed += 1
            if live:  # retire one under pressure and move on
                seq = sorted(live)[0]
                del live[seq]
                try:
                    pool.release(seq)
                except KVCacheAccountingError:  # injected release_race
                    typed += 1
        except KVCacheAccountingError:
            typed += 1
        if op % 100 == 99:
            violations += len(pool.audit().violations)
    for seq in sorted(live):
        pool.release(seq)
    final = pool.audit()
    violations += len(final.violations)
    drained = (pool.pages_in_use == 0 and pool.pages_resident == 0
               and pool.pages_free == pool.config.num_pages)
    summary = {
        "ops": ops, "seed": seed, "chaos": chaos,
        "typed_errors": typed, "violations": violations,
        "drained": drained, "stats": dict(pool.stats),
        "ok": violations == 0 and drained,
    }
    print(json.dumps(summary, indent=2, sort_keys=True))
    return 0 if summary["ok"] else 1


def _cli_audit(paths: List[str]) -> int:
    if not paths:
        # no snapshots: audit a built-in deterministic lifecycle, so the
        # bare `audit` is still a meaningful exit-code check
        return _run_selftest(ops=500, seed=0, chaos=False)
    rc = 0
    for path in paths:
        with open(path) as f:
            state = json.load(f)
        report = audit_state(state)
        out = dict(report.to_dict(), file=path)
        print(json.dumps(out, indent=2, sort_keys=True))
        if not report.ok:
            rc = 1
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.runtime.kvcache",
        description="KV page-pool auditor: prove refcount/leak/"
                    "double-free invariants over dumped pool state or a "
                    "randomized chaos lifecycle.")
    sub = p.add_subparsers(dest="cmd")
    pa = sub.add_parser(
        "audit", help="audit PagePool.dump_state() JSON snapshots "
                      "(no files: audit a built-in lifecycle)")
    pa.add_argument("states", nargs="*",
                    help="JSON files written by PagePool.dump_state()")
    ps = sub.add_parser(
        "selftest", help="randomized reserve/COW/release hammer with "
                         "chaos sites, audited every 100 ops")
    ps.add_argument("--ops", type=int, default=2000)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--no-chaos", action="store_true")
    args = p.parse_args(argv)
    if args.cmd == "audit":
        return _cli_audit(args.states)
    if args.cmd == "selftest":
        return _run_selftest(args.ops, args.seed, chaos=not args.no_chaos)
    p.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
