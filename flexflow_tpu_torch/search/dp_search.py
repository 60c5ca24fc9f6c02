"""Unity's dynamic-programming machine-view assignment.

The PyTorch counterpart of flexflow_tpu/search/dp_search.py, the
reference SearchHelper
(include/flexflow/graph.h:170-284, src/runtime/graph.cc:1803
generic_optimal_cost): given a PCG (whose parallel *structure* — degrees and
parallel ops — was fixed by substitutions), assign a MachineView to every op
minimizing simulated step time, by recursively splitting the graph:

  * sequence split at a bottleneck node (a node no edge jumps over in topo
    order — the reference finds these via dominator analysis,
    graph.cc:1631): enumerate the bottleneck's views; DP over
    pre/post subgraphs with the boundary view fixed.
  * horizontal (non-sequence) split of parallel branches
    (graph.cc ~230-290 find_optimal_nonsequence_graph_time): independent
    components run either on the full machine sequentially or on disjoint
    halves concurrently (machine resource splitting).
  * leaf: min over valid machine views of op cost + input reshard cost.

Memoized by (subgraph, boundary views, resources) like the reference's
dp_state_hash (graph.cc:1864).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..pcg.graph import Graph
from ..pcg.machine_view import MachineResource, MachineView, enumerate_machine_views
from ..pcg.op import PCGOp
from ..utils.recursive_logger import search_logger as _rlog
from .cost_model import CostModel


@dataclasses.dataclass
class GraphCostResult:
    """reference: graph.h GraphCostResult {cost, views}"""

    cost: float
    views: Dict[int, MachineView]  # op guid -> view

    @staticmethod
    def infinity():
        return GraphCostResult(float("inf"), {})


class SearchHelper:
    def __init__(
        self,
        cost_model: CostModel,
        *,
        max_views_per_op: int = 32,
        trajectory=None,
    ):
        self.cost_model = cost_model
        self.machine = cost_model.machine
        self.max_views_per_op = max_views_per_op
        # obs.SearchTrajectory: records each DP subproblem decision
        # (sequence/nonsequence/diamond splits with their best costs) —
        # bounded by the trajectory's limit, so the hot memoized path
        # stays cheap (obs/trajectory.py)
        self.trajectory = trajectory
        self._memo: Dict[Tuple, GraphCostResult] = {}
        self._view_cache: Dict[Tuple, List[MachineView]] = {}
        self._node_cost_cache: Dict[Tuple, float] = {}
        self._comp_cache: Dict[Tuple, List[List[PCGOp]]] = {}
        # ops-tuple -> guid-tuple, keyed by tuple identity (strong ref to
        # the tuple pins its id). Sequence/nonsequence splits call
        # _cost_of with the SAME pre/post tuple once per bottleneck view,
        # and rebuilding a 300-guid tuple per call was ~30% of a
        # 32-worker Inception DP evaluation (profiled: 6M generator steps
        # in _memo_key alone).
        self._guid_tuples: Dict[int, Tuple] = {}
        # guid-tuple -> (consumed tensor guids, own op guids): the
        # _cost_of canonicalization sets, rebuilt 124k times per
        # 32-worker Inception DP evaluation otherwise
        self._obs_cache: Dict[Tuple, Tuple[set, set]] = {}
        # ops-tuple identity -> (local sids, ext index, tensor sid map):
        # the STRUCTURAL subproblem key (see _local_sids)
        self._sid_tuples: Dict[int, Tuple] = {}
        # full structural tuple -> small int id. Interning (instead of
        # hash()) makes sid equality EXACT: a 64-bit hash collision
        # between two different subproblems would silently merge their
        # memo entries and return a wrong cost/strategy with no
        # detection. Tuples stay shallow (producer sids are the interned
        # ints, not nested tuples), so lookup cost matches hashing.
        self._struct_intern: Dict[Tuple, int] = {}
        # Bumped whenever _struct_intern is cleared. The clear fires
        # inside _local_sids, which is reached MID-RECURSION from
        # _cost_of: stack frames above already computed their memo key
        # with OLD interned sids and store it into the freshly cleared
        # _memo after returning — and the rebuilt intern table reassigns
        # the same small ints to DIFFERENT structures, so a later lookup
        # could silently hit that stale entry (the exact silent-merge
        # failure interning exists to eliminate). Folding the generation
        # into every memo key makes pre-clear keys unmatchable.
        self._intern_gen: int = 0

    # -- machine view enumeration (reference: register_all_machine_views +
    #    Op::get_valid_machine_views) -----------------------------------
    def valid_views(self, op: PCGOp, res: MachineResource) -> List[MachineView]:
        degree = 1
        if op.outputs:
            degree = op.outputs[0].get_total_degree()
        key = (degree, res.hash())
        if key in self._view_cache:
            return self._view_cache[key]
        if degree == 1:
            # Degree-1 ops run whole on ONE chip; the only placement that
            # can matter is co-location with neighbors. One canonical
            # start PER NODE keeps the cross-node choice (a consumer can
            # follow its producer's node and dodge a DCN hop) while
            # collapsing the intra-node singleton starts, which are
            # cost-equivalent up to hop latency: the bandwidth term is
            # start-independent, and sharded producers start at the
            # sub-machine's own canonical chip, where estimate_xfer_cost
            # already co-locates. 8 -> 1 views on a single slice shrinks
            # the DP's boundary-view enumeration ~8x on unpartitioned
            # regions (the bulk of a 300-op conv PCG).
            lo = res.start_gpu_id % res.all_procs_per_node
            views = [
                MachineView(
                    start_device_id=node * res.all_procs_per_node + lo,
                    dim=(1,), stride=(1,),
                )
                for node in range(res.start_node_id,
                                  res.start_node_id + res.num_nodes)
            ]
            self._view_cache[key] = views
            return views
        views = [
            v
            for v in enumerate_machine_views(
                self.machine.num_nodes, self.machine.workers_per_node
            )
            if v.num_parts() == degree and res.is_valid_machine_view(v)
        ]
        # aligned-start canonicalization: a contiguous degree-d view whose
        # local start isn't a multiple of d straddles tile boundaries —
        # never cheaper than its aligned sibling on either the flat or
        # the torus model, and dropping the 31 unaligned starts per
        # degree is what keeps 32-worker searches tractable. Strided
        # (inter-node) views keep every start.
        #
        # Starts are additionally anchored to QUARTERS of the node. This
        # is an APPROXIMATION, not an equivalence: node_cost's producer->
        # consumer transfer terms depend on absolute device offsets, so
        # pruning a sub-quarter start (deg-2 at chips {4,5} of 32) can
        # exclude a placement strictly closer to an already-placed
        # producer. It is close in practice because the bandwidth term
        # dominates and is start-independent, and concurrent-tower
        # placements at finer offsets are what the nonsequence machine
        # splits enumerate (disjoint sub-resources, each re-anchored).
        # Without this, a degree-2 rewrite on a 32-worker machine gets 16
        # views per op and one Inception DP evaluation takes minutes
        # (profiled: dp4 97 s -> ~10 s; 8-worker view sets are unchanged
        # since there the quarter is <= every tile size).
        app = res.all_procs_per_node
        anchor = max(1, app // 4)
        aligned = [
            v for v in views
            if len(v.stride) != 1 or v.stride[0] != 1
            or (v.start_device_id % app)
            % max(1, min(max(v.dim[0], anchor), app)) == 0
        ]
        if aligned:
            views = aligned
        views = views[: self.max_views_per_op]
        self._view_cache[key] = views
        return views

    # -- cost of a single op under a view given producer views ----------
    def node_cost(
        self, op: PCGOp, view: MachineView, bounds: Dict[int, MachineView]
    ) -> float:
        # memoized on (op, view, producer views): the DP revisits the same
        # combination across thousands of split states
        key = (
            op.guid,
            view.hash(),
            tuple(
                (t.guid, b.hash()) if (b := bounds.get(t.guid)) is not None
                else t.guid
                for t in op.inputs
            ),
        )
        cached = self._node_cost_cache.get(key)
        if cached is not None:
            return cached
        cm = self.cost_model.measure_operator_cost(op, view)
        total = cm.total_time
        if op.is_parallel_op:
            # the collective happens across the INPUT's placement (a
            # combine/reduction's own view has degree-1 outputs, i.e. one
            # device); fall back to the op's view when no producer is known
            src = bounds.get(op.inputs[0].guid) if op.inputs else None
            total += self.cost_model.parallel_op_cost(op, src or view)
        flows = []
        for t in op.inputs:
            src = bounds.get(t.guid)
            total += self.cost_model.estimate_xfer_cost(t, src, view)
            flows.append((t, src, view))
        if len(flows) > 1:
            # an op's input transfers are simultaneous — shared links pay
            # congestion (topology model; zero on flat machines)
            total += self.cost_model.concurrent_xfer_penalty(flows)
        self._node_cost_cache[key] = total
        return total

    # -- DP ---------------------------------------------------------------
    def graph_cost(self, graph: Graph, res: MachineResource) -> GraphCostResult:
        ops = graph.topo_order()
        result = self._cost_of(tuple(ops), {}, {}, res, graph)
        pen = getattr(self.cost_model, "survivability_penalty", 0.0)
        if pen and result.cost != float("inf"):
            # slice-loss survivability bias (search/survivability.py):
            # applied on the COMPLETE assignment, outside the memoized
            # DP — whether a shard set crosses a slice boundary is a
            # whole-strategy property, not a subproblem one. Every
            # graph_cost consumer (best-first substitution search,
            # memory search, elastic research_views) inherits the bias.
            from .survivability import survivability_cost_factor

            f = survivability_cost_factor(graph, result.views,
                                          self.cost_model)
            if f != 1.0:
                result = GraphCostResult(result.cost * f, result.views)
        return result

    def _guids(self, ops) -> Tuple:
        ent = self._guid_tuples.get(id(ops))
        if ent is not None and ent[0] is ops:
            return ent[1]
        g = tuple(o.guid for o in ops)
        if len(self._guid_tuples) > 300_000:
            # entries pin their tuples (that's what keeps ids stable), so
            # cap the cache instead of letting a long best-first run grow
            # it unboundedly
            self._guid_tuples.clear()
        self._guid_tuples[id(ops)] = (ops, g)
        return g

    def _local_sids(self, ops):
        """STRUCTURAL ids for a subproblem, local to the ops tuple: each
        op's id folds (op_type, params, input ids, output/weight shape
        keys incl. parallel degrees), where inputs produced OUTSIDE the
        subproblem become positionally-indexed placeholders (first-
        consumption order) instead of upstream provenance. Two
        subproblems with isomorphic internals and equal boundary shapes
        therefore key IDENTICALLY even when they come from different
        candidate graphs (rewrite candidates mint fresh guids for every
        op — a guid-keyed memo restarts the DP from scratch per
        candidate; the reference shares across the whole best-first run
        for the same reason, graph.cc dp_state_hash).

        Returns (sid tuple, external-tensor-guid -> index,
        tensor-guid -> sid) — the latter two translate bounds/fixed into
        the structural key space."""
        ent = self._sid_tuples.get(id(ops))
        if ent is not None and ent[0] is ops:
            return ent[1]
        if len(self._struct_intern) > 1_000_000:
            # sids index into the intern table: clearing it invalidates
            # every cached sid and memo entry, so all three reset together
            self._struct_intern.clear()
            self._sid_tuples.clear()
            self._memo.clear()
            self._intern_gen += 1
        ext_ix: Dict[int, int] = {}
        t_sid: Dict[int, Tuple] = {}
        sids = []
        for o in ops:
            ins = []
            for t in o.inputs:
                s = t_sid.get(t.guid)
                if s is None:
                    k = ext_ix.get(t.guid)
                    if k is None:
                        k = len(ext_ix)
                        ext_ix[t.guid] = k
                    s = ("x", k, t.shape_key())
                ins.append(s)
            full = (
                o.op_type, o.params, tuple(ins),
                tuple(t.shape_key() for t in o.outputs),
                tuple(w.shape_key() for w in o.weights),
            )
            h = self._struct_intern.get(full)
            if h is None:
                h = len(self._struct_intern)
                self._struct_intern[full] = h
            sids.append(h)
            for i, t in enumerate(o.outputs):
                t_sid[t.guid] = (h, i)
        out = (tuple(sids), ext_ix, t_sid)
        if len(self._sid_tuples) > 300_000:
            self._sid_tuples.clear()
        self._sid_tuples[id(ops)] = (ops, out)
        return out

    def _memo_key(self, ops, bounds, fixed, res):
        sids, ext_ix, t_sid = self._local_sids(ops)
        pos = {o.guid: i for i, o in enumerate(ops)}
        return (
            self._intern_gen,
            sids,
            tuple(sorted(
                (ext_ix.get(g, t_sid.get(g)), v.hash())
                for g, v in bounds.items()
            )),
            tuple(sorted((pos[g], v.hash()) for g, v in fixed.items())),
            res.hash(),
        )

    def _cost_of(
        self,
        ops: Tuple[PCGOp, ...],
        bounds: Dict[int, MachineView],  # external tensor guid -> producer view
        fixed: Dict[int, MachineView],  # op guid -> forced view
        res: MachineResource,
        graph: Graph,
    ) -> GraphCostResult:
        # Canonicalize to what THIS sub-problem can observe: bounds entries
        # for tensors none of `ops` consume (and fixed entries for ops not
        # in `ops`) accumulate as sequence splits recurse, and a stale
        # upstream view in the key makes every upstream view combination a
        # distinct memo state — exponential in chain depth instead of
        # O(n · views²) (reference memoizes by subgraph hash alone,
        # graph.cc dp_state_hash, for the same reason).
        gk = self._guids(ops)
        sets = self._obs_cache.get(gk)
        if sets is None:
            sets = (
                {t.guid for o in ops for t in o.inputs},  # consumed tensors
                {o.guid for o in ops},                    # own op guids
            )
            if len(self._obs_cache) > 200_000:
                # same unbounded-growth concern as _guid_tuples: rewrite
                # candidates mint fresh guids, so entries never re-hit
                # across a long best-first run
                self._obs_cache.clear()
            self._obs_cache[gk] = sets
        consumed, own = sets
        if any(g not in consumed for g in bounds):
            bounds = {g: v for g, v in bounds.items() if g in consumed}
        if any(g not in own for g in fixed):
            fixed = {g: v for g, v in fixed.items() if g in own}
        key = self._memo_key(ops, bounds, fixed, res)
        hit = self._memo.get(key)
        if hit is not None:
            # The memo is STRUCTURAL — shared across candidate graphs (and
            # isomorphic towers of one graph) whose ops carry different
            # guids — so cached views are stored POSITIONALLY (index into
            # the ops tuple; positions are stable across structurally-
            # identical subproblems) and remapped to THIS caller's guids
            # here. Returning the first computer's guid-keyed dict was
            # round 3's regression: every cross-candidate hit produced a
            # views map whose keys matched no op in the querying graph,
            # silently dropping placements (and zeroing boundary
            # congestion, which reads r.views by the caller's guids).
            cost, pos_views = hit
            return GraphCostResult(
                cost, {ops[i].guid: v for i, v in pos_views}
            )
        result = self._compute(ops, bounds, fixed, res, graph)
        pos = {o.guid: i for i, o in enumerate(ops)}
        self._memo[key] = (
            result.cost,
            tuple((pos[g], v) for g, v in result.views.items() if g in pos),
        )
        return result

    def _compute(self, ops, bounds, fixed, res, graph) -> GraphCostResult:
        if not ops:
            return GraphCostResult(0.0, {})
        # Disconnected subgraph → nonsequence split FIRST (reference: a
        # dominator-based bottleneck cannot exist across components, and
        # only this path considers running towers concurrently on machine
        # halves). Must precede the pair fast-path and the bottleneck scan,
        # both of which would otherwise price the towers sequentially.
        if len(ops) > 1:
            comps = self._components(ops, graph)
            if len(comps) > 1:
                a, b = comps[0], [o for c in comps[1:] for o in c]
                with _rlog.enter("horizontal split: %d | %d ops",
                                 len(comps[0]), len(b)):
                    return self._nonsequence(
                        tuple(a), tuple(b), bounds, fixed, res, graph
                    )
        if len(ops) == 1:
            op = ops[0]
            views = [fixed[op.guid]] if op.guid in fixed else self.valid_views(op, res)
            best = GraphCostResult.infinity()
            for v in views:
                c = self.node_cost(op, v, bounds)
                if c < best.cost:
                    best = GraphCostResult(c, {op.guid: v})
            return best
        if len(ops) == 2:
            # exhaustive CONNECTED-pair enumeration (disconnected pairs took
            # the nonsequence path above) — the recursion's base case after
            # sequence splits, so chains stay exactly optimal (the greedy
            # fallback below would pick op0's view blind to op1)
            a, b = ops
            va = [fixed[a.guid]] if a.guid in fixed else self.valid_views(a, res)
            vb = [fixed[b.guid]] if b.guid in fixed else self.valid_views(b, res)
            best = GraphCostResult.infinity()
            for v0 in va:
                c0 = self.node_cost(a, v0, bounds)
                mid = dict(bounds)
                for t in a.outputs:
                    mid[t.guid] = v0
                for v1 in vb:
                    c = c0 + self.node_cost(b, v1, mid)
                    if c < best.cost:
                        best = GraphCostResult(c, {a.guid: v0, b.guid: v1})
            return best

        # 1. bottleneck sequence split (reference: find_split_node /
        #    sequence_optimize). An op at topo index i is a bottleneck if no
        #    edge jumps from [0, i) to (i, n).
        idx_of = {o.guid: i for i, o in enumerate(ops)}
        own_guids = set(idx_of)
        max_reach = [0] * len(ops)  # furthest dst index of edges from prefix
        for i, o in enumerate(ops):
            for t in o.inputs:
                # find producer among ops
                prod = graph.producers().get(t.guid)
                if prod and prod[0].guid in own_guids:
                    j = idx_of[prod[0].guid]
                    max_reach[j] = max(max_reach[j], i)
        # op i is a bottleneck iff no edge from ops[0..i-1] crosses past i:
        # edges FROM i itself into the suffix are fine (post sees the
        # bottleneck's fixed view via post_bounds), so they must not count.
        # i >= 1 keeps the split nontrivial — peeling a lone source op would
        # shadow the nonsequence (machine-splitting) option for graphs whose
        # parallel towers the reference runs concurrently on half machines.
        prefix_max = max_reach[0]  # furthest reach of edges from ops[0..i-1]
        bottleneck = -1
        # source peel: when removing the first op disconnects the rest,
        # peeling it (pre = [ops[0]], post = the towers) is an exact
        # sequence split — post sees the source's view via post_bounds —
        # and it UNLOCKS the nonsequence machine-split option for
        # shared-producer towers (reference: dominator-rooted splits,
        # graph.cc find_split_node; without this, a connected
        # source+towers blob falls to the diamond assigner, which never
        # considers concurrent halves)
        if len(ops) > 2 and len(self._components(ops[1:], graph)) > 1:
            bottleneck = 0
        if bottleneck < 0:
            for i in range(1, len(ops) - 1):
                if prefix_max <= i:
                    bottleneck = i
                    break  # first bottleneck — reference splits earliest
                prefix_max = max(prefix_max, max_reach[i])
        if bottleneck >= 0:
            bn = ops[bottleneck]
            pre, post = ops[: bottleneck + 1], ops[bottleneck + 1 :]
            # reference: recursive_logger TAG_ENTER around sequence_optimize
            with _rlog.enter("sequence split at %s: %d + %d ops",
                             bn.name, len(pre), len(post)):
                best = GraphCostResult.infinity()
                views = (
                    [fixed[bn.guid]] if bn.guid in fixed
                    else self.valid_views(bn, res)
                )
                for v in views:
                    pre_fixed = dict(fixed)
                    pre_fixed[bn.guid] = v
                    r1 = self._cost_of(pre, bounds, pre_fixed, res, graph)
                    if r1.cost == float("inf"):
                        continue
                    post_bounds = dict(bounds)
                    for t in bn.outputs:
                        post_bounds[t.guid] = v
                    r2 = self._cost_of(post, post_bounds, fixed, res, graph)
                    total = r1.cost + r2.cost
                    if total < best.cost:
                        views_map = dict(r1.views)
                        views_map.update(r2.views)
                        best = GraphCostResult(total, views_map)
                _rlog.info("best sequence cost %.4f", best.cost)
                if self.trajectory is not None:
                    self.trajectory.event(
                        "dp_split", split="sequence", bottleneck=bn.name,
                        pre=len(pre), post=len(post), cost=best.cost,
                    )
                return best

        # 2. sink-converging diamond (Inception modules: k independent
        #    towers meeting at a concat): decompose EXACTLY — per tower,
        #    DP the tower with its exit op's view fixed to each candidate
        #    u; the sink's per-input xfer terms are separable per tower
        #    given the sink view v, so
        #      cost = min_v [ sink_op(v) + Σ_j min_u (tower_j(u) +
        #                                            xfer(exit_j, u, v)) ].
        #    This replaces the branch-and-bound/beam fallback for the
        #    300-op conv PCGs where that blew up (minutes per candidate).
        r = self._sink_converge(ops, bounds, fixed, res, graph)
        if r is not None:
            return r

        # 3. fallback: connected, no bottleneck, not sink-converging.
        #    Bounded exact branch-and-bound over per-op views, beam search
        #    past the budget. (Round 1 picked views greedily in topo order
        #    here, which could silently return measurably suboptimal
        #    placements.)
        with _rlog.enter("diamond assign: %d ops", len(ops)):
            return self._diamond_assign(ops, bounds, fixed, res)

    def _sink_converge(self, ops, bounds, fixed, res, graph
                       ) -> Optional[GraphCostResult]:
        """Exact decomposition when the LAST op is the unique junction of
        otherwise-independent towers. Returns None when the pattern
        doesn't hold (multiple exit ops per tower feeding the sink, a
        parallel-op sink whose collective is priced on its input's
        placement, or fewer than 2 towers). Towers are costed
        sequentially on the full machine, matching the fallback's
        assumption (reference: find_optimal_nonsequence_graph_time's
        sequential branch)."""
        sink = ops[-1]
        if sink.is_parallel_op:
            return None
        comps = self._components(ops[:-1], graph)
        if len(comps) < 2:
            return None
        prod = graph.producers()
        comp_of = {o.guid: ci for ci, c in enumerate(comps) for o in c}
        # sink inputs grouped by producing tower; require one exit op each
        exit_of: Dict[int, int] = {}  # comp index -> exit op guid
        tower_feeds: Dict[int, List] = {}  # comp index -> sink input pts
        for t in sink.inputs:
            p = prod.get(t.guid)
            if not p or p[0].guid not in comp_of:
                continue  # external input: priced in the base term
            ci = comp_of[p[0].guid]
            if exit_of.setdefault(ci, p[0].guid) != p[0].guid:
                return None  # two exit ops in one tower: not separable
            tower_feeds.setdefault(ci, []).append(t)
        op_by_guid = {o.guid: o for o in ops}

        # per-tower DP under each candidate exit view (memoized _cost_of)
        tower_tables: List[Tuple[List, Dict]] = []  # (feeds, {view: result})
        free_cost = 0.0  # towers not feeding the sink: unconstrained
        free_views: Dict[int, MachineView] = {}
        for ci, comp in enumerate(comps):
            if ci not in exit_of:
                r = self._cost_of(tuple(comp), bounds, fixed, res, graph)
                if r.cost == float("inf"):
                    return GraphCostResult.infinity()
                free_cost += r.cost
                free_views.update(r.views)
                continue
            e_op = op_by_guid[exit_of[ci]]
            cands = ([fixed[e_op.guid]] if e_op.guid in fixed
                     else self.valid_views(e_op, res))
            table = {}
            for u in cands:
                f2 = dict(fixed)
                f2[e_op.guid] = u
                r = self._cost_of(tuple(comp), bounds, f2, res, graph)
                if r.cost != float("inf"):
                    table[u] = r
            if not table:
                return GraphCostResult.infinity()
            tower_tables.append((tower_feeds[ci], table))

        sink_views = ([fixed[sink.guid]] if sink.guid in fixed
                      else self.valid_views(sink, res))
        best = GraphCostResult.infinity()
        for v in sink_views:
            cm = self.cost_model.measure_operator_cost(sink, v)
            total = free_cost + cm.total_time
            choice = []
            flows = []  # the sink drains every tower at once
            for feeds, table in tower_tables:
                tb_best, tb_r, tb_u = float("inf"), None, None
                for u, r in table.items():
                    c = r.cost + sum(
                        self.cost_model.estimate_xfer_cost(t, u, v)
                        for t in feeds
                    )
                    if c < tb_best:
                        tb_best, tb_r, tb_u = c, r, u
                if tb_r is None:
                    total = float("inf")
                    break
                total += tb_best
                choice.append(tb_r)
                flows.extend((t, tb_u, v) for t in feeds)
            # external (non-tower) sink inputs
            for t in sink.inputs:
                p = prod.get(t.guid)
                if not p or p[0].guid not in comp_of:
                    src = bounds.get(t.guid)
                    total += self.cost_model.estimate_xfer_cost(t, src, v)
                    flows.append((t, src, v))
            if total != float("inf") and len(flows) > 1:
                # same congestion surcharge node_cost applies to
                # multi-input ops (post-hoc on the chosen exits: keeps the
                # per-tower selection separable)
                total += self.cost_model.concurrent_xfer_penalty(flows)
            if total < best.cost:
                views = dict(free_views)
                for r in choice:
                    views.update(r.views)
                views[sink.guid] = v
                best = GraphCostResult(total, views)
        return best

    # exact enumeration budget (total view combinations) and beam width for
    # the no-bottleneck fallback
    DIAMOND_EXACT_BUDGET = 8192
    DIAMOND_BEAM_WIDTH = 16

    def _diamond_assign(self, ops, bounds, fixed, res) -> GraphCostResult:
        view_lists: List[List[MachineView]] = []
        combos = 1
        for op in ops:
            vs = [fixed[op.guid]] if op.guid in fixed else self.valid_views(op, res)
            if not vs:
                return GraphCostResult.infinity()
            view_lists.append(vs)
            combos = min(combos * len(vs), self.DIAMOND_EXACT_BUDGET + 1)

        # beam pass: always run — it seeds branch-and-bound's incumbent
        # (beam width 1 degenerates to the old greedy, wider is strictly
        # more coverage)
        beam: List[Tuple[float, Dict[int, MachineView], Dict[int, MachineView]]]
        beam = [(0.0, dict(bounds), {})]
        for op, vs in zip(ops, view_lists):
            nxt = []
            for cost, cur_bounds, assign in beam:
                for v in vs:
                    c = cost + self.node_cost(op, v, cur_bounds)
                    if c == float("inf"):
                        continue
                    nb = dict(cur_bounds)
                    for t in op.outputs:
                        nb[t.guid] = v
                    na = dict(assign)
                    na[op.guid] = v
                    nxt.append((c, nb, na))
            if not nxt:
                return GraphCostResult.infinity()
            nxt.sort(key=lambda s: s[0])
            beam = nxt[: self.DIAMOND_BEAM_WIDTH]
        best_cost, _, best_assign = beam[0]
        best = GraphCostResult(best_cost, best_assign)
        if combos > self.DIAMOND_EXACT_BUDGET:
            return best

        # exact: DFS over view choices, pruning partial costs against the
        # beam incumbent — within the budget this is the true optimum
        n = len(ops)

        def dfs(i, cost, cur_bounds, assign):
            nonlocal best
            if cost >= best.cost:
                return
            if i == n:
                best = GraphCostResult(cost, dict(assign))
                return
            op = ops[i]
            scored = []
            for v in view_lists[i]:
                c = self.node_cost(op, v, cur_bounds)
                if cost + c < best.cost:
                    scored.append((c, v))
            scored.sort(key=lambda s: s[0])
            for c, v in scored:
                nb = dict(cur_bounds)
                for t in op.outputs:
                    nb[t.guid] = v
                assign[op.guid] = v
                dfs(i + 1, cost + c, nb, assign)
                del assign[op.guid]

        dfs(0, 0.0, dict(bounds), {})
        return best

    def _boundary_congestion(self, a, b, bounds, ra, rb, graph) -> float:
        """Concurrent halves prefetch their boundary tensors AT THE SAME
        TIME (under SPMD the inputs of a concurrently-placed region are
        copied in together): price the combined flow set's link sharing
        (reference: EnhancedMachineModel congestion; zero on flat
        machines). Each half's ops consuming a bound tensor contribute
        one flow from the producer's view to the consumer's assigned
        view. Sharing WITHIN one multi-input op was already charged by
        node_cost's per-op penalty (inside ra/rb.cost) — subtract it so
        the surcharge prices only the contention the halves add."""
        flows = []
        already = 0.0
        for part, r in ((a, ra), (b, rb)):
            for op in part:
                view = r.views.get(op.guid)
                if view is None:
                    continue
                op_flows = []
                for t in op.inputs:
                    src = bounds.get(t.guid)
                    if src is not None:
                        op_flows.append((t, src, view))
                flows.extend(op_flows)
                if len(op_flows) > 1:
                    # node_cost charged this op's input flow set (src-less
                    # inputs are filtered inside the penalty): that exact
                    # amount is already inside ra/rb.cost
                    already += self.cost_model.concurrent_xfer_penalty(
                        op_flows)
        if len(flows) < 2:
            return 0.0
        return max(
            0.0,
            self.cost_model.concurrent_xfer_penalty(flows) - already,
        )

    def _nonsequence(self, a, b, bounds, fixed, res, graph) -> GraphCostResult:
        """reference: find_optimal_nonsequence_graph_time (graph.cc ~230-290):
        try sequential on full machine vs concurrent on split halves.
        Concurrent options carry a boundary-congestion surcharge on
        topology-aware machines (_boundary_congestion)."""
        # sequential: both use the full machine, times add
        ra = self._cost_of(a, bounds, fixed, res, graph)
        rb = self._cost_of(b, bounds, fixed, res, graph)
        best_views = dict(ra.views)
        best_views.update(rb.views)
        best = GraphCostResult(ra.cost + rb.cost, best_views)
        chosen = "sequential"
        # vertical machine split: halves run concurrently, times max
        if res.available_procs_per_node >= 2:
            half = dataclasses.replace(
                res, available_procs_per_node=res.available_procs_per_node // 2
            )
            other = dataclasses.replace(
                half, start_gpu_id=res.start_gpu_id + half.available_procs_per_node
            )
            ra2 = self._cost_of(a, bounds, fixed, half, graph)
            rb2 = self._cost_of(b, bounds, fixed, other, graph)
            cost2 = max(ra2.cost, rb2.cost)
            if cost2 != float("inf"):
                cost2 += self._boundary_congestion(a, b, bounds, ra2, rb2,
                                                   graph)
            if cost2 < best.cost:
                views = dict(ra2.views)
                views.update(rb2.views)
                best = GraphCostResult(cost2, views)
                chosen = "concurrent_vertical"
        # horizontal (node) split for multi-node machines
        if res.num_nodes >= 2:
            top = dataclasses.replace(res, num_nodes=res.num_nodes // 2)
            bot = dataclasses.replace(
                top, start_node_id=res.start_node_id + top.num_nodes
            )
            ra3 = self._cost_of(a, bounds, fixed, top, graph)
            rb3 = self._cost_of(b, bounds, fixed, bot, graph)
            cost3 = max(ra3.cost, rb3.cost)
            if cost3 != float("inf"):
                cost3 += self._boundary_congestion(a, b, bounds, ra3, rb3,
                                                   graph)
            if cost3 < best.cost:
                views = dict(ra3.views)
                views.update(rb3.views)
                best = GraphCostResult(cost3, views)
                chosen = "concurrent_horizontal"
        if self.trajectory is not None:
            self.trajectory.event(
                "dp_split", split="nonsequence", a=len(a), b=len(b),
                chosen=chosen, cost=best.cost,
            )
        return best

    def _components(self, ops, graph) -> List[List[PCGOp]]:
        # connectivity depends only on the op set, not bounds/fixed/res —
        # the DP revisits the same subgraph under thousands of boundary
        # states, so memoize (554k calls / 78s on Inception otherwise)
        # key built directly (NOT via the _guids identity cache: callers
        # pass fresh slice tuples, which would always miss and pin dead
        # entries); _comp_cache dedups by value
        ck = tuple(o.guid for o in ops)
        cached = self._comp_cache.get(ck)
        if cached is not None:
            return cached
        guids = {o.guid for o in ops}
        parent = {o.guid: o.guid for o in ops}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(x, y):
            rx, ry = find(x), find(y)
            if rx != ry:
                parent[rx] = ry

        prod = graph.producers()
        for o in ops:
            for t in o.inputs:
                p = prod.get(t.guid)
                if p and p[0].guid in guids:
                    union(o.guid, p[0].guid)
        groups: Dict[int, List[PCGOp]] = {}
        for o in ops:
            groups.setdefault(find(o.guid), []).append(o)
        out = list(groups.values())
        self._comp_cache[ck] = out
        return out


def research_views(graph: Graph, cost_model: CostModel) -> GraphCostResult:
    """Re-run ONLY the DP machine-view assignment over an already-lowered
    PCG for `cost_model`'s machine — the elastic re-search entry
    (runtime/elastic.py): after a topology change, the graph's parallel
    STRUCTURE (degrees, parallel ops) may still be legal on the surviving
    machine even though every MachineView now addresses devices that are
    gone; this reassigns views for the live device set without paying for
    a full substitution search. Returns GraphCostResult.infinity() (cost
    = inf, no views) when no valid assignment exists — i.e. the structure
    itself no longer fits and a full re-compile must re-search it."""
    machine = cost_model.machine
    res = MachineResource(
        num_nodes=machine.num_nodes,
        all_procs_per_node=machine.workers_per_node,
        available_procs_per_node=machine.workers_per_node,
    )
    return SearchHelper(cost_model).graph_cost(graph, res)
