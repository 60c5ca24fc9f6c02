// Native task-graph simulator + MCMC strategy search.
//
// flexflow_tpu_torch's copy of the JAX package's native simulator
// (its native/src/simulator.cc, the same code): the reference's
// C++ simulator/MCMC hot loop (src/runtime/simulator.cc simulate_runtime +
// src/runtime/model.cc:3285 mcmc_optimize). The annealing search
// re-simulates the whole task graph per proposal, so it lives in C++. The
// Python side flattens the PCG into arrays (per-op fwd/bwd/sync times per
// candidate view, xfer-cost matrix entries) and this core runs
// list-scheduling + annealing without touching Python per iteration. It
// runs on the host: no device code.
//
// Cost semantics mirror flexflow_tpu_torch/search/mcmc.py simulate_runtime:
// forward pass in topo order, backward in reverse, per-view device
// timelines, xfer folded into task start, weight sync appended after bwd.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct Problem {
  int64_t num_ops;
  int64_t num_devices;
  // CSR edges: for op i, inputs are producer ops in[in_off[i]..in_off[i+1])
  std::vector<int64_t> in_off, in_src;
  std::vector<int64_t> in_bytes;  // tensor bytes per edge
  // candidate views per op (CSR): view list entries reference the global
  // view table (first_dev, num_parts, stride)
  std::vector<int64_t> view_off, view_ids;
  std::vector<int64_t> view_first, view_parts, view_stride;
  // per (op, candidate-slot) times
  std::vector<double> fwd, bwd, sync;
  double link_bw;       // flat ICI bandwidth for xfer estimate
  double link_latency;
};

double xfer_cost(const Problem& p, int64_t bytes, int64_t src_view,
                 int64_t dst_view) {
  if (src_view == dst_view || bytes <= 0) return 0.0;
  const int64_t dst_parts = p.view_parts[dst_view];
  const double per_dst = static_cast<double>(bytes) /
                         std::max<int64_t>(1, dst_parts);
  return p.link_latency + per_dst / p.link_bw;
}

// assignment[i] = candidate slot for op i (local index into its view list)
double simulate(const Problem& p, const std::vector<int64_t>& slot,
                std::vector<double>& dev_free, std::vector<double>& ready,
                std::vector<double>& bwd_end) {
  std::fill(dev_free.begin(), dev_free.end(), 0.0);
  std::fill(ready.begin(), ready.end(), 0.0);
  std::fill(bwd_end.begin(), bwd_end.end(), 0.0);

  auto gview = [&](int64_t op) {
    return p.view_ids[p.view_off[op] + slot[op]];
  };
  auto run_on = [&](int64_t view, double lb, double dur) {
    const int64_t first = p.view_first[view];
    const int64_t parts = p.view_parts[view];
    const int64_t stride = p.view_stride[view];
    double start = lb;
    for (int64_t k = 0; k < parts; k++)
      start = std::max(start, dev_free[first + k * stride]);
    const double end = start + dur;
    for (int64_t k = 0; k < parts; k++) dev_free[first + k * stride] = end;
    return end;
  };

  // forward (ops are topo-ordered by construction)
  for (int64_t i = 0; i < p.num_ops; i++) {
    const int64_t v = gview(i);
    double lb = 0.0;
    for (int64_t e = p.in_off[i]; e < p.in_off[i + 1]; e++) {
      const int64_t src = p.in_src[e];
      lb = std::max(lb, ready[src] + xfer_cost(p, p.in_bytes[e], gview(src), v));
    }
    const double end = run_on(v, lb, p.fwd[p.view_off[i] + slot[i]]);
    ready[i] = end;
  }
  double makespan = 0.0;
  for (int64_t i = 0; i < p.num_ops; i++) makespan = std::max(makespan, ready[i]);

  // consumers for backward ordering
  // backward: reverse topo; op's bwd waits for all its consumers' bwd
  for (int64_t i = p.num_ops - 1; i >= 0; i--) {
    const int64_t v = gview(i);
    double lb = 0.0;
    bool has_consumer = false;
    // consumers: ops j>i whose inputs include i
    for (int64_t j = i + 1; j < p.num_ops; j++) {
      for (int64_t e = p.in_off[j]; e < p.in_off[j + 1]; e++) {
        if (p.in_src[e] == i) {
          has_consumer = true;
          lb = std::max(lb, bwd_end[j]);
        }
      }
    }
    if (!has_consumer) lb = makespan;
    double end = run_on(v, lb, p.bwd[p.view_off[i] + slot[i]]);
    const double sync = p.sync[p.view_off[i] + slot[i]];
    if (sync > 0.0) end = run_on(v, end, sync);
    bwd_end[i] = end;
  }
  double total = 0.0;
  for (double t : dev_free) total = std::max(total, t);
  return total;
}

struct Workspace {
  Problem p;
  std::vector<double> dev_free, ready, bwd_end;
};

}  // namespace

extern "C" {

// Build a problem. Arrays are copied.
void* ffsim_create(int64_t num_ops, int64_t num_devices,
                   const int64_t* in_off, const int64_t* in_src,
                   const int64_t* in_bytes, int64_t num_edges,
                   const int64_t* view_off, const int64_t* view_ids,
                   int64_t num_view_entries,
                   const int64_t* view_first, const int64_t* view_parts,
                   const int64_t* view_stride, int64_t num_views,
                   const double* fwd, const double* bwd, const double* sync,
                   double link_bw, double link_latency) {
  auto* w = new Workspace();
  Problem& p = w->p;
  p.num_ops = num_ops;
  p.num_devices = num_devices;
  p.in_off.assign(in_off, in_off + num_ops + 1);
  p.in_src.assign(in_src, in_src + num_edges);
  p.in_bytes.assign(in_bytes, in_bytes + num_edges);
  p.view_off.assign(view_off, view_off + num_ops + 1);
  p.view_ids.assign(view_ids, view_ids + num_view_entries);
  p.view_first.assign(view_first, view_first + num_views);
  p.view_parts.assign(view_parts, view_parts + num_views);
  p.view_stride.assign(view_stride, view_stride + num_views);
  p.fwd.assign(fwd, fwd + num_view_entries);
  p.bwd.assign(bwd, bwd + num_view_entries);
  p.sync.assign(sync, sync + num_view_entries);
  p.link_bw = link_bw;
  p.link_latency = link_latency;
  w->dev_free.resize(num_devices);
  w->ready.resize(num_ops);
  w->bwd_end.resize(num_ops);
  return w;
}

double ffsim_simulate(void* handle, const int64_t* slots) {
  auto* w = static_cast<Workspace*>(handle);
  std::vector<int64_t> s(slots, slots + w->p.num_ops);
  return simulate(w->p, s, w->dev_free, w->ready, w->bwd_end);
}

// MCMC annealing (reference: model.cc:3285). In/out: slots. Returns best cost.
double ffsim_mcmc(void* handle, int64_t* slots, int64_t budget, double alpha,
                  uint64_t seed) {
  auto* w = static_cast<Workspace*>(handle);
  const Problem& p = w->p;
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);

  std::vector<int64_t> cur(slots, slots + p.num_ops);
  double cur_cost = simulate(p, cur, w->dev_free, w->ready, w->bwd_end);
  std::vector<int64_t> best = cur;
  double best_cost = cur_cost;

  for (int64_t it = 0; it < budget; it++) {
    const int64_t op = static_cast<int64_t>(unif(rng) * p.num_ops) % p.num_ops;
    const int64_t n_cands = p.view_off[op + 1] - p.view_off[op];
    if (n_cands <= 1) continue;
    const int64_t prev = cur[op];
    cur[op] = static_cast<int64_t>(unif(rng) * n_cands) % n_cands;
    const double c = simulate(p, cur, w->dev_free, w->ready, w->bwd_end);
    const double delta = c - cur_cost;
    if (delta < 0 || unif(rng) < std::exp(-alpha * delta * 1e6)) {
      cur_cost = c;
      if (c < best_cost) {
        best_cost = c;
        best = cur;
      }
    } else {
      cur[op] = prev;  // reject
    }
  }
  std::memcpy(slots, best.data(), sizeof(int64_t) * p.num_ops);
  return best_cost;
}

void ffsim_destroy(void* handle) { delete static_cast<Workspace*>(handle); }

}  // extern "C"
