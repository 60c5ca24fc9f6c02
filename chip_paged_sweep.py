#!/usr/bin/env python3
"""Design sweep of the cluster paged-decode kernel on one NVIDIA GPU.

    python3 chip_paged_sweep.py

Builds variants of csrc/paged_decode.cu's cluster kernel (its constants
kSplitWarps and kUnroll substituted in copies of the source, one nvcc
each, all at once, into build/paged_sweep/), holds each against the
plain version, and times each at chip_smoke.py's serving and long shapes
(strided cache view, bf16) at `paged_ranks`' choice (8 blocks a cluster
at both shapes), the source as it is also at 4: device time from a
torch.profiler trace with the L2 flushed before every call, and with the
L2 warm. The runs go in turns, then in the reverse order, so that drift
of the card falls on all alike.

The shapes run twice: on the serving path's pool, the strided view of the
dense caches (a position's 16 heads x 128 bytes contiguous, one head's
rows 2 KB apart), and on a contiguous head-major pool of the same values
(a page's 16 rows of a head contiguous); and the variant "occupancy"
(the source plus an entry point that asks cudaOccupancyMaxActiveClusters)
reports how many clusters of 4 and 8 blocks (bf16, d = 64) can be
resident at once.

One more variant, "traced", stamps %globaltimer (ns) in thread 0 of every
block at the kernel's phase boundaries (entry; the length known; the
table run staged; K/V read and folded; the block's merge; the cluster
wait; the partial pushed to rank 0; rank 0's store, after its wait for
the others) and reads the stamps back after one call at each shape, cold
and warm: when blocks start, and how long each phase takes, median and
maximum over the busy blocks.

Prints one JSON line per variant, a summary line, the trace line and the
card's name and power limit. Needs one CUDA device and nvcc; imports
nothing of JAX.
"""
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# name -> the cluster kernel's constants; "shipped" is the source as it is
VARIANTS = {
    "shipped": {},
    "unroll2": {"kUnroll": "2"},
    "unroll8": {"kUnroll": "8"},
    "warps2": {"kSplitWarps": "2"},
    "traced": {},
    "occupancy": {},
}
# (variant, blocks a cluster; None: paged_ranks' choice)
RUNS = [("shipped", None), ("shipped", 4), ("unroll2", None),
        ("unroll8", None), ("warps2", None), ("traced", None)]
TRACE_POINTS = 8
TRACE_SLOTS = 1 << 16

# (anchor, text put after it): the traced variant's stamps; FF_STAMP's
# second argument is a value the stamp must wait for
_TRACE_EDITS = (
    ('#include "common.cuh"\n',
     f"__device__ unsigned long long ff_trace[{TRACE_SLOTS}];\n"
     "#define FF_STAMP(i, dep) { unsigned long long t_; asm volatile("
     "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_) : \"f\"((float)(dep)) "
     ": \"memory\"); ff_t[i] = t_; }\n"),
    ("  extern __shared__ int run_pages[];  // this rank's physical page ids\n",
     f"  unsigned long long ff_t[{TRACE_POINTS}] = {{0}};\n  FF_STAMP(0, 0)\n"),
    ("  const int pg1 = min(live, pg0 + per);\n",
     "  FF_STAMP(1, pg1 + busy)\n  ff_t[2] = ff_t[3] = ff_t[4] = ff_t[1];\n"),
    ("      run_pages[i] = trow[i];\n    __syncthreads();\n",
     "    FF_STAMP(2, run_pages[0])\n"),
    ("      m = m_new;\n    }\n", "    FF_STAMP(3, m + l + acc[0])\n"),
    ("        merge_state(m, l, acc, warp_m[w], warp_l[w], &warp_acc[w][sub * 8]);"
     "\n    }\n", "    FF_STAMP(4, m)\n"),
    ("  // 0, so finished and empty ranks free their SMs at once.\n"
     "  cluster_wait();\n", "  FF_STAMP(5, 0)\n"),
    ("  merge_bar_arrive(cluster_addr(&merge_bar, 0));\n",
     "  FF_STAMP(6, 0)\n  const long long ff_at = ((static_cast<long long>(b) * "
     f"heads + h) * ranks + rank) * {TRACE_POINTS};\n"
     f"  if (threadIdx.x == 0 && rank != 0 && ff_at < {TRACE_SLOTS})\n"
     f"    for (int i = 0; i < {TRACE_POINTS}; ++i) ff_trace[ff_at + i] = "
     "ff_t[i];\n"),
    ("        pack8<T>(o);\n  }\n",
     "  FF_STAMP(7, acc[0])\n"
     f"  if (threadIdx.x == 0 && ff_at < {TRACE_SLOTS})\n"
     f"    for (int i = 0; i < {TRACE_POINTS}; ++i) ff_trace[ff_at + i] = "
     "ff_t[i];\n"),
)
_OCCUPANCY = (
    "\nextern \"C\" int ff_max_clusters(int ranks) {\n"
    "  auto kernel = paged_decode_cluster_kernel<__nv_bfloat16, 8>;\n"
    "  cudaLaunchConfig_t cfg = {};\n"
    "  cfg.gridDim = dim3(ranks, 16, 8);\n"
    "  cfg.blockDim = dim3(kSplitWarps * 32);\n"
    "  cfg.dynamicSmemBytes = 16;\n"
    "  cudaLaunchAttribute a;\n"
    "  a.id = cudaLaunchAttributeClusterDimension;\n"
    "  a.val.clusterDim.x = ranks;\n"
    "  a.val.clusterDim.y = 1;\n"
    "  a.val.clusterDim.z = 1;\n"
    "  cfg.attrs = &a;\n"
    "  cfg.numAttrs = 1;\n"
    "  int n = 0;\n"
    "  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);\n"
    "  return e == cudaSuccess ? n : -static_cast<int>(e);\n"
    "}\n")
_TRACE_READER = (
    "\nextern \"C\" int ff_trace_read(void* dst, long long bytes) {\n"
    "  return static_cast<int>(cudaMemcpyFromSymbol(dst, ff_trace, bytes));\n"
    "}\n")


def variant_source(text: str, name: str) -> str:
    for const, value in VARIANTS[name].items():
        text, n = re.subn(rf"(constexpr \w+ {const} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"constant {const} not found once")
    if name == "traced":
        for anchor, add in _TRACE_EDITS:
            if text.count(anchor) != 1:
                raise ValueError(f"trace anchor not found once: {anchor!r}")
            text = text.replace(anchor, anchor + add)
        text += _TRACE_READER
    if name == "occupancy":
        text += _OCCUPANCY
    return text


def build_variants(build):
    """Compile every variant; returns name -> loaded library."""
    out_dir = os.path.join(REPO, "build", "paged_sweep")
    procs = {}
    src = (build.CSRC_DIR / "paged_decode.cu").read_text()
    for name in VARIANTS:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for h in build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(h, d)
        with open(os.path.join(d, "paged_decode.cu"), "w") as f:
            f.write(variant_source(src, name))
        lib = os.path.join(d, "libpaged_decode.so")
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(d, "paged_decode.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs, regs = {}, {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        regs[name] = sorted({int(r) for r in re.findall(
            r"Used (\d+) registers", text)})
        libs[name] = ctypes.CDLL(lib)
        fn = libs[name].ff_paged_decode
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    tr = libs["traced"].ff_trace_read
    tr.argtypes, tr.restype = [ctypes.c_void_p, ctypes.c_longlong], ctypes.c_int
    oc = libs["occupancy"].ff_max_clusters
    oc.argtypes, oc.restype = [ctypes.c_int], ctypes.c_int
    return libs, regs


def trace_summary(torch, stamps, lengths, heads, ranks, page):
    """Phase times of one traced call: stamps (slots, heads, ranks, 8) ns."""
    t = stamps.double()
    t0 = t[..., 0].min()
    busy = torch.zeros(t.shape[:3], dtype=torch.bool)
    for b, n in enumerate(lengths):
        live = -(-n // page)
        per = -(-live // ranks)
        nb = -(-live // per) if per else 0
        busy[b, :, :nb] = True
    names = ("length", "table", "kv_and_math", "block_merge",
             "cluster_wait", "push_and_arrive", "rank0_wait_merge_store")
    out = {"blocks": int(t[..., 0].numel()), "busy_blocks": int(busy.sum()),
           "start_ns": {q: float((t[..., 0] - t0).flatten().quantile(q))
                        for q in (0.0, 0.5, 0.9, 1.0)},
           "end_ns_max": float(t[..., 6].max() - t0),
           "rank0_end_ns_max": float(t[:, :, 0, 7].max() - t0)}
    for i, n in enumerate(names):
        sel = busy if i < 6 else busy[:, :, 0]
        d = (t[..., i + 1] - t[..., i]) if i < 6 else \
            (t[:, :, 0, 7] - t[:, :, 0, 6])
        d = d[sel]
        out[n] = {"median_ns": float(d.median()), "max_ns": float(d.max())}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_paged_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flexflow_tpu_torch.kernels import build
    from flexflow_tpu_torch.kernels import decode as kd

    libs, regs = build_variants(build)
    g = torch.Generator(device="cuda").manual_seed(1)
    h, d, page = cs.HEADS, cs.HIDDEN // cs.HEADS, 16
    shapes = {}
    for name, max_len, lens in (("serving", cs.MAX_LEN, cs.SERVING_LENGTHS),
                                ("long", cs.LONG_MAX_LEN, cs.LONG_LENGTHS)):
        q = torch.randn(cs.SLOTS, h, d, generator=g, device="cuda") \
            .to(torch.bfloat16)
        kc, vc = (torch.randn(cs.SLOTS, max_len, h, d, generator=g,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        kp, vp, table = kd.paged_view_of_cache(kc, vc, page)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        plain = kd.paged_decode_plain(q, kp, vp, table, lengths)
        b_ms = cs.paged_bound(lens, h, d, d, page)[0]
        ranks = kd.paged_ranks(table.shape[1], page)
        shapes[name] = (q, kp, vp, table, lengths, plain, b_ms, ranks)
        # the same values in a contiguous head-major pool, the same table
        kcp, vcp = (x.view(cs.SLOTS, -1, page, h, d).permute(3, 0, 1, 2, 4)
                    .contiguous().view(h, -1, page, d) for x in (kc, vc))
        shapes[f"{name}_pool"] = (q, kcp, vcp, table, lengths, plain, b_ms,
                                  ranks)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def caller(lib, q, kp, vp, table, lengths, out, ranks):
        args = (0, 2, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                q.shape[0], h, d, d, page, table.shape[1], *kp.stride()[:3],
                *vp.stride()[:3], 1.0 / math.sqrt(d), 1, ranks,
                torch.cuda.current_stream().cuda_stream)

        def run():
            if lib.ff_paged_decode(*args):
                raise RuntimeError("launch refused")
        return run

    def key(name, ranks):
        return name if ranks is None else f"{name}@{ranks}"

    results = {key(n, r): {"registers": regs[n], "consts": VARIANTS[n],
                           "ranks": r} for n, r in RUNS}
    results["max_active_clusters"] = {
        r: libs["occupancy"].ff_max_clusters(r) for r in (4, 8)}
    for name, ranks in RUNS + RUNS[::-1]:
        for shape, (q, kp, vp, table, lengths, plain, b_ms, auto) in \
                shapes.items():
            out = torch.empty_like(plain)
            run = caller(libs[name], q, kp, vp, table, lengths, out,
                         auto if ranks is None else ranks)
            run()
            torch.cuda.synchronize()
            cs.check_close(f"{name} {shape}", "paged_decode", out, plain)
            cold = cs.time_ms(run, 50, flush_buf.zero_)
            warm = cs.time_ms(run, 50)
            r = results[key(name, ranks)].setdefault(
                shape, {"bound_ms": b_ms, "ranks": auto if ranks is None
                        else ranks, "cold_ms": [], "warm_ms": []})
            r["cold_ms"].append(cold)
            r["warm_ms"].append(warm)
    traces = {}
    for shape, (q, kp, vp, table, lengths, plain, _, ranks) in shapes.items():
        if shape.endswith("_pool"):
            continue
        out = torch.empty_like(plain)
        run = caller(libs["traced"], q, kp, vp, table, lengths, out, ranks)
        lens = lengths.tolist()
        n = q.shape[0] * h * ranks * TRACE_POINTS
        for temp in ("cold", "warm"):
            for _ in range(3):
                run()
            flush_buf.zero_()
            if temp == "warm":
                run()
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
            buf = torch.zeros(n, dtype=torch.int64)
            if libs["traced"].ff_trace_read(buf.data_ptr(), 8 * n):
                raise RuntimeError("trace read failed")
            traces[f"{shape}_{temp}"] = trace_summary(
                torch, buf.view(q.shape[0], h, ranks, TRACE_POINTS), lens, h,
                ranks, page)
    for name, r in results.items():
        print(json.dumps({name: r}), flush=True)
    summary = {n: {s: {"cold_ms_mean": sum(r[s]["cold_ms"]) / 2,
                       "warm_ms_mean": sum(r[s]["warm_ms"]) / 2,
                       "peak_share_cold": r[s]["bound_ms"]
                       / (sum(r[s]["cold_ms"]) / 2)}
                   for s in shapes} for n, r in results.items()
               if n != "max_active_clusters"}
    print(json.dumps({"summary": summary}), flush=True)
    print(json.dumps({"trace": traces}), flush=True)
    print(cs.gpu_name_and_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
