// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel flexflow_tpu/kernels/decode.py:50
// `_paged_decode_kernel` (driven by `paged_flash_decode`): one query token
// per slot attends over a paged K/V pool with an online softmax; pages at
// or past the slot's length are never touched, so table entries past the
// live pages are never read.
//
// Layouts (element strides; the last axis of every operand is contiguous):
//   q      (slots, heads, d)                      contiguous
//   k / v  (heads, num_pages, page_size, d|dv)    strides (sh, sp, st, 1) —
//          the serving path passes a strided VIEW of the dense per-slot
//          caches (paged_view_of_cache), so no pool copy is ever made
//   table  (slots, pages_per_slot) int32; lengths (slots,) int32
//   out    (slots, heads, dv) in q's dtype; all arithmetic in f32.
// The length is clamped to pages_per_slot * page_size (the TPU grid visits
// that many pages at most) and l to 1e-30, so a length-0 slot gives 0.
//
// Bound on the H100: memory. The work is ~4 flops per K/V element read,
// far below the card's ~295 flop/byte ridge, so the least time is the live
// K/V bytes over 3.35 TB/s (serving: 8 slots, 2209 live positions x 16
// heads x 64 x 2 tensors x 2 B = 9.05 MB per layer, 2.7 us).
//
// Two kernels; kernels/decode.py `paged_path` picks one by shape and the
// entry point refuses a shape its path does not take:
//
// "cluster" (bf16/fp16, head dims multiples of 8 up to 256, 16-byte
// aligned rows). Reaching the bound means keeping ~18 KB in flight per SM
// (3.35 TB/s times the ~0.7 us load latency) across every SM, while one
// (head, slot) row holds only 1-512 positions at the serving shape. So:
//   - The grid is (R, heads, slots) in clusters of R blocks (Hopper's
//     thread block clusters; R = 1..8 a launch, kernels/decode.py
//     `paged_ranks`: 8 from the serving shape up): the R blocks of a
//     (head, slot) row split the slot's LIVE pages into R contiguous runs
//     of ceil(pages / R) pages. A short slot leaves most
//     ranks empty; the serving shape runs 1024 blocks where one block a
//     row gave 128 on 132 SMs.
//   - A block stages its run's table entries in shared memory (each entry
//     read once), then loads 16 bytes a lane: a 64-wide 16-bit row is 8
//     lanes, so a warp reads 4 rows an instruction, and every lane issues
//     its kUnroll rows of K AND of V before any math on them (2 x 4 x 16
//     bytes in flight a lane, 16 KB a block). q . k reduces over the row's
//     lanes in log2(lanes) shuffles.
//   - Each row group (the lanes of one row) keeps its own online-softmax
//     state (m, l, acc) in registers; groups merge by shuffles, warps
//     through shared memory, in a fixed order.
//   - Each busy block writes its partial (m, l, acc[dv]) into rank 0's
//     shared memory (distributed shared memory, slot = its rank) and
//     arrives on rank 0's mbarrier, then exits: only rank 0 waits, so
//     finished and empty blocks free their SM at once (a second cluster
//     barrier would hold them to the end, and the blocks that do not fit
//     at launch wait for them). Rank 0 merges slots 0..busy-1 in rank
//     order and writes the row. One launch, no workspace, no
//     atomics: runs are bit-equal. No tensor cores: one query per (slot,
//     head) is a matrix-vector product.
//
// "block" (the earlier kernel; every dtype and head dim up to 256): one
// block of 8 warps per (head, slot); warp w takes positions w*4 .. w*4+3,
// then strides by 32, with per-warp online-softmax state merged through
// shared memory at the end. Lanes split the head dim (8 values per lane).
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// "block": one block of 8 warps per (head, slot)
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kTok = 4;          // positions in flight per warp
constexpr int kLaneVals = 8;     // head dims per lane: d, dv <= 256

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ table,
                          const int* __restrict__ lengths, T* __restrict__ out,
                          int heads, int d, int dv, int page_size,
                          int pages_per_slot, long long k_sh, long long k_sp,
                          long long k_st, long long v_sh, long long v_sp,
                          long long v_st, float scale) {
  extern __shared__ float smem[];  // m[kWarps], l[kWarps], acc[kWarps][dv]
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the TPU grid visits pages_per_slot pages at most: positions past the
  // table are never read there either
  int len = lengths[b];
  len = min(len, pages_per_slot * page_size);

  const T* qrow = q + ((long long)b * heads + h) * d;
  float qr[kLaneVals];
#pragma unroll
  for (int i = 0; i < kLaneVals; ++i) {
    const int c = lane + 32 * i;
    qr[i] = c < d ? ff::to_f32(qrow[c]) : 0.f;
  }
  float m = ff::kNegInf;
  float l = 0.f;
  float acc[kLaneVals];
#pragma unroll
  for (int i = 0; i < kLaneVals; ++i) acc[i] = 0.f;

  const int* trow = table + (long long)b * pages_per_slot;
  const T* kh = k + h * k_sh;
  const T* vh = v + h * v_sh;

  for (int base = warp * kTok; base < len; base += kWarps * kTok) {
    float s[kTok];
    const T* vr[kTok];
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      const int pos = base + u;
      s[u] = 0.f;
      vr[u] = vh;
      if (pos < len) {
        const int page = pos / page_size;
        const long long phys = trow[page];
        const long long tok = pos - page * page_size;
        const T* kr = kh + phys * k_sp + tok * k_st;
        vr[u] = vh + phys * v_sp + tok * v_st;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kLaneVals; ++i) {
          const int c = lane + 32 * i;
          if (c < d) part += qr[i] * ff::to_f32(kr[c]);
        }
        s[u] = part;
      }
    }
#pragma unroll
    for (int u = 0; u < kTok; ++u) s[u] = ff::warp_sum(s[u]);
    float cmax = ff::kNegInf;
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      if (base + u < len) {
        s[u] *= scale;
        cmax = fmaxf(cmax, s[u]);
      }
    }
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kLaneVals; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      if (base + u < len) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < kLaneVals; ++i) {
          const int c = lane + 32 * i;
          if (c < dv) acc[i] += p * ff::to_f32(vr[u][c]);
        }
      }
    }
    m = m_new;
  }

  // merge the warps' partial states: a warp that saw no position holds
  // (m=-1e30, l=0, acc=0) and contributes nothing
  float* wm = smem;
  float* wl = smem + kWarps;
  float* wacc = smem + 2 * kWarps;
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kLaneVals; ++i) {
    const int c = lane + 32 * i;
    if (c < dv) wacc[warp * dv + c] = acc[i];
  }
  __syncthreads();
  float big_m = ff::kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big_m = fmaxf(big_m, wm[w]);
  float big_l = 0.f;
  float wscale[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wscale[w] = expf(wm[w] - big_m);
    big_l += wl[w] * wscale[w];
  }
  const float denom = fmaxf(big_l, 1e-30f);
  T* orow = out + ((long long)b * heads + h) * dv;
  for (int c = threadIdx.x; c < dv; c += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += wacc[w * dv + c] * wscale[w];
    orow[c] = ff::from_f32<T>(a / denom);
  }
}

// ---------------------------------------------------------------------------
// "cluster": a (head, slot) row split over the blocks of a cluster
// ---------------------------------------------------------------------------

constexpr int kMaxRanks = 8;     // blocks a cluster: 1..8 (the portable maximum)
constexpr int kSplitWarps = 4;   // warps a block
constexpr int kUnroll = 4;       // rows of K and of V a lane, a tile
// table entries a block may stage, ceil(pages_per_slot / ranks) <= this:
// 16 KB, so the block's shared memory stays under 48 KB
constexpr int kMaxRunPages = 4096;

// thread block cluster primitives (PTX, sm_90)
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// this thread has arrived; no ordering of its memory operations (the
// merge barrier's initialisation is published by its own fence)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the merge barrier: an mbarrier in rank 0's shared memory that every
// rank's pushing lanes arrive on, remotely, after their partial. The
// fence makes the initialisation visible to the cluster once the cluster
// barrier's wait completes.
__device__ __forceinline__ void merge_bar_init(uint64_t* bar, uint32_t count) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], %1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
      "r"(count)
      : "memory");
}

// one arrival at the mbarrier at shared::cluster address `addr`; this
// lane's earlier writes there are visible to whoever completes the wait
__device__ __forceinline__ void merge_bar_arrive(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// returns once phase 0 of this block's mbarrier has completed
__device__ __forceinline__ void merge_bar_wait(uint64_t* bar) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(0u)
        : "memory");
  }
}

// the shared::cluster address of `p` (this block's shared memory) in the
// block of cluster rank `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(a), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(x)
               : "memory");
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, float a, float b,
                                            float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// 16 bytes: eight 16-bit values
__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the 16-bit value in the low half of `w` as f32 (exact)
template <typename T>
__device__ __forceinline__ float lo16(uint32_t w);
template <>
__device__ __forceinline__ float lo16<__nv_bfloat16>(uint32_t w) {
  return __uint_as_float(w << 16);
}
template <>
__device__ __forceinline__ float lo16<__half>(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
}

// f32 rounded to nearest into 16 bits
__device__ __forceinline__ uint32_t bits16(float x, __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t bits16(float x, __half*) {
  return __half_as_ushort(__float2half_rn(x));
}

template <typename T>
__device__ __forceinline__ void unpack8(const uint4& c, float* f) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = lo16<T>(w[i]);
    f[2 * i + 1] = lo16<T>(w[i] >> 16);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = bits16(f[2 * i], static_cast<T*>(nullptr)) |
           (bits16(f[2 * i + 1], static_cast<T*>(nullptr)) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// (m, l, acc) <- the merge of two online-softmax states
__device__ __forceinline__ void merge_state(float& m, float& l, float* acc,
                                            float m2, float l2,
                                            const float* acc2) {
  const float mm = fmaxf(m, m2);
  const float s1 = __expf(m - mm);
  const float s2 = __expf(m2 - mm);
  l = l * s1 + l2 * s2;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = acc[i] * s1 + acc2[i] * s2;
  m = mm;
}

// LPR lanes a row (16 bytes each): the smallest power of two >= 4 with
// 8 * LPR >= max(d, dv). Lane `sub` of a row holds K columns and V columns
// 8 sub .. 8 sub + 7 (if below d, dv).
template <typename T, int LPR>
__global__ void __launch_bounds__(kSplitWarps * 32)
paged_decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ table,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int heads, int d, int dv,
                            int page_size, int pages_per_slot, long long k_sh,
                            long long k_sp, long long k_st, long long v_sh,
                            long long v_sp, long long v_st, float scale) {
  constexpr int kGroups = kSplitWarps * 32 / LPR;  // rows a load step
  constexpr int kTileRows = kGroups * kUnroll;     // positions an iteration
  constexpr int kW = 8 * LPR;                      // partial width >= dv
  // partials of the cluster's busy ranks, written by each rank into rank
  // 0's copy (slot = rank), and rank 0's merge barrier; the warps'
  // partials of this block
  __shared__ float part_m[kMaxRanks], part_l[kMaxRanks];
  __shared__ __align__(16) float part_acc[kMaxRanks][kW];
  __shared__ __align__(8) uint64_t merge_bar;
  __shared__ float warp_m[kSplitWarps], warp_l[kSplitWarps];
  __shared__ __align__(16) float warp_acc[kSplitWarps][kW];
  extern __shared__ int run_pages[];  // this rank's physical page ids

  const int rank = static_cast<int>(cluster_rank());
  const int ranks = static_cast<int>(cluster_size());
  // rank 0's merge barrier expects one arrival from each pushing lane of
  // every rank; the cluster barrier below makes it (and rank 0's shared
  // memory) exist for the others before any of them touches it. The
  // arrive is relaxed: a release arrive here delays every block's first
  // load, and the init has its own fence.
  if (rank == 0 && threadIdx.x == 0) merge_bar_init(&merge_bar, ranks * LPR);
  cluster_arrive_relaxed();

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR;
  const int group = threadIdx.x / LPR;
  const bool k_on = sub * 8 < d;
  const bool v_on = sub * 8 < dv;

  float qf[8];
  {
    const uint4 c = k_on ? ld16(q + ((long long)b * heads + h) * d + sub * 8)
                         : make_uint4(0, 0, 0, 0);
    unpack8<T>(c, qf);
  }
  const int len = max(0, min(lengths[b], pages_per_slot * page_size));
  const int live = (len + page_size - 1) / page_size;   // live pages
  const int per = (live + ranks - 1) / ranks;           // pages a rank
  const int busy = per ? (live + per - 1) / per : 0;    // ranks with pages
  const int pg0 = min(live, rank * per);
  const int pg1 = min(live, pg0 + per);

  float m = ff::kNegInf;
  float l = 0.f;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  if (rank < busy) {
    const int* trow = table + (long long)b * pages_per_slot + pg0;
    for (int i = threadIdx.x; i < pg1 - pg0; i += blockDim.x)
      run_pages[i] = trow[i];
    __syncthreads();

    const T* kh = k + h * k_sh + sub * 8;
    const T* vh = v + h * v_sh + sub * 8;
    const int p_end = min(len, pg1 * page_size);
    for (int base = pg0 * page_size; base < p_end; base += kTileRows) {
      // this lane's kUnroll rows of K and of V, all issued before any math
      uint4 kc[kUnroll], vc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + u * kGroups + group;
        kc[u] = make_uint4(0, 0, 0, 0);
        vc[u] = make_uint4(0, 0, 0, 0);
        if (pos < p_end) {
          const int page = pos / page_size;
          const long long phys = run_pages[page - pg0];
          const long long tok = pos - page * page_size;
          if (k_on) kc[u] = ld16(kh + phys * k_sp + tok * k_st);
          if (v_on) vc[u] = ld16(vh + phys * v_sp + tok * v_st);
        }
      }
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[8];
        unpack8<T>(kc[u], kf);
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) part += qf[i] * kf[i];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u] = part * scale;
      }
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + u * kGroups + group < p_end) m_new = fmaxf(m_new, s[u]);
      const float alpha = __expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * kGroups + group < p_end) {
          const float p = __expf(s[u] - m_new);
          float vf[8];
          unpack8<T>(vc[u], vf);
          l += p;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += p * vf[i];
        }
      }
      m = m_new;
    }

    // the warp's row groups, by shuffles (group g meets g ^ 1, g ^ 2, ...)
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      float acc2[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc2[i] = __shfl_xor_sync(0xffffffffu, acc[i], off);
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
      merge_state(m, l, acc, m2, l2, acc2);
    }
    // the block's warps, in order, through shared memory (lanes of row
    // group 0 hold each warp's state)
    if (lane < LPR) {
      if (lane == 0) {
        warp_m[warp] = m;
        warp_l[warp] = l;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) warp_acc[warp][sub * 8 + i] = acc[i];
    }
    __syncthreads();
    if (warp == 0 && lane < LPR) {
      m = warp_m[0];
      l = warp_l[0];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = warp_acc[0][sub * 8 + i];
      for (int w = 1; w < kSplitWarps; ++w)
        merge_state(m, l, acc, warp_m[w], warp_l[w], &warp_acc[w][sub * 8]);
    }
  }

  // every block of the cluster has started and rank 0's merge barrier
  // exists: write this block's partial into rank 0's slot `rank`, arrive
  // there, and (but for rank 0) leave. No rank waits for another but rank
  // 0, so finished and empty ranks free their SMs at once.
  cluster_wait();
  if (warp != 0 || lane >= LPR) return;
  if (rank < busy) {
    if (lane == 0) {
      st_cluster(cluster_addr(&part_m[rank], 0), m);
      st_cluster(cluster_addr(&part_l[rank], 0), l);
    }
    const uint32_t dst = cluster_addr(&part_acc[rank][sub * 8], 0);
    st_cluster4(dst, acc[0], acc[1], acc[2], acc[3]);
    st_cluster4(dst + 16, acc[4], acc[5], acc[6], acc[7]);
  }
  merge_bar_arrive(cluster_addr(&merge_bar, 0));
  if (rank != 0) return;

  // rank 0: once every lane of every rank has arrived, the busy ranks'
  // partials in rank order, then the row
  merge_bar_wait(&merge_bar);
  m = ff::kNegInf;
  l = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int r = 0; r < busy; ++r)
    merge_state(m, l, acc, part_m[r], part_l[r], &part_acc[r][sub * 8]);
  if (v_on) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = acc[i] * inv;
    *reinterpret_cast<uint4*>(out + ((long long)b * heads + h) * dv + sub * 8) =
        pack8<T>(o);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Path : int { kBlockPath = 0, kClusterPath = 1 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const int* lengths;
  void* out;
  int slots, heads, d, dv, page_size, pages_per_slot;
  long long k_sh, k_sp, k_st, v_sh, v_sp, v_st;
  float scale;
  int ranks;  // blocks a cluster (the cluster kernel)
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_block(const Args& a) {
  if (a.slots > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.heads, a.slots);
  const size_t smem = sizeof(float) * kWarps * (2 + a.dv);
  paged_decode_block_kernel<T><<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.table, a.lengths, static_cast<T*>(a.out),
      a.heads, a.d, a.dv, a.page_size, a.pages_per_slot, a.k_sh, a.k_sp,
      a.k_st, a.v_sh, a.v_sp, a.v_st, a.scale);
  return cudaGetLastError();
}

template <typename T, int LPR>
cudaError_t launch_cluster_lpr(const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ranks, a.heads, a.slots);
  cfg.blockDim = dim3(kSplitWarps * 32);
  cfg.dynamicSmemBytes = sizeof(int) * ((a.pages_per_slot + a.ranks - 1) / a.ranks);
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_decode_cluster_kernel<T, LPR>,
                            static_cast<const T*>(a.q),
                            static_cast<const T*>(a.k),
                            static_cast<const T*>(a.v), a.table, a.lengths,
                            static_cast<T*>(a.out), a.heads, a.d, a.dv,
                            a.page_size, a.pages_per_slot, a.k_sh, a.k_sp,
                            a.k_st, a.v_sh, a.v_sp, a.v_st, a.scale);
}

// whether the cluster kernel takes this shape: 16-bit, head dims multiples
// of 8 up to 256, every row start 16-byte aligned (strides in elements
// multiples of 8; the wrapper checks the base pointers), 1..8 blocks a
// cluster, a staged run of at most kMaxRunPages table entries
bool cluster_takes(const Args& a, int dtype) {
  const long long strides[6] = {a.k_sh, a.k_sp, a.k_st, a.v_sh, a.v_sp, a.v_st};
  for (long long s : strides)
    if (s % 8) return false;
  return (dtype == ff::kBF16 || dtype == ff::kF16) && a.d % 8 == 0 &&
         a.dv % 8 == 0 && a.slots <= 65535 && a.heads <= 65535 &&
         a.ranks >= 1 && a.ranks <= kMaxRanks &&
         (a.pages_per_slot + a.ranks - 1) / a.ranks <= kMaxRunPages;
}

template <typename T>
cudaError_t launch_cluster(const Args& a) {
  const int widest = a.d > a.dv ? a.d : a.dv;
  if (widest <= 32) return launch_cluster_lpr<T, 4>(a);
  if (widest <= 64) return launch_cluster_lpr<T, 8>(a);
  if (widest <= 128) return launch_cluster_lpr<T, 16>(a);
  return launch_cluster_lpr<T, 32>(a);
}

}  // namespace

extern "C" int ff_paged_decode(int device, int dtype, const void* q,
                               const void* k, const void* v, const void* table,
                               const void* lengths, void* out, int slots,
                               int heads, int d, int dv, int page_size,
                               int pages_per_slot, long long k_sh,
                               long long k_sp, long long k_st, long long v_sh,
                               long long v_sp, long long v_st, float scale,
                               int path, int ranks, void* stream) {
  if (d < 1 || dv < 1 || d > 32 * kLaneVals || dv > 32 * kLaneVals ||
      slots < 1 || heads < 1 || page_size < 1 || pages_per_slot < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     k,     v,    static_cast<const int*>(table),
               static_cast<const int*>(lengths), out, slots, heads, d, dv,
               page_size, pages_per_slot, k_sh, k_sp, k_st, v_sh, v_sp, v_st,
               scale, ranks, static_cast<cudaStream_t>(stream)};
  if (path == kClusterPath && !cluster_takes(a, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path != kBlockPath && path != kClusterPath)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype) {
    case ff::kF32:
      return static_cast<int>(launch_block<float>(a));
    case ff::kF16:
      return static_cast<int>(path == kClusterPath ? launch_cluster<__half>(a)
                                                   : launch_block<__half>(a));
    case ff::kBF16:
      return static_cast<int>(path == kClusterPath
                                  ? launch_cluster<__nv_bfloat16>(a)
                                  : launch_block<__nv_bfloat16>(a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
