// Flash-attention forward for Hopper (sm_90a), with attention dropout.
//
// Replaces the TPU kernel flexflow_tpu/kernels/attention.py
// `_flash_fwd_kernel` (driven by `_flash_fwd_folded`). Same contract: folded operands q (bh, sq, d), k (bh, sk, d),
// v (bh, sk, dv) in f32, bf16 or fp16, all contiguous, d and dv <= 256; S = Q K^T / sqrt(d) with
// f32 accumulation; causal masking keeps key <= query (top-left aligned)
// and masks with -1e30, never -inf; P is rounded to the input dtype
// before P V while the row sum l is taken over the f32 probabilities;
// O = P V / max(l, 1e-30) in the input dtype and lse = m + log(max(l,
// 1e-30)) in f32, laid out (bh, 1, sq) so a backward can consume it.
// Dropout (threshold != 0): the keep-mask of common.cuh is applied to P
// after P has gone into the row sum l and before it is rounded for P V,
// kept entries scaled by 1 / (1 - rate). With the online softmax, l and
// the rescale factor alpha stay undropped, so O equals the JAX kernel's
// whole-row result; the mask adds no bytes, ~14 integer operations per
// score. It is a template flag, so the dropout-free launch does the same
// work as without it.
//
// Bound on the H100: bytes, narrowly. At the serving shape (bh = 128,
// sq = sk = 512, d = dv = 64, causal) the useful work is ~4.3 GFLOP
// (~4.35 us at the 989 TFLOP/s bf16 dense peak) while q, k, v and O move
// ~33.8 MB (~10.1 us at 3.35 TB/s); at longer sequences the FLOPs grow
// quadratically and take over. The exp2 of every score also has a rate:
// the SFU's 16 a clock per SM is 1/256 of the bf16 tensor rate, so at
// d = 64 the softmax's exponentials take as long as the two products,
// which is why the wgmma path overlaps them. chip_smoke.py computes the
// bound per run.
//
// Three kernels, one per path; the caller picks the path by shape
// (kernels/attention.py `flash_path`) and passes it in. The TPU kernel
// holds a whole (sq, sk) score row in VMEM (FLASH_FUSED_MAX_TILE); a
// Hopper SM has 227 KB of shared memory, so every path here streams K/V in
// key tiles with an online softmax instead, and sequence length does not
// bind it. Key tiles wholly above the diagonal are never loaded.
//
// "wgmma" (bf16/fp16, d == dv in {64, 128}; all three main paths): one
// block per (row, 64-query tile): one consumer warpgroup and one producer
// warpgroup, two blocks an SM, so that one block's loads and epilogue
// overlap the other's products. The producer loads Q once and streams
// K/V tiles (128 keys at d = 64, 64 at d = 128) by TMA into a ring of
// 128-byte-swizzled tiles guarded by mbarriers (sm90.cuh; 3 stages at
// d = 64, 2 at d = 128). The consumers compute S = Q K^T by wgmma from
// shared memory into registers, run the online softmax on the accumulator
// fragment (a row over 4 threads: two quad shuffles; the max on the raw
// scores, each p one FMA and one exp2 with log2(e) folded into the
// scale), convert P to the input dtype in registers and feed it as the
// register A operand of O += P V (V MN-major through the transpose bit).
// O stays in registers for the whole key loop. Within the warpgroup the
// loop is software-pipelined: S of tile j + 1 is issued before P V of
// tile j, and the softmax of tile j + 1 runs while P V of tile j is on
// the tensor cores. Only the epilogue touches device memory.
//
// "wmma" (bf16/fp16, other head dims multiples of 16): one block of 4
// warps owns one (row, 64-query tile); each warp owns 16 query rows. The
// two products run through the WMMA API (16x16x16, f32 accumulators); the
// softmax runs on the f32 score tile in shared memory, and the running O
// accumulator lives in shared memory in f32.
//
// "rows" (f32 operands, and head dims that are not multiples of 16,
// 1..256): a kernel on the CUDA cores: one warp per query row, lanes split
// the head dim, an online softmax in registers over the row's live keys
// (those past the causal diagonal are never read). The JAX kernel takes
// f32 too, so an f32 model on the card runs a hand-written kernel as well.
#include <mma.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace nvcuda;

constexpr int kBr = 64;  // query rows per block
constexpr int kBc = 64;  // keys per tile
constexpr int kWarps = kBr / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDim = 256;

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory carve-up, identical on host and device. Leading
// dimensions are padded (and stay multiples of 8 halves / 4 floats, as
// WMMA requires) to spread rows over the banks.
struct Layout {
  int ldq, ldk, ldv, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, total;
  __host__ __device__ Layout(int d, int dv) {
    ldq = d + 8;
    ldk = d + 8;
    ldv = dv + 8;
    lds = kBc + 4;
    ldp = kBc + 8;
    ldo = dv + 4;
    q = 0;
    k = align128(q + sizeof(__half) * kBr * ldq);
    v = align128(k + sizeof(__half) * kBc * ldk);
    s = align128(v + sizeof(__half) * kBc * ldv);
    p = align128(s + sizeof(float) * kBr * lds);
    o = align128(p + sizeof(__half) * kBr * ldp);
    m = align128(o + sizeof(float) * kBr * ldo);
    l = m + sizeof(float) * kBr;
    total = align128(l + sizeof(float) * kBr);
  }
};

// rows [r_begin, r_begin + rows) of a row-major (total_rows, cols) global
// matrix into shared memory with leading dimension ld; rows past
// total_rows are zero-filled. 16-byte copies: cols % 8 == 0.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int cols, int r_begin,
                                          int total_rows, int rows) {
  static_assert(sizeof(T) == 2, "16-bit operands only");
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r_begin + r < total_rows)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r_begin + r) * cols + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int d, int dv,
                 int causal, float scale, ff::DropoutArgs drop_args) {
  const ff::Dropout drop = ff::load_dropout<kDrop>(drop_args);
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(d, dv);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  T* Ps = reinterpret_cast<T*>(smem + L.p);
  float* Os = reinterpret_cast<float*>(smem + L.o);
  float* Mrow = reinterpret_cast<float*>(smem + L.m);
  float* Lrow = reinterpret_cast<float*>(smem + L.l);

  const long long row = blockIdx.y;
  const int q0 = blockIdx.x * kBr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  const T* qg = q + row * sq * d;
  const T* kg = k + row * sk * d;
  const T* vg = v + row * sk * dv;

  load_tile(Qs, L.ldq, qg, d, q0, sq, kBr);
  for (int i = threadIdx.x; i < kBr * L.ldo; i += kThreads) Os[i] = 0.f;
  for (int i = threadIdx.x; i < kBr; i += kThreads) {
    Mrow[i] = ff::kNegInf;
    Lrow[i] = 0.f;
  }

  // under the causal mask every key past this tile's last query row is
  // masked for all of its rows: those tiles are skipped
  const int kv_end = causal ? min(sk, q0 + kBr) : sk;
  const int n_tiles = (kv_end + kBc - 1) / kBc;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBc;
    __syncthreads();  // the previous tile's readers of Ks/Vs are done
    load_tile(Ks, L.ldk, kg, d, k0, sk, kBc);
    load_tile(Vs, L.ldv, vg, dv, k0, sk, kBc);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    for (int n = 0; n < kBc / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bk;
        wmma::load_matrix_sync(a, Qs + r0 * L.ldq + kk, L.ldq);
        wmma::load_matrix_sync(bk, Ks + n * 16 * L.ldk + kk, L.ldk);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(Ss + r0 * L.lds + n * 16, acc, L.lds,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile, one row at a time across the warp
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int qpos = q0 + r;
      const float m_old = Mrow[r];
      const float l_old = Lrow[r];
      float sv[kBc / 32];
      float rmax = ff::kNegInf;
#pragma unroll
      for (int c2 = 0; c2 < kBc / 32; ++c2) {
        const int c = lane + 32 * c2;
        const int kpos = k0 + c;
        float x;
        if (kpos >= sk) {
          x = -__int_as_float(0x7f800000);  // past the sequence: -inf, adds 0
        } else {
          x = Ss[r * L.lds + c] * scale;
          if (causal && kpos > qpos) x = ff::kNegInf;
        }
        sv[c2] = x;
        rmax = fmaxf(rmax, x);
      }
      rmax = ff::warp_max(rmax);
      const float m_new = fmaxf(m_old, rmax);
      float rsum = 0.f;
#pragma unroll
      for (int c2 = 0; c2 < kBc / 32; ++c2) {
        const int c = lane + 32 * c2;
        const float p = expf(sv[c2] - m_new);
        rsum += p;
        float pv = p;  // keys past sk have p = 0 and are never dropped
        if (kDrop && k0 + c < sk)
          pv = ff::dropped(drop, row, sq, sk, qpos, k0 + c, p);
        Ps[r * L.ldp + c] = ff::from_f32<T>(pv);
      }
      rsum = ff::warp_sum(rsum);
      const float alpha = expf(m_old - m_new);
      for (int c = lane; c < dv; c += 32) Os[r * L.ldo + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        Mrow[r] = m_new;
        Lrow[r] = l_old * alpha + rsum;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    for (int n = 0; n < dv / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + r0 * L.ldo + n * 16, L.ldo,
                             wmma::mem_row_major);
      for (int kk = 0; kk < kBc; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + r0 * L.ldp + kk, L.ldp);
        wmma::load_matrix_sync(bv, Vs + kk * L.ldv + n * 16, L.ldv);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + r0 * L.ldo + n * 16, acc, L.ldo,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // each warp writes its own rows
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int qpos = q0 + r;
    if (qpos >= sq) break;
    const float lc = fmaxf(Lrow[r], 1e-30f);
    T* orow = o + (row * sq + qpos) * dv;
    for (int c = lane; c < dv; c += 32)
      orow[c] = ff::from_f32<T>(Os[r * L.ldo + c] / lc);
    if (lane == 0) lse[row * sq + qpos] = Mrow[r] + logf(lc);
  }
}

constexpr int kRowWarps = 4;              // query rows per block
constexpr int kRowTok = 4;                // keys in flight per warp
constexpr int kLaneVals = kMaxDim / 32;   // head dims per lane

// One warp per query row. Same contract as flash_fwd_kernel: P is
// rounded to T before P V (a no-op for f32) while l sums the f32
// probabilities. A key past the causal diagonal would get -1e30 and
// contribute exp(-1e30 - m) = 0 next to key 0, which every row sees, so
// skipping it changes nothing.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kRowWarps * 32)
flash_fwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int d, int dv,
                      int causal, float scale, ff::DropoutArgs drop_args) {
  const ff::Dropout drop = ff::load_dropout<kDrop>(drop_args);
  const long long row = blockIdx.y;
  const int qpos = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qpos >= sq) return;  // whole warps only; no block-wide sync follows
  const T* qr = q + (row * sq + qpos) * d;
  const T* kg = k + row * sk * d;
  const T* vg = v + row * sk * dv;
  float qv[kLaneVals];
  float acc[kLaneVals];
#pragma unroll
  for (int i = 0; i < kLaneVals; ++i) {
    const int c = lane + 32 * i;
    qv[i] = c < d ? ff::to_f32(qr[c]) : 0.f;
    acc[i] = 0.f;
  }
  const int kv_end = causal ? min(sk, qpos + 1) : sk;
  float m = ff::kNegInf;
  float l = 0.f;
  for (int base = 0; base < kv_end; base += kRowTok) {
    float s[kRowTok];
#pragma unroll
    for (int u = 0; u < kRowTok; ++u) {
      s[u] = 0.f;
      if (base + u < kv_end) {
        const T* kr = kg + static_cast<long long>(base + u) * d;
#pragma unroll
        for (int i = 0; i < kLaneVals; ++i) {
          const int c = lane + 32 * i;
          if (c < d) s[u] += qv[i] * ff::to_f32(kr[c]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowTok; ++u) s[u] = ff::warp_sum(s[u]) * scale;
    float cmax = ff::kNegInf;
#pragma unroll
    for (int u = 0; u < kRowTok; ++u)
      if (base + u < kv_end) cmax = fmaxf(cmax, s[u]);
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kLaneVals; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kRowTok; ++u) {
      if (base + u < kv_end) {
        const float p = expf(s[u] - m_new);
        l += p;
        const float pd =
            kDrop ? ff::dropped(drop, row, sq, sk, qpos, base + u, p) : p;
        const float pr = ff::to_f32(ff::from_f32<T>(pd));
        const T* vr = vg + static_cast<long long>(base + u) * dv;
#pragma unroll
        for (int i = 0; i < kLaneVals; ++i) {
          const int c = lane + 32 * i;
          if (c < dv) acc[i] += pr * ff::to_f32(vr[c]);
        }
      }
    }
    m = m_new;
  }
  const float lc = fmaxf(l, 1e-30f);
  T* orow = o + (row * sq + qpos) * dv;
#pragma unroll
  for (int i = 0; i < kLaneVals; ++i) {
    const int c = lane + 32 * i;
    if (c < dv) orow[c] = ff::from_f32<T>(acc[i] / lc);
  }
  if (lane == 0) lse[row * sq + qpos] = m + logf(lc);
}

namespace wg {

using namespace ff::sm90;

// One consumer warpgroup of 64 queries and one producer warpgroup a
// block, two blocks an SM: one block's loads and epilogue overlap the
// other's products. Registers: each block starts at 128 a thread; the
// producer gives back to 40 and the consumers take 216 (128 * 40 + 128 *
// 216 = 32768, half the SM's file).
constexpr int kBr = 64;            // queries per block
constexpr int kConsumerWarps = 4;  // one warpgroup
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
constexpr int kBlocksPerSM = 2;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 216;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory carve-up from the 1024-byte aligned base: Q, then per
// stage a K tile and a V tile, then the barriers (Q, full[], empty[]).
// Three stages at d = 64 (S of tile j + 1 runs beside P V of tile j while
// tile j + 2 loads), two at d = 128, where two blocks an SM leave no room
// for a third.
template <int D>
struct Tiles {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBc = D == 64 ? 128 : 64;  // keys per tile
  static constexpr int kHalves = D / 64;          // 64-column swizzle atoms
  static constexpr int kQBytes = kBr * D * 2;
  static constexpr int kKVBytes = kBc * D * 2;    // one K (or V) tile
  static constexpr int kStage = 2 * kKVBytes;
  static constexpr int kK = kQBytes;  // stage s at kK + s kStage
  static constexpr int kBar = kK + kStages * kStage;
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// The online softmax of one tile of raw scores Q K^T, in place: the mask
// at each value's (q, k) where the tile reaches past sk (TMA's zero rows:
// -inf, so p = 0) or past the causal diagonal (a raw score that scales to
// -1e30), the running max m (log2 units of the scaled score: the max is
// taken on the raw scores, and scale > 0) and this thread's share of the
// running sum l (the undropped f32 probabilities), then P (dropped and
// scaled) for P V. Each p is one FMA and one exp2. alpha: the factor by
// which the rows' O and l fall.
template <int R, bool kDrop, bool kMask>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[R], int k0, int rbase, int cbase, int sq, int sk, int causal,
    int b, float scale_log2, const ff::Dropout& drop, float (&m_run)[2],
    float (&l_run)[2], float (&alpha)[2]) {
  const float neg_inf = -__int_as_float(0x7f800000);
  float mx[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int h = (i >> 1) & 1;
    if (kMask) {
      const int kpos = k0 + 8 * (i >> 2) + cbase + (i & 1);
      if (kpos >= sk)
        sc[i] = neg_inf;
      else if (causal && kpos > rbase + 8 * h)
        sc[i] = ff::kNegInf / scale_log2;
    }
    mx[h] = fmaxf(mx[h], sc[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h] * scale_log2);
    alpha[h] = exp2_approx(m_run[h] - m_new);
    m_run[h] = m_new;
    l_run[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int h = (i >> 1) & 1;
    const float p = exp2_approx(fmaf(sc[i], scale_log2, -m_run[h]));
    l_run[h] += p;
    float pv = p;
    if (kDrop)
      pv = ff::dropped(drop, b, sq, sk, rbase + 8 * h,
                       k0 + 8 * (i >> 2) + cbase + (i & 1), p);
    sc[i] = pv;
  }
}

// The consumer warpgroups' part of flash_fwd_wgmma_kernel. Software
// pipelined within the warpgroup: S of tile j + 1 is issued before P V of
// tile j, so the softmax of tile j + 1 runs on the CUDA cores while P V
// of tile j runs on the tensor cores.
template <typename T, int D, bool kDrop>
__device__ __forceinline__ void consume(uint32_t base, T* __restrict__ o,
                                        float* __restrict__ lse, int sq,
                                        int sk, int causal, float scale_log2,
                                        const ff::Dropout& drop) {
  using C = Tiles<D>;
  constexpr int kBc = C::kBc;
  constexpr int kStages = C::kStages;
  const uint32_t bar_q = base + C::kBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kv_end = causal ? min(sk, q0 + kBr) : sk;
  const int n_tiles = (kv_end + kBc - 1) / kBc;
  // warpgroup g owns queries q0 + 64 g .. + 63; accumulator value i of
  // this thread lies in query row rbase + 8 ((i >> 1) & 1) and tile column
  // 8 (i >> 2) + cbase + (i & 1). This warp's rows start at row0.
  const int g = warp >> 2;
  const int row0 = q0 + 64 * g + 16 * (warp & 3);
  const int rbase = row0 + (lane >> 2);
  const int cbase = 2 * (lane & 3);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max (log2 units of the scaled score) and this thread's share
  // of the running sum, for rows rbase and rbase + 8
  float m_run[2] = {ff::kNegInf, ff::kNegInf};
  float l_run[2] = {0.f, 0.f};
  float alpha[2];
  float sc[kBc / 2];
  uint32_t pa[kBc / 16][4];

  // S = Q K^T of tile j (stage j % kStages), issued and committed
  auto issue_s = [&](int j) {
    const uint32_t kt = base + C::kK + (j % kStages) * C::kStage;
    mbar_wait(bar_full + 8 * (j % kStages), (j / kStages) & 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBc, T>::ss(sc, desc_kmajor(base, kBr, 64 * g, kk),
                        desc_kmajor(kt, kBc, 0, kk), kk);
    wgmma_commit();
  };
  // the softmax of tile j; only tiles that reach past sk or, for some row
  // of this warp, past the diagonal pay for the mask
  auto softmax = [&](int j) {
    const int k0 = j * kBc;
    if (k0 + kBc > sk || (causal && k0 + kBc - 1 > row0))
      softmax_tile<kBc / 2, kDrop, true>(sc, k0, rbase, cbase, sq, sk, causal,
                                         b, scale_log2, drop, m_run, l_run,
                                         alpha);
    else
      softmax_tile<kBc / 2, kDrop, false>(sc, k0, rbase, cbase, sq, sk,
                                          causal, b, scale_log2, drop, m_run,
                                          l_run, alpha);
  };

  // O += round(P) V of tile j: P from registers, V MN-major
  auto issue_pv = [&](int j) {
    const uint32_t vt = base + C::kK + (j % kStages) * C::kStage + C::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk)
      Wgmma<D, T>::rs(acc, pa[kk], desc_mnmajor(vt, kBc, kk), 1);
    wgmma_commit();
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (j % kStages));
  };

  mbar_wait(bar_q, 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);  // O is still 0: no rescale
  acc_to_frags<T>(sc, pa);
  // every iteration commits the same two groups, S of the next tile and
  // P V of this one (the last tile is peeled off), so that the wait for
  // the first leaves the second running
  for (int j = 0; j + 1 < n_tiles; ++j) {
    wgmma_fence();
    issue_s(j + 1);
    issue_pv(j);
    wgmma_wait<1>();  // S of tile j + 1 has landed; P V may still run
    fence_regs(sc);
    softmax(j + 1);
    wgmma_wait<0>();
    fence_regs(acc);
    release(j);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    acc_to_frags<T>(sc, pa);
  }
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(acc);
  release(n_tiles - 1);

  // O / max(l, 1e-30) in the input dtype, lse = m + log(max(l, 1e-30))
  const long long orow0 = static_cast<long long>(b) * sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    const int qpos = rbase + 8 * h;
    if (qpos >= sq) continue;
    const float lc = fmaxf(l_run[h], 1e-30f);
    T* orow = o + (orow0 + qpos) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int i = 4 * n + 2 * h;
      *reinterpret_cast<uint32_t*>(orow + 8 * n + cbase) =
          pack2<T>(acc[i] / lc, acc[i + 1] / lc);
    }
    if ((lane & 3) == 0) lse[orow0 + qpos] = m_run[h] * kLn2 + logf(lc);
  }
}

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ o, float* __restrict__ lse, int sq,
                       int sk, int causal, float scale_log2,
                       ff::DropoutArgs drop_args) {
  const ff::Dropout drop = ff::load_dropout<kDrop>(drop_args);
  using C = Tiles<D>;
  constexpr int kBc = C::kBc;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + C::kBar;
  const uint32_t bar_full = bar_q + 8;                // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 s
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBr;
  const int warp = threadIdx.x >> 5;
  // under the causal mask every key past this block's last query is
  // masked for all of its rows: those tiles are skipped
  const int kv_end = causal ? min(sk, q0 + kBr) : sk;
  const int n_tiles = (kv_end + kBc - 1) / kBc;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer: one thread issues TMA
    producer_regs<kProducerRegs>();
    if (threadIdx.x == 32 * kConsumerWarps) {
      mbar_arrive_expect_tx(bar_q, C::kQBytes);
      tma_load_tile(base, &tq, bar_q, kBr, C::kHalves, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        // use j / kStages of this stage waits for the release of the last
        if (j >= kStages) mbar_wait(bar_empty + 8 * s, (j / kStages - 1) & 1);
        const uint32_t kt = base + C::kK + s * C::kStage;
        mbar_arrive_expect_tx(bar_full + 8 * s, C::kStage);
        tma_load_tile(kt, &tk, bar_full + 8 * s, kBc, C::kHalves, j * kBc, b);
        tma_load_tile(kt + C::kKVBytes, &tv, bar_full + 8 * s, kBc,
                      C::kHalves, j * kBc, b);
      }
    }
  } else {
    consumer_regs<kConsumerRegs>();
    consume<T, D, kDrop>(base, o, lse, sq, sk, causal, scale_log2, drop);
  }
}

}  // namespace wg

// path codes shared with kernels/attention.py `flash_path`
enum Path : int { kRows = 0, kWmma = 1, kWgmma = 2 };

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int bh, sq, sk, d, dv, causal;
  float scale;
  ff::DropoutArgs drop;
  cudaStream_t stream;
};

template <typename T, int D, bool kDrop>
cudaError_t launch_wgmma(const Args& a, int dtype) {
  using C = wg::Tiles<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = ff::sm90::tma_map_3d(&tq, a.q, dtype, D, a.sq, a.bh, wg::kBr);
  if (err == cudaSuccess)
    err = ff::sm90::tma_map_3d(&tk, a.k, dtype, D, a.sk, a.bh, C::kBc);
  if (err == cudaSuccess)
    err = ff::sm90::tma_map_3d(&tv, a.v, dtype, D, a.sk, a.bh, C::kBc);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wg::flash_fwd_wgmma_kernel<T, D, kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + wg::kBr - 1) / wg::kBr, a.bh);
  wg::flash_fwd_wgmma_kernel<T, D, kDrop>
      <<<grid, wg::kThreads, C::kSmem, a.stream>>>(
          tq, tk, tv, static_cast<T*>(a.o), a.lse, a.sq, a.sk, a.causal,
          a.scale * wg::kLog2e, a.drop);
  return cudaGetLastError();
}

template <typename T, bool kDrop>
cudaError_t launch_rows(const Args& a) {
  const dim3 grid((a.sq + kRowWarps - 1) / kRowWarps, a.bh);
  flash_fwd_rows_kernel<T, kDrop><<<grid, kRowWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.sq, a.sk,
      a.d, a.dv, a.causal, a.scale, a.drop);
  return cudaGetLastError();
}

template <typename T, bool kDrop>
cudaError_t launch_wmma(const Args& a) {
  if (a.d % 16 || a.dv % 16) return cudaErrorInvalidValue;
  const Layout L(a.d, a.dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBr - 1) / kBr, a.bh);
  flash_fwd_kernel<T, kDrop><<<grid, kThreads, L.total, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.sq, a.sk,
      a.d, a.dv, a.causal, a.scale, a.drop);
  return cudaGetLastError();
}

// a 16-bit launch on the path asked for; a shape the path does not take
// is refused, never sent elsewhere
template <typename T, bool kDrop>
cudaError_t launch(const Args& a, int dtype, int path) {
  switch (path) {
    case kRows:
      return launch_rows<T, kDrop>(a);
    case kWmma:
      return launch_wmma<T, kDrop>(a);
    case kWgmma:
      if (a.d != a.dv) return cudaErrorInvalidValue;
      if (a.d == 64) return launch_wgmma<T, 64, kDrop>(a, dtype);
      if (a.d == 128) return launch_wgmma<T, 128, kDrop>(a, dtype);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDrop>
cudaError_t dispatch(int dtype, int path, const Args& a) {
  switch (dtype) {
    case ff::kF32:
      return path == kRows ? launch_rows<float, kDrop>(a)
                           : cudaErrorInvalidValue;
    case ff::kF16:
      return launch<__half, kDrop>(a, dtype, path);
    case ff::kBF16:
      return launch<__nv_bfloat16, kDrop>(a, dtype, path);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// seeds: the dropout's two uint32 seeds in device memory, read by each
// block as it starts (a captured graph replays the launch with the
// pointer, so each replay sees the seeds the buffer then holds);
// threshold: round(rate * 2^32) capped at 2^32 - 1, 0 for no dropout
// (seeds may then be null); inv_keep: 1 / (1 - rate); path: kRows, kWmma
// or kWgmma.
extern "C" int ff_flash_fwd(int device, int dtype, const void* q,
                            const void* k, const void* v, void* o, void* lse,
                            int bh, int sq, int sk, int d, int dv, int causal,
                            float scale, const unsigned int* seeds,
                            unsigned int threshold, float inv_keep,
                            int path, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 1 || dv < 1 ||
      d > kMaxDim || dv > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q,  k,  v,      o,     static_cast<float*>(lse),
               bh, sq, sk,     d,     dv,
               causal, scale, ff::DropoutArgs{seeds, threshold, inv_keep},
               static_cast<cudaStream_t>(stream)};
  err = threshold ? dispatch<true>(dtype, path, a)
                  : dispatch<false>(dtype, path, a);
  return static_cast<int>(err);
}

// Dynamic shared memory of a wgmma launch at head dim d (64 or 128), for
// the build report; 0 for another d.
extern "C" int ff_flash_fwd_wgmma_smem(int d) {
  return d == 64 ? wg::Tiles<64>::kSmem : d == 128 ? wg::Tiles<128>::kSmem : 0;
}
