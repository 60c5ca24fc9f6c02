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
// quadratically and take over. chip_smoke.py computes the bound per run.
//
// Design (bf16/fp16, head dims multiples of 16): the TPU kernel holds a whole (sq, sk) score row in VMEM
// (FLASH_FUSED_MAX_TILE); a Hopper SM has 227 KB of shared memory, so this
// kernel streams K/V in 64-key tiles with an online softmax instead, and
// sequence length does not bind it. One block of 4 warps owns one
// (row, 64-query tile); each warp owns 16 query rows. The two products
// run on the tensor cores through the WMMA API (16x16x16, f32
// accumulators); the softmax runs on the f32 score tile in shared memory,
// and the running O accumulator lives in shared memory in f32. Key tiles
// wholly above the diagonal are never loaded. Simple first: no wgmma, TMA
// or warp specialisation yet.
//
// f32 operands, and head dims that are not multiples of 16 (1..256), take
// a second kernel on the CUDA cores: one warp per query row, lanes split
// the head dim, an online softmax in registers over the row's live keys
// (those past the causal diagonal are never read). The JAX kernel takes
// f32 too, so an f32 model on the card runs a hand-written kernel as well.
#include <mma.h>

#include "common.cuh"

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
                 int causal, float scale, ff::Dropout drop) {
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
                      int causal, float scale, ff::Dropout drop) {
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

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int bh, sq, sk, d, dv, causal;
  float scale;
  ff::Dropout drop;
  cudaStream_t stream;
};

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
cudaError_t launch(const Args& a) {
  if (a.d % 16 || a.dv % 16) return launch_rows<T, kDrop>(a);
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

template <bool kDrop>
cudaError_t dispatch(int dtype, const Args& a) {
  switch (dtype) {
    case ff::kF32:
      return launch_rows<float, kDrop>(a);
    case ff::kF16:
      return launch<__half, kDrop>(a);
    case ff::kBF16:
      return launch<__nv_bfloat16, kDrop>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// s0, s1: the dropout seeds; threshold: round(rate * 2^32) capped at
// 2^32 - 1, 0 for no dropout; inv_keep: 1 / (1 - rate).
extern "C" int ff_flash_fwd(int device, int dtype, const void* q,
                            const void* k, const void* v, void* o, void* lse,
                            int bh, int sq, int sk, int d, int dv, int causal,
                            float scale, unsigned int s0, unsigned int s1,
                            unsigned int threshold, float inv_keep,
                            void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 1 || dv < 1 ||
      d > kMaxDim || dv > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q,  k,  v,      o,     static_cast<float*>(lse),
               bh, sq, sk,     d,     dv,
               causal, scale, ff::Dropout{s0, s1, threshold, inv_keep},
               static_cast<cudaStream_t>(stream)};
  err = threshold ? dispatch<true>(dtype, a) : dispatch<false>(dtype, a);
  return static_cast<int>(err);
}
