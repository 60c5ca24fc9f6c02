// Flash-attention backward for Hopper (sm_90a), with attention dropout.
//
// Replaces the TPU kernel flexflow_tpu/kernels/attention.py
// `_flash_bwd_kernel` (driven by `_flash_bwd_folded` from the custom VJP
// `_flash_folded_vjp_bwd`). Same contract: folded
// operands q (bh, sq, d), k (bh, sk, d), v (bh, sk, dv), o and dO
// (bh, sq, dv) in f32, bf16 or fp16, all contiguous, d and dv <= 256, and
// the forward's lse (bh, 1, sq) in f32. With scale = 1/sqrt(d):
//   delta = rowsum(f32(dO) * f32(O))
//   S = Q K^T * scale (f32 accumulation), causal mask key <= query
//   (top-left aligned; a masked entry is -1e30, so its P is exactly 0)
//   P = exp(S - lse), dP = dO V^T (f32)
//   dS = P * (dP - delta)
//   dQ = (round(dS) K) * scale, dK = (round(dS)^T Q) * scale,
//   dV = round(P)^T dO
// where round() is the rounding to the input dtype that the JAX kernel
// applies before each of those three products; dq, dk and dv are
// accumulated in f32 and written in the input dtype. Keys that no query
// sees (above the diagonal) get dk = dv = 0. Dropout (threshold != 0)
// rebuilds the forward's keep-mask (common.cuh) from (row, q, k) alone in
// both passes and applies it where the chain rule puts it: dP is zeroed
// where the mask dropped and scaled by 1 / (1 - rate) where it kept, and
// so is the P that feeds dV; dS = P * (dP - delta) takes the undropped P.
// The delta pre-pass does not change: rowsum(dO * O) already equals
// rowsum(P_dropped * dP) under dropout. A template flag, so the
// dropout-free launch does the same work as without it.
//
// Bound on the H100 at the training shape (bh = 128, sq = sk = 512,
// d = dv = 64, non-causal, bf16): the useful work is five products of
// 2*bh*sq*sk*d = 21.5 GFLOP (21.7 us at the 989 TFLOP/s bf16 dense peak);
// q, k, v, o, dO read and dq, dk, dv written, plus lse, are ~67.4 MB
// (20.1 us at 3.35 TB/s). So it is bound by operations, narrowly; causal
// halves the FLOPs and leaves it bytes-bound at ~20.1 us. chip_smoke.py
// computes the bound per run.
//
// Design (bf16/fp16, head dims multiples of 16). The TPU kernel holds a
// whole (sq, bk) score slab per row in VMEM and accumulates dq across key
// blocks in one program; Hopper's blocks run in parallel and cannot carry
// a sum between them. So this is the FlashAttention-2 split, in its
// deterministic two-pass form:
//   0. a small pre-pass writes delta (bh, sq) in f32 (one warp per row);
//   1. dK/dV: one block per (row, tile of 16*warps keys) walks the query
//      tiles (64 queries each; under causal masking only those at or
//      below its keys), recomputes S^T = K Q^T and dP^T = V dO^T per
//      16x16 sub-tile on the tensor cores, forms P and dS in f32, rounds
//      them into shared memory and accumulates dV += P^T dO and
//      dK += dS^T Q in f32;
//   2. dQ: one block per (row, tile of 16*warps queries) walks the key
//      tiles (64 keys each; under causal masking those up to its last
//      query), recomputes S and dP, forms dS, accumulates dQ += dS K.
// Pass 2 recomputes S and dP, two of the five products: 7 products in all
// where 5 are useful, 40% more FLOPs than the bound counts. f32 atomics
// on dQ would save them but make the summation order, and so the result,
// change from run to run; the tests and chip_smoke.py's gradient oracle
// compare runs, so the deterministic form comes first. Every product is
// WMMA 16x16x16 with f32 accumulation; the accumulators live in shared
// memory in f32 (simple first: no wgmma, TMA or warp specialisation, no
// register-resident accumulators). A block has 4 warps when its tiles fit
// the 227 KB of shared memory, else 2 or 1 (large head dims).
//
// f32 operands, and head dims that are not multiples of 16 (1..256), take
// the same three passes on the CUDA cores: one warp per key row (dK/dV)
// or query row (dQ), lanes split the head dims, 4 rows of the other side
// in flight. The forward kernel takes these too (flash_fwd.cu), so a
// model that runs the forward kernel also runs its backward.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kStream = 64;   // rows of the tile a block walks over
constexpr int kMaxWarps = 4;  // warps per block (16 own rows each)
constexpr int kMaxDim = 256;
constexpr int kScr = 16 + 4;  // leading dim of a warp's 16x16 f32 scratch
constexpr int kLdp = kStream + 8;

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory carve-up of both tensor-core passes, identical on host and
// device. "Own" tiles hold the block's rows (keys in pass 1, queries in
// pass 2): `x` is d wide (K or Q), `y` is dv wide (V or dO). "Stream"
// tiles hold the 64 rows being walked: `u` is d wide (Q or K), `w` is dv
// wide (dO or V). lse/delta belong to the query side. Pass 1 also keeps P
// and a dV accumulator. Leading dims are padded (multiples of 8 halves /
// 4 floats, as WMMA requires) to spread rows over the banks.
struct Layout {
  int rows, ldx, ldy, ldu, ldw, lda1, lda2;
  size_t x, y, u, w, lse, delta, scr, p, ds, acc1, acc2, total;
  __host__ __device__ Layout(int warps, int d, int dv, bool dkdv) {
    rows = 16 * warps;
    ldx = ldu = d + 8;
    ldy = ldw = dv + 8;
    lda1 = d + 4;   // dK (pass 1) or dQ (pass 2)
    lda2 = dv + 4;  // dV (pass 1)
    const int qrows = dkdv ? kStream : rows;  // rows of lse/delta
    x = 0;
    y = align128(x + sizeof(__half) * rows * ldx);
    u = align128(y + sizeof(__half) * rows * ldy);
    w = align128(u + sizeof(__half) * kStream * ldu);
    lse = align128(w + sizeof(__half) * kStream * ldw);
    delta = align128(lse + sizeof(float) * qrows);
    scr = align128(delta + sizeof(float) * qrows);
    p = align128(scr + sizeof(float) * warps * 2 * 16 * kScr);
    ds = align128(p + (dkdv ? sizeof(__half) * rows * kLdp : 0));
    acc1 = align128(ds + sizeof(__half) * rows * kLdp);
    acc2 = align128(acc1 + sizeof(float) * rows * lda1);
    total = align128(acc2 + (dkdv ? sizeof(float) * rows * lda2 : 0));
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

// lse and delta of queries [q0, q0 + n) into shared memory (0 past sq)
__device__ __forceinline__ void load_rowstats(float* lse_s, float* delta_s,
                                              const float* lse,
                                              const float* delta, int q0,
                                              int sq, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool in = q0 + i < sq;
    lse_s[i] = in ? lse[q0 + i] : 0.f;
    delta_s[i] = in ? delta[q0 + i] : 0.f;
  }
}

__device__ __forceinline__ void zero_f32(float* a, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = 0.f;
}

// acc (16 x 16*ncols, f32 in shared memory, leading dim lda) += A B where
// A is 16 x kStream (row-major T, leading dim ldp) and B is kStream x
// 16*ncols (row-major T, leading dim ldb). One warp.
template <typename T>
__device__ __forceinline__ void warp_accumulate(float* acc, int lda,
                                                const T* a, int ldp,
                                                const T* b, int ldb,
                                                int ncols) {
  for (int n = 0; n < ncols; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, acc + n * 16, lda, wmma::mem_row_major);
    for (int kk = 0; kk < kStream; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + kk, ldp);
      wmma::load_matrix_sync(fb, b + kk * ldb + n * 16, ldb);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + n * 16, c, lda, wmma::mem_row_major);
  }
}

// out (16 x 16, f32, leading dim kScr) = A B^T where A is 16 x depth
// (row-major, leading dim lda) and B is 16 x depth (row-major, leading
// dim ldb). One warp.
template <typename T>
__device__ __forceinline__ void warp_dot_nt(float* out, const T* a, int lda,
                                            const T* b, int ldb, int depth) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
  wmma::fill_fragment(c, 0.f);
  for (int kk = 0; kk < depth; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
    wmma::load_matrix_sync(fa, a + kk, lda);
    wmma::load_matrix_sync(fb, b + kk, ldb);
    wmma::mma_sync(c, fa, fb, c);
  }
  wmma::store_matrix_sync(out, c, kScr, wmma::mem_row_major);
}

// Pre-pass: delta = rowsum(f32(dO) * f32(O)), one warp per query row.
constexpr int kRowWarps = 4;
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int sq, int dv) {
  const long long row = blockIdx.y;
  const int qpos = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qpos >= sq) return;
  const long long base = (row * sq + qpos) * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32)
    acc += ff::to_f32(o[base + c]) * ff::to_f32(dout[base + c]);
  acc = ff::warp_sum(acc);
  if (lane == 0) delta[row * sq + qpos] = acc;
}

// Pass 1 on the tensor cores: dK and dV for 16 * warps keys of one row.
// gk/gv are the gradients dk/dv.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ gk,
                      T* __restrict__ gv, int sq, int sk, int d, int dv,
                      int causal, float scale, ff::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const Layout L(warps, d, dv, true);
  T* Ks = reinterpret_cast<T*>(smem + L.x);
  T* Vs = reinterpret_cast<T*>(smem + L.y);
  T* Qs = reinterpret_cast<T*>(smem + L.u);
  T* dOs = reinterpret_cast<T*>(smem + L.w);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  T* Ps = reinterpret_cast<T*>(smem + L.p);
  T* dSs = reinterpret_cast<T*>(smem + L.ds);
  float* dKacc = reinterpret_cast<float*>(smem + L.acc1);
  float* dVacc = reinterpret_cast<float*>(smem + L.acc2);

  const long long row = blockIdx.y;
  const int k0 = blockIdx.x * L.rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  float* scrS = reinterpret_cast<float*>(smem + L.scr) + warp * 2 * 16 * kScr;
  float* scrP = scrS + 16 * kScr;
  const T* qg = q + row * sq * d;
  const T* dog = dout + row * sq * dv;

  load_tile(Ks, L.ldx, k + row * sk * d, d, k0, sk, L.rows);
  load_tile(Vs, L.ldy, v + row * sk * dv, dv, k0, sk, L.rows);
  zero_f32(dKacc, L.rows * L.lda1);
  zero_f32(dVacc, L.rows * L.lda2);

  // under the causal mask, queries before this block's first key see none
  // of its keys: start at the query tile that holds k0
  const int q_begin = causal ? (k0 / kStream) * kStream : 0;
  for (int q0 = q_begin; q0 < sq; q0 += kStream) {
    __syncthreads();  // the previous tile's readers of Qs/dOs are done
    load_tile(Qs, L.ldu, qg, d, q0, sq, kStream);
    load_tile(dOs, L.ldw, dog, dv, q0, sq, kStream);
    load_rowstats(lse_s, delta_s, lse + row * sq, delta + row * sq, q0, sq,
                  kStream);
    __syncthreads();

    // P^T and dS^T for this warp's 16 keys x 64 queries, 16 at a time
    for (int n = 0; n < kStream / 16; ++n) {
      warp_dot_nt(scrS, Ks + r0 * L.ldx, L.ldx, Qs + n * 16 * L.ldu, L.ldu,
                  d);
      warp_dot_nt(scrP, Vs + r0 * L.ldy, L.ldy, dOs + n * 16 * L.ldw, L.ldw,
                  dv);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4;
        const int c = e & 15;
        const int kpos = k0 + r0 + r;
        const int qi = n * 16 + c;
        float p = 0.f;
        float ds = 0.f;
        if (q0 + qi < sq && kpos < sk && !(causal && kpos > q0 + qi)) {
          p = expf(scrS[r * kScr + c] * scale - lse_s[qi]);
          float dp = scrP[r * kScr + c];
          if (kDrop) {
            const bool kept = ff::keep(drop, row, sq, sk, q0 + qi, kpos);
            dp = kept ? dp * drop.inv_keep : 0.f;
            ds = p * (dp - delta_s[qi]);
            p = kept ? p * drop.inv_keep : 0.f;  // the P of dV
          } else {
            ds = p * (dp - delta_s[qi]);
          }
        }
        Ps[(r0 + r) * kLdp + qi] = ff::from_f32<T>(p);
        dSs[(r0 + r) * kLdp + qi] = ff::from_f32<T>(ds);
      }
      __syncwarp();
    }
    // dV += P^T dO, dK += dS^T Q over these 64 queries
    warp_accumulate(dVacc + r0 * L.lda2, L.lda2, Ps + r0 * kLdp, kLdp, dOs,
                    L.ldw, dv / 16);
    warp_accumulate(dKacc + r0 * L.lda1, L.lda1, dSs + r0 * kLdp, kLdp, Qs,
                    L.ldu, d / 16);
  }
  // an empty loop (keys no query sees) leaves the accumulators as other
  // warps zeroed them
  __syncthreads();

  // each warp writes its own keys
  for (int rr = 0; rr < 16; ++rr) {
    const int kpos = k0 + r0 + rr;
    if (kpos >= sk) break;
    T* gkr = gk + (row * sk + kpos) * d;
    T* gvr = gv + (row * sk + kpos) * dv;
    for (int c = lane; c < d; c += 32)
      gkr[c] = ff::from_f32<T>(dKacc[(r0 + rr) * L.lda1 + c] * scale);
    for (int c = lane; c < dv; c += 32)
      gvr[c] = ff::from_f32<T>(dVacc[(r0 + rr) * L.lda2 + c]);
  }
}

// Pass 2 on the tensor cores: dQ for 16 * warps queries of one row.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ gq,
                    int sq, int sk, int d, int dv, int causal, float scale,
                    ff::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const Layout L(warps, d, dv, false);
  T* Qs = reinterpret_cast<T*>(smem + L.x);
  T* dOs = reinterpret_cast<T*>(smem + L.y);
  T* Ks = reinterpret_cast<T*>(smem + L.u);
  T* Vs = reinterpret_cast<T*>(smem + L.w);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  T* dSs = reinterpret_cast<T*>(smem + L.ds);
  float* dQacc = reinterpret_cast<float*>(smem + L.acc1);

  const long long row = blockIdx.y;
  const int q0 = blockIdx.x * L.rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  float* scrS = reinterpret_cast<float*>(smem + L.scr) + warp * 2 * 16 * kScr;
  float* scrP = scrS + 16 * kScr;
  const T* kg = k + row * sk * d;
  const T* vg = v + row * sk * dv;

  load_tile(Qs, L.ldx, q + row * sq * d, d, q0, sq, L.rows);
  load_tile(dOs, L.ldy, dout + row * sq * dv, dv, q0, sq, L.rows);
  load_rowstats(lse_s, delta_s, lse + row * sq, delta + row * sq, q0, sq,
                L.rows);
  zero_f32(dQacc, L.rows * L.lda1);

  // under the causal mask, keys past this block's last query are masked
  // for all of its queries: those tiles are skipped
  const int kv_end = causal ? min(sk, q0 + L.rows) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kStream) {
    __syncthreads();  // the previous tile's readers of Ks/Vs are done
    load_tile(Ks, L.ldu, kg, d, k0, sk, kStream);
    load_tile(Vs, L.ldw, vg, dv, k0, sk, kStream);
    __syncthreads();

    for (int n = 0; n < kStream / 16; ++n) {
      warp_dot_nt(scrS, Qs + r0 * L.ldx, L.ldx, Ks + n * 16 * L.ldu, L.ldu,
                  d);
      warp_dot_nt(scrP, dOs + r0 * L.ldy, L.ldy, Vs + n * 16 * L.ldw, L.ldw,
                  dv);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4;
        const int c = e & 15;
        const int qpos = q0 + r0 + r;
        const int kpos = k0 + n * 16 + c;
        float ds = 0.f;
        if (kpos < sk && qpos < sq && !(causal && kpos > qpos)) {
          const float p = expf(scrS[r * kScr + c] * scale - lse_s[r0 + r]);
          float dp = scrP[r * kScr + c];
          if (kDrop) dp = ff::dropped(drop, row, sq, sk, qpos, kpos, dp);
          ds = p * (dp - delta_s[r0 + r]);
        }
        dSs[(r0 + r) * kLdp + n * 16 + c] = ff::from_f32<T>(ds);
      }
      __syncwarp();
    }
    // dQ += dS K over these 64 keys
    warp_accumulate(dQacc + r0 * L.lda1, L.lda1, dSs + r0 * kLdp, kLdp, Ks,
                    L.ldu, d / 16);
  }
  __syncthreads();

  for (int rr = 0; rr < 16; ++rr) {
    const int qpos = q0 + r0 + rr;
    if (qpos >= sq) break;
    T* gqr = gq + (row * sq + qpos) * d;
    for (int c = lane; c < d; c += 32)
      gqr[c] = ff::from_f32<T>(dQacc[(r0 + rr) * L.lda1 + c] * scale);
  }
}

constexpr int kRowTok = 4;               // rows of the other side in flight
constexpr int kLaneVals = kMaxDim / 32;  // head dims per lane

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return ff::to_f32(ff::from_f32<T>(x));
}

// Pass 1 on the CUDA cores: one warp per key row.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kRowWarps * 32)
flash_bwd_dkdv_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ gk, T* __restrict__ gv, int sq,
                           int sk, int d, int dv, int causal, float scale,
                           ff::Dropout drop) {
  const long long row = blockIdx.y;
  const int kpos = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kpos >= sk) return;  // whole warps only; no block-wide sync follows
  const T* kr = k + (row * sk + kpos) * d;
  const T* vr = v + (row * sk + kpos) * dv;
  float kv[kLaneVals], vv[kLaneVals], ak[kLaneVals], av[kLaneVals];
#pragma unroll
  for (int i = 0; i < kLaneVals; ++i) {
    const int c = lane + 32 * i;
    kv[i] = c < d ? ff::to_f32(kr[c]) : 0.f;
    vv[i] = c < dv ? ff::to_f32(vr[c]) : 0.f;
    ak[i] = av[i] = 0.f;
  }
  const float* lr = lse + row * sq;
  const float* dr = delta + row * sq;
  // under the causal mask only queries at or after this key see it
  for (int base = causal ? kpos : 0; base < sq; base += kRowTok) {
    float qv[kRowTok][kLaneVals], dov[kRowTok][kLaneVals];
    float s[kRowTok], dp[kRowTok];
#pragma unroll
    for (int u = 0; u < kRowTok; ++u) {
      s[u] = dp[u] = 0.f;
      const bool in = base + u < sq;
      const T* qr = q + (row * sq + base + u) * d;
      const T* dor = dout + (row * sq + base + u) * dv;
#pragma unroll
      for (int i = 0; i < kLaneVals; ++i) {
        const int c = lane + 32 * i;
        qv[u][i] = in && c < d ? ff::to_f32(qr[c]) : 0.f;
        dov[u][i] = in && c < dv ? ff::to_f32(dor[c]) : 0.f;
        s[u] += qv[u][i] * kv[i];
        dp[u] += dov[u][i] * vv[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kRowTok; ++u) {
      s[u] = ff::warp_sum(s[u]) * scale;
      dp[u] = ff::warp_sum(dp[u]);
    }
#pragma unroll
    for (int u = 0; u < kRowTok; ++u) {
      if (base + u < sq) {
        const float p = expf(s[u] - lr[base + u]);
        float pv = p;
        float dpv = dp[u];
        if (kDrop && !ff::keep(drop, row, sq, sk, base + u, kpos)) {
          pv = dpv = 0.f;
        } else if (kDrop) {
          pv *= drop.inv_keep;
          dpv *= drop.inv_keep;
        }
        const float pr = round_to<T>(pv);
        const float dsr = round_to<T>(p * (dpv - dr[base + u]));
#pragma unroll
        for (int i = 0; i < kLaneVals; ++i) {
          av[i] += pr * dov[u][i];
          ak[i] += dsr * qv[u][i];
        }
      }
    }
  }
  T* gkr = gk + (row * sk + kpos) * d;
  T* gvr = gv + (row * sk + kpos) * dv;
#pragma unroll
  for (int i = 0; i < kLaneVals; ++i) {
    const int c = lane + 32 * i;
    if (c < d) gkr[c] = ff::from_f32<T>(ak[i] * scale);
    if (c < dv) gvr[c] = ff::from_f32<T>(av[i]);
  }
}

// Pass 2 on the CUDA cores: one warp per query row.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kRowWarps * 32)
flash_bwd_dq_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ gq,
                         int sq, int sk, int d, int dv, int causal,
                         float scale, ff::Dropout drop) {
  const long long row = blockIdx.y;
  const int qpos = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qpos >= sq) return;
  const T* qr = q + (row * sq + qpos) * d;
  const T* dor = dout + (row * sq + qpos) * dv;
  float qv[kLaneVals], dov[kLaneVals], acc[kLaneVals];
#pragma unroll
  for (int i = 0; i < kLaneVals; ++i) {
    const int c = lane + 32 * i;
    qv[i] = c < d ? ff::to_f32(qr[c]) : 0.f;
    dov[i] = c < dv ? ff::to_f32(dor[c]) : 0.f;
    acc[i] = 0.f;
  }
  const float l = lse[row * sq + qpos];
  const float dl = delta[row * sq + qpos];
  const int kv_end = causal ? min(sk, qpos + 1) : sk;
  for (int base = 0; base < kv_end; base += kRowTok) {
    float kv[kRowTok][kLaneVals];
    float s[kRowTok], dp[kRowTok];
#pragma unroll
    for (int u = 0; u < kRowTok; ++u) {
      s[u] = dp[u] = 0.f;
      const bool in = base + u < kv_end;
      const T* kr = k + (row * sk + base + u) * d;
      const T* vr = v + (row * sk + base + u) * dv;
#pragma unroll
      for (int i = 0; i < kLaneVals; ++i) {
        const int c = lane + 32 * i;
        kv[u][i] = in && c < d ? ff::to_f32(kr[c]) : 0.f;
        s[u] += qv[i] * kv[u][i];
        if (in && c < dv) dp[u] += dov[i] * ff::to_f32(vr[c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowTok; ++u) {
      s[u] = ff::warp_sum(s[u]) * scale;
      dp[u] = ff::warp_sum(dp[u]);
    }
#pragma unroll
    for (int u = 0; u < kRowTok; ++u) {
      if (base + u < kv_end) {
        const float p = expf(s[u] - l);
        const float dpv =
            kDrop ? ff::dropped(drop, row, sq, sk, qpos, base + u, dp[u])
                  : dp[u];
        const float dsr = round_to<T>(p * (dpv - dl));
#pragma unroll
        for (int i = 0; i < kLaneVals; ++i) acc[i] += dsr * kv[u][i];
      }
    }
  }
  T* gqr = gq + (row * sq + qpos) * d;
#pragma unroll
  for (int i = 0; i < kLaneVals; ++i) {
    const int c = lane + 32 * i;
    if (c < d) gqr[c] = ff::from_f32<T>(acc[i] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *gq, *gk, *gv;
  int bh, sq, sk, d, dv, causal;
  float scale;
  ff::Dropout drop;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_delta(const Args& a) {
  const dim3 grid((a.sq + kRowWarps - 1) / kRowWarps, a.bh);
  flash_bwd_delta_kernel<T><<<grid, kRowWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      a.sq, a.dv);
  return cudaGetLastError();
}

template <typename T, bool kDrop>
cudaError_t launch_rows(const Args& a) {
  cudaError_t err = launch_delta<T>(a);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  flash_bwd_dkdv_rows_kernel<T, kDrop>
      <<<dim3((a.sk + kRowWarps - 1) / kRowWarps, a.bh), kRowWarps * 32, 0,
         a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.gk),
                     static_cast<T*>(a.gv), a.sq, a.sk, a.d, a.dv, a.causal,
                     a.scale, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_rows_kernel<T, kDrop>
      <<<dim3((a.sq + kRowWarps - 1) / kRowWarps, a.bh), kRowWarps * 32, 0,
         a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.gq),
                     a.sq, a.sk, a.d, a.dv, a.causal, a.scale, a.drop);
  return cudaGetLastError();
}

// the most warps (4, 2, 1) whose tiles fit the block's shared memory
int pick_warps(int max_smem, int d, int dv, bool dkdv) {
  for (int w = kMaxWarps; w >= 1; w /= 2)
    if (Layout(w, d, dv, dkdv).total <= static_cast<size_t>(max_smem))
      return w;
  return 0;
}

template <typename T, bool kDrop>
cudaError_t launch(const Args& a, int device) {
  if (a.d % 16 || a.dv % 16) return launch_rows<T, kDrop>(a);
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int w1 = pick_warps(max_smem, a.d, a.dv, true);
  const int w2 = pick_warps(max_smem, a.d, a.dv, false);
  if (!w1 || !w2) return cudaErrorInvalidValue;
  const size_t s1 = Layout(w1, a.d, a.dv, true).total;
  const size_t s2 = Layout(w2, a.d, a.dv, false).total;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (err != cudaSuccess) return err;
  err = launch_delta<T>(a);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  flash_bwd_dkdv_kernel<T, kDrop>
      <<<dim3((a.sk + 16 * w1 - 1) / (16 * w1), a.bh), 32 * w1, s1,
         a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.gk),
                     static_cast<T*>(a.gv), a.sq, a.sk, a.d, a.dv, a.causal,
                     a.scale, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, kDrop>
      <<<dim3((a.sq + 16 * w2 - 1) / (16 * w2), a.bh), 32 * w2, s2,
         a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.gq),
                     a.sq, a.sk, a.d, a.dv, a.causal, a.scale, a.drop);
  return cudaGetLastError();
}

template <bool kDrop>
cudaError_t dispatch(int dtype, const Args& a, int device) {
  switch (dtype) {
    case ff::kF32:
      return launch_rows<float, kDrop>(a);
    case ff::kF16:
      return launch<__half, kDrop>(a, device);
    case ff::kBF16:
      return launch<__nv_bfloat16, kDrop>(a, device);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// delta is scratch of bh * sq floats; gq, gk, gv receive dq, dk, dv.
// s0, s1, threshold, inv_keep: the forward's dropout (flash_fwd.cu).
extern "C" int ff_flash_bwd(int device, int dtype, const void* q,
                            const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta,
                            void* gq, void* gk, void* gv, int bh, int sq,
                            int sk, int d, int dv, int causal, float scale,
                            unsigned int s0, unsigned int s1,
                            unsigned int threshold, float inv_keep,
                            void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 1 || dv < 1 ||
      d > kMaxDim || dv > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q,  k,  v,  o,  dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), gq, gk, gv, bh, sq, sk, d, dv,
               causal, scale, ff::Dropout{s0, s1, threshold, inv_keep},
               static_cast<cudaStream_t>(stream)};
  err = threshold ? dispatch<true>(dtype, a, device)
                  : dispatch<false>(dtype, a, device);
  return static_cast<int>(err);
}
