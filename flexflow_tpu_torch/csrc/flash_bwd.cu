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
// Design. The TPU kernel holds a whole (sq, bk) score slab per row in
// VMEM and accumulates dq across key blocks in one program; Hopper's
// blocks run in parallel and cannot carry a sum between them. So every
// path here is the FlashAttention-2 split, in its deterministic two-pass
// form (no atomics: the same inputs give the same bits):
//   0. a small pre-pass writes delta (bh, sq) in f32 (one warp per row);
//   1. dK/dV: one block per (row, tile of keys) walks the query tiles
//      (under causal masking only those at or below its keys),
//      recomputes S^T = K Q^T and dP^T = V dO^T, forms P and dS in f32,
//      rounds them and accumulates dV += P^T dO and dK += dS^T Q in f32;
//   2. dQ: one block per (row, tile of queries) walks the key tiles
//      (under causal masking those up to its last query), recomputes S
//      and dP, forms dS, accumulates dQ += dS K.
// Pass 2 recomputes S and dP, two of the five products: 7 products in all
// where 5 are useful, 40% more FLOPs than the bound counts.
//
// The caller picks the path by shape (kernels/attention.py `flash_path`)
// and passes it in:
//
// "wgmma" (bf16/fp16, d == dv in {64, 128}; both training paths): each
// pass runs one block per (row, 64 own rows): one consumer warpgroup and
// one producer warpgroup, two blocks an SM. The producer loads the own
// tiles (K, V or Q, dO) once and streams the other side by TMA into a
// 2-stage ring of 128-byte-swizzled tiles (sm90.cuh); in pass 1 its
// lanes also copy the tile's lse (in log2 units) and delta beside it. The
// four products of pass 1 and three of pass 2 are wgmma with f32
// accumulators in registers: S^T and dP^T (pass 1), S and dP (pass 2)
// from shared memory; P^T, dS^T and dS, formed in registers from those
// accumulators, feed dV, dK and dQ as the register A operand, with dO, Q
// and K MN-major through the transpose bit. dK and dV (pass 1) and dQ
// (pass 2) stay in registers across the whole walk. Each product is its
// own group, so P is formed while dP's product runs and dS while dV's
// runs. Streamed tiles: 64 queries at d = 64 and 32 at d = 128 in pass 1
// (so dK and dV fit in registers), 64 keys in pass 2.
//
// "wmma" (bf16/fp16, other head dims multiples of 16): every product is
// WMMA 16x16x16 with f32 accumulation; the accumulators live in shared
// memory in f32. A block has 4 warps when its tiles fit the 227 KB of
// shared memory, else 2 or 1 (large head dims).
//
// "rows" (f32 operands, and head dims that are not multiples of 16,
// 1..256): the same three passes on the CUDA cores: one warp per key row
// (dK/dV) or query row (dQ), lanes split the head dims, 4 rows of the
// other side in flight. The forward kernel takes these too
// (flash_fwd.cu), so a model that runs the forward kernel also runs its
// backward.
#include <mma.h>

#include "common.cuh"
#include "sm90.cuh"

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
                      int causal, float scale, ff::DropoutArgs drop_args) {
  const ff::Dropout drop = ff::load_dropout<kDrop>(drop_args);
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
                    ff::DropoutArgs drop_args) {
  const ff::Dropout drop = ff::load_dropout<kDrop>(drop_args);
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
                           ff::DropoutArgs drop_args) {
  const ff::Dropout drop = ff::load_dropout<kDrop>(drop_args);
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
                         float scale, ff::DropoutArgs drop_args) {
  const ff::Dropout drop = ff::load_dropout<kDrop>(drop_args);
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

namespace wg {

using namespace ff::sm90;

// One consumer warpgroup of 64 own rows (keys or queries) and one
// producer warpgroup a block, two blocks an SM: one block's loads and
// epilogue overlap the other's products. Registers: each block starts at
// 128 a thread; the producer gives back to 40 and the consumers take 216
// (128 * 40 + 128 * 216 = 32768, half the SM's file).
constexpr int kBlock = 64;         // own rows per block
constexpr int kConsumerWarps = 4;  // one warpgroup
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
constexpr int kProducer = 32 * kConsumerWarps;       // its first thread
constexpr int kBlocksPerSM = 2;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 216;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory carve-up from the 1024-byte aligned base, both passes:
// the block's own two tiles (X: K or Q, Y: V or dO; kBlock rows each),
// then per stage the two streamed tiles (U: Q or K, W: dO or V; kRows
// rows each), then (dK/dV pass) per stage the streamed queries' lse (in
// log2 units) and delta, then the barriers (own, full[], empty[]).
template <int D, int kRows>
struct Tiles {
  static constexpr int kHalves = D / 64;  // 64-column swizzle atoms
  static constexpr int kOwnBytes = kBlock * D * 2;
  static constexpr int kTileBytes = kRows * D * 2;
  static constexpr int kStage = 2 * kTileBytes;
  static constexpr int kX = 0;
  static constexpr int kY = kOwnBytes;
  static constexpr int kU = 2 * kOwnBytes;  // stage s at kU + s kStage
  static constexpr int kStats = kU + kStages * kStage;  // lse[s][], delta[s][]
  static constexpr int kBar = kStats + kStages * 2 * kRows * 4;
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// the streamed tile: 64 queries at d = 64, 32 at d = 128 (dK/dV pass,
// where dK and dV both stay in registers); 64 keys (dQ pass)
template <int D>
constexpr int kQRows = D == 64 ? 64 : 32;
template <int D>
constexpr int kKRows = 64;

// Pass 1, consumers: dK and dV for keys k0 + 64 g .. + 63 of warpgroup g,
// over the streamed query tiles j_begin .. n_q - 1.
template <typename T, int D, bool kDrop>
__device__ __forceinline__ void dkdv_consume(
    uint32_t base, T* __restrict__ gk, T* __restrict__ gv, int sq, int sk,
    int causal, float scale, float scale_log2, const ff::Dropout& drop,
    int j_begin, int n_q) {
  constexpr int kBq = kQRows<D>;
  using C = Tiles<D, kBq>;
  const uint32_t bar_own = base + C::kBar;
  const uint32_t bar_full = bar_own + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = warp >> 2;
  // accumulator value i: key row kbase + 8 ((i >> 1) & 1), column (query
  // of the tile, or head dim) 8 (i >> 2) + cbase + (i & 1)
  const int kbase = k0 + 64 * g + 16 * (warp & 3) + (lane >> 2);
  const int cbase = 2 * (lane & 3);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_own, 0);
  for (int j = j_begin; j < n_q; ++j) {
    const int it = j - j_begin;
    const int s = it % kStages;
    const int qt0 = j * kBq;
    const uint32_t qs = base + C::kU + s * C::kStage;  // Q tile
    const uint32_t dos = qs + C::kTileBytes;            // dO tile
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, from shared memory into registers,
    // two groups: P^T is formed while dP^T still runs
    float st[kBq / 2], dpt[kBq / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBq, T>::ss(st, desc_kmajor(base + C::kX, kBlock, 64 * g, kk),
                        desc_kmajor(qs, kBq, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBq, T>::ss(dpt, desc_kmajor(base + C::kY, kBlock, 64 * g, kk),
                        desc_kmajor(dos, kBq, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T in place at each value's (k, q) (0 where masked), from the
    // tile's lse (log2 units) in the stage; the P of dV (dropped, scaled)
    // straight into its A fragments, the keep bits kept for dS
    const float* smem_stats = reinterpret_cast<const float*>(
        __cvta_shared_to_generic(base + C::kStats)) + s * 2 * kBq;
    uint32_t pa[kBq / 16][4], da[kBq / 16][4];
    uint32_t kept_bits = 0;
#pragma unroll
    for (int i = 0; i < kBq / 2; i += 2) {
      float pd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * ((i + e) >> 2) + cbase + ((i + e) & 1);
        const int qpos = qt0 + c;
        const int kpos = kbase + 8 * (((i + e) >> 1) & 1);
        float p = 0.f;
        if (qpos < sq && kpos < sk && !(causal && kpos > qpos))
          p = exp2_approx(fmaf(st[i + e], scale_log2, -smem_stats[c]));
        st[i + e] = p;
        pd[e] = p;
        if (kDrop) {
          const bool kept = ff::keep(drop, b, sq, sk, qpos, kpos);
          kept_bits |= static_cast<uint32_t>(kept) << (i + e);
          pd[e] = kept ? p * drop.inv_keep : 0.f;
        }
      }
      pa[i >> 3][(i >> 1) & 3] = pack2<T>(pd[0], pd[1]);
    }

    // dV += round(P)^T dO (A from registers, dO MN-major), running while
    // dS^T is formed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk)
      Wgmma<D, T>::rs(dv, pa[kk], desc_mnmajor(dos, kBq, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < kBq / 2; ++i) {
      const int c = 8 * (i >> 2) + cbase + (i & 1);
      float dp = dpt[i];
      if (kDrop) dp = (kept_bits >> i) & 1u ? dp * drop.inv_keep : 0.f;
      dpt[i] = st[i] * (dp - smem_stats[kBq + c]);  // 0 where P is masked
    }

    // dK += round(dS)^T Q: A from registers, Q MN-major
    acc_to_frags<T>(dpt, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk)
      Wgmma<D, T>::rs(dk, da[kk], desc_mnmajor(qs, kBq, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // keys no query sees leave the loop empty: dk = dv = 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = kbase + 8 * h;
    if (kpos >= sk) continue;
    const long long off = (static_cast<long long>(b) * sk + kpos) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int i = 4 * n + 2 * h;
      *reinterpret_cast<uint32_t*>(gk + off + 8 * n + cbase) =
          pack2<T>(dk[i] * scale, dk[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(gv + off + 8 * n + cbase) =
          pack2<T>(dv[i], dv[i + 1]);
    }
  }
}

// Pass 1: one block per (row, 128 keys). The producer loads K and V once
// and streams Q and dO tiles by TMA, with the tile's lse (log2 units) and
// delta, into the ring; under the causal mask it starts at the query tile
// that holds the block's first key.
template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ gk, T* __restrict__ gv, int sq,
                            int sk, int causal, float scale, float scale_log2,
                            ff::DropoutArgs drop_args) {
  const ff::Dropout drop = ff::load_dropout<kDrop>(drop_args);
  constexpr int kBq = kQRows<D>;
  using C = Tiles<D, kBq>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_own = base + C::kBar;
  const uint32_t bar_full = bar_own + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;
  const int j_begin = causal ? k0 / kBq : 0;
  const int n_q = (sq + kBq - 1) / kBq;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {
    producer_regs<kProducerRegs>();
    if (threadIdx.x < kProducer + 32) {
      const int lane = threadIdx.x - kProducer;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_own, 2 * C::kOwnBytes);
        tma_load_tile(base + C::kX, &tk, bar_own, kBlock, C::kHalves, k0, b);
        tma_load_tile(base + C::kY, &tv, bar_own, kBlock, C::kHalves, k0, b);
      }
      float* stats = reinterpret_cast<float*>(
          __cvta_shared_to_generic(base + C::kStats));
      for (int j = j_begin; j < n_q; ++j) {
        const int it = j - j_begin;
        const int s = it % kStages;
        if (it >= kStages)
          mbar_wait(bar_empty + 8 * s, (it / kStages - 1) & 1);
        for (int i = lane; i < kBq; i += 32) {
          const int qpos = j * kBq + i;
          const bool in = qpos < sq;
          const long long at = static_cast<long long>(b) * sq + qpos;
          stats[s * 2 * kBq + i] = in ? lse[at] * kLog2e : 0.f;
          stats[s * 2 * kBq + kBq + i] = in ? delta[at] : 0.f;
        }
        if (lane == 0) {
          const uint32_t qs = base + C::kU + s * C::kStage;
          mbar_arrive_expect_tx(bar_full + 8 * s, C::kStage);
          tma_load_tile(qs, &tq, bar_full + 8 * s, kBq, C::kHalves, j * kBq, b);
          tma_load_tile(qs + C::kTileBytes, &tdo, bar_full + 8 * s, kBq,
                        C::kHalves, j * kBq, b);
        } else {
          mbar_arrive(bar_full + 8 * s);  // after this lane's lse/delta
        }
      }
    }
  } else {
    consumer_regs<kConsumerRegs>();
    dkdv_consume<T, D, kDrop>(base, gk, gv, sq, sk, causal, scale, scale_log2,
                              drop, j_begin, n_q);
  }
}

// Pass 2, consumers: dQ for queries q0 + 64 g .. + 63 of warpgroup g over
// the streamed key tiles.
template <typename T, int D, bool kDrop>
__device__ __forceinline__ void dq_consume(
    uint32_t base, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ gq, int sq, int sk,
    int causal, float scale, float scale_log2, const ff::Dropout& drop,
    int n_k) {
  constexpr int kBk = kKRows<D>;
  using C = Tiles<D, kBk>;
  const uint32_t bar_own = base + C::kBar;
  const uint32_t bar_full = bar_own + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = warp >> 2;
  // accumulator value i: query row qbase + 8 ((i >> 1) & 1), column (key
  // of the tile, or head dim) 8 (i >> 2) + cbase + (i & 1)
  const int qbase = q0 + 64 * g + 16 * (warp & 3) + (lane >> 2);
  const int cbase = 2 * (lane & 3);
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = qbase + 8 * h;
    const long long at = static_cast<long long>(b) * sq + qpos;
    lse2[h] = qpos < sq ? lse[at] * kLog2e : 0.f;
    dl[h] = qpos < sq ? delta[at] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(bar_own, 0);
  for (int j = 0; j < n_k; ++j) {
    const int s = j % kStages;
    const int kt0 = j * kBk;
    const uint32_t ks = base + C::kU + s * C::kStage;  // K tile
    const uint32_t vs = ks + C::kTileBytes;             // V tile
    mbar_wait(bar_full + 8 * s, (j / kStages) & 1);

    // S = Q K^T and dP = dO V^T, from shared memory into registers, two
    // groups: P is formed while dP still runs
    float sc[kBk / 2], dp[kBk / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBk, T>::ss(sc, desc_kmajor(base + C::kX, kBlock, 64 * g, kk),
                        desc_kmajor(ks, kBk, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBk, T>::ss(dp, desc_kmajor(base + C::kY, kBlock, 64 * g, kk),
                        desc_kmajor(vs, kBk, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P in place at each value's (q, k), 0 where masked
#pragma unroll
    for (int i = 0; i < kBk / 2; ++i) {
      const int h = (i >> 1) & 1;
      const int kpos = kt0 + 8 * (i >> 2) + cbase + (i & 1);
      const int qpos = qbase + 8 * h;
      sc[i] = kpos < sk && qpos < sq && !(causal && kpos > qpos)
                  ? exp2_approx(fmaf(sc[i], scale_log2, -lse2[h]))
                  : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS in place
#pragma unroll
    for (int i = 0; i < kBk / 2; ++i) {
      const int h = (i >> 1) & 1;
      float dpv = dp[i];
      if (kDrop)
        dpv = ff::dropped(drop, b, sq, sk, qbase + 8 * h,
                          kt0 + 8 * (i >> 2) + cbase + (i & 1), dpv);
      sc[i] *= dpv - dl[h];
    }

    // dQ += round(dS) K: A from registers, K MN-major
    uint32_t da[kBk / 16][4];
    acc_to_frags<T>(sc, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
      Wgmma<D, T>::rs(dq, da[kk], desc_mnmajor(ks, kBk, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = qbase + 8 * h;
    if (qpos >= sq) continue;
    const long long off = (static_cast<long long>(b) * sq + qpos) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int i = 4 * n + 2 * h;
      *reinterpret_cast<uint32_t*>(gq + off + 8 * n + cbase) =
          pack2<T>(dq[i] * scale, dq[i + 1] * scale);
    }
  }
}

// Pass 2: one block per (row, 128 queries). The producer loads Q and dO
// once and streams K and V tiles by TMA; under the causal mask it stops
// at the block's last query.
template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ gq,
                          int sq, int sk, int causal, float scale,
                          float scale_log2, ff::DropoutArgs drop_args) {
  const ff::Dropout drop = ff::load_dropout<kDrop>(drop_args);
  constexpr int kBk = kKRows<D>;
  using C = Tiles<D, kBk>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_own = base + C::kBar;
  const uint32_t bar_full = bar_own + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const int kv_end = causal ? min(sk, q0 + kBlock) : sk;
  const int n_k = (kv_end + kBk - 1) / kBk;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {
    producer_regs<kProducerRegs>();
    if (threadIdx.x == kProducer) {
      mbar_arrive_expect_tx(bar_own, 2 * C::kOwnBytes);
      tma_load_tile(base + C::kX, &tq, bar_own, kBlock, C::kHalves, q0, b);
      tma_load_tile(base + C::kY, &tdo, bar_own, kBlock, C::kHalves, q0, b);
      for (int j = 0; j < n_k; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(bar_empty + 8 * s, (j / kStages - 1) & 1);
        const uint32_t ks = base + C::kU + s * C::kStage;
        mbar_arrive_expect_tx(bar_full + 8 * s, C::kStage);
        tma_load_tile(ks, &tk, bar_full + 8 * s, kBk, C::kHalves, j * kBk, b);
        tma_load_tile(ks + C::kTileBytes, &tv, bar_full + 8 * s, kBk,
                      C::kHalves, j * kBk, b);
      }
    }
  } else {
    consumer_regs<kConsumerRegs>();
    dq_consume<T, D, kDrop>(base, lse, delta, gq, sq, sk, causal, scale,
                            scale_log2, drop, n_k);
  }
}

}  // namespace wg

// path codes shared with kernels/attention.py `flash_path`
enum Path : int { kRows = 0, kWmma = 1, kWgmma = 2 };

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *gq, *gk, *gv;
  int bh, sq, sk, d, dv, causal;
  float scale;
  ff::DropoutArgs drop;
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
cudaError_t launch_wmma(const Args& a, int device) {
  if (a.d % 16 || a.dv % 16) return cudaErrorInvalidValue;
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

// The delta pre-pass, then both passes on the wgmma path. Eight tensor
// maps: each operand as the block's own tile (128 rows) and as the
// streamed tile of the pass that walks it.
template <typename T, int D, bool kDrop>
cudaError_t launch_wgmma(const Args& a, int dtype) {
  constexpr int kBq = wg::kQRows<D>;
  constexpr int kBk = wg::kKRows<D>;
  using C1 = wg::Tiles<D, kBq>;
  using C2 = wg::Tiles<D, kBk>;
  const struct {
    const void* p;
    int s, rows;
  } spec[8] = {{a.q, a.sq, kBq},         {a.k, a.sk, wg::kBlock},
               {a.v, a.sk, wg::kBlock},  {a.dout, a.sq, kBq},
               {a.q, a.sq, wg::kBlock},  {a.k, a.sk, kBk},
               {a.v, a.sk, kBk},         {a.dout, a.sq, wg::kBlock}};
  CUtensorMap m[8];
  for (int i = 0; i < 8; ++i) {
    const cudaError_t e = ff::sm90::tma_map_3d(&m[i], spec[i].p, dtype, D,
                                               spec[i].s, a.bh, spec[i].rows);
    if (e != cudaSuccess) return e;
  }
  cudaError_t err = cudaFuncSetAttribute(
      wg::flash_bwd_dkdv_wgmma_kernel<T, D, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C1::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wg::flash_bwd_dq_wgmma_kernel<T, D, kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C2::kSmem);
  if (err != cudaSuccess) return err;
  err = launch_delta<T>(a);
  if (err != cudaSuccess) return err;
  const float scale_log2 = a.scale * wg::kLog2e;
  wg::flash_bwd_dkdv_wgmma_kernel<T, D, kDrop>
      <<<dim3((a.sk + wg::kBlock - 1) / wg::kBlock, a.bh), wg::kThreads,
         C1::kSmem, a.stream>>>(m[0], m[1], m[2], m[3], a.lse, a.delta,
                                static_cast<T*>(a.gk), static_cast<T*>(a.gv),
                                a.sq, a.sk, a.causal, a.scale, scale_log2,
                                a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wg::flash_bwd_dq_wgmma_kernel<T, D, kDrop>
      <<<dim3((a.sq + wg::kBlock - 1) / wg::kBlock, a.bh), wg::kThreads,
         C2::kSmem, a.stream>>>(m[4], m[5], m[6], m[7], a.lse, a.delta,
                                static_cast<T*>(a.gq), a.sq, a.sk, a.causal,
                                a.scale, scale_log2, a.drop);
  return cudaGetLastError();
}

// a 16-bit launch on the path asked for; a shape the path does not take
// is refused, never sent elsewhere
template <typename T, bool kDrop>
cudaError_t launch(const Args& a, int device, int dtype, int path) {
  switch (path) {
    case kRows:
      return launch_rows<T, kDrop>(a);
    case kWmma:
      return launch_wmma<T, kDrop>(a, device);
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
cudaError_t dispatch(int dtype, int path, const Args& a, int device) {
  switch (dtype) {
    case ff::kF32:
      return path == kRows ? launch_rows<float, kDrop>(a)
                           : cudaErrorInvalidValue;
    case ff::kF16:
      return launch<__half, kDrop>(a, device, dtype, path);
    case ff::kBF16:
      return launch<__nv_bfloat16, kDrop>(a, device, dtype, path);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// delta is scratch of bh * sq floats; gq, gk, gv receive dq, dk, dv.
// seeds, threshold, inv_keep: the forward's dropout (flash_fwd.cu);
// path: kRows, kWmma or kWgmma.
extern "C" int ff_flash_bwd(int device, int dtype, const void* q,
                            const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta,
                            void* gq, void* gk, void* gv, int bh, int sq,
                            int sk, int d, int dv, int causal, float scale,
                            const unsigned int* seeds,
                            unsigned int threshold, float inv_keep,
                            int path, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 1 || dv < 1 ||
      d > kMaxDim || dv > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q,  k,  v,  o,  dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), gq, gk, gv, bh, sq, sk, d, dv,
               causal, scale, ff::DropoutArgs{seeds, threshold, inv_keep},
               static_cast<cudaStream_t>(stream)};
  err = threshold ? dispatch<true>(dtype, path, a, device)
                  : dispatch<false>(dtype, path, a, device);
  return static_cast<int>(err);
}

// Dynamic shared memory of a wgmma launch of pass 1 (dK/dV) or 2 (dQ) at
// head dim d (64 or 128), for the build report; 0 otherwise.
extern "C" int ff_flash_bwd_wgmma_smem(int pass, int d) {
  if (d != 64 && d != 128) return 0;
  if (pass == 1)
    return d == 64 ? wg::Tiles<64, wg::kQRows<64>>::kSmem
                   : wg::Tiles<128, wg::kQRows<128>>::kSmem;
  if (pass == 2)
    return d == 64 ? wg::Tiles<64, wg::kKRows<64>>::kSmem
                   : wg::Tiles<128, wg::kKRows<128>>::kSmem;
  return 0;
}
