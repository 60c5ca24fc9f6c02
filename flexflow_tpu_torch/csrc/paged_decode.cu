// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel flexflow_tpu/kernels/decode.py
// `_paged_decode_kernel` (driven by `paged_flash_decode`): one query token
// per slot attends over a paged K/V pool with an online softmax; pages at
// or past the slot's length are never touched, so table entries past the
// live pages are never dereferenced.
//
// Layouts (element strides; the last axis of every operand is contiguous):
//   q      (slots, heads, d)                      contiguous
//   k / v  (heads, num_pages, page_size, d|dv)    strides (sh, sp, st, 1) —
//          the serving path passes a strided VIEW of the dense per-slot
//          caches (paged_view_of_cache), so no pool copy is ever made
//   table  (slots, pages_per_slot) int32; lengths (slots,) int32
//   out    (slots, heads, dv) in q's dtype; all arithmetic in f32.
//
// Bound on the H100: memory. The work is ~4 flops per K/V element read,
// far below the card's ~295 flop/byte ridge, so the least time is the live
// K/V bytes over 3.35 TB/s (8 slots x 512 tokens x 16 heads x 64 x 2
// tensors x 2 B = 16.8 MB per layer: ~5 us).
//
// Design: one block per (head, slot), 8 warps. The TPU walks a slot's
// pages in order on one core with (m, l, acc) in VMEM scratch; here the
// block splits the slot's live positions over its warps (warp w takes
// positions w*4 .. w*4+3, then strides by 32), each warp keeps its own
// online-softmax state in registers with 4 positions in flight to overlap
// loads, and the 8 partial states merge through shared memory once at the
// end. Lanes split the head dim (d, dv <= 256: 8 values per lane).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTok = 4;          // positions in flight per warp
constexpr int kLaneVals = 8;     // head dims per lane: d, dv <= 256

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int heads, int d, int dv, int page_size, int pages_per_slot,
                    long long k_sh, long long k_sp, long long k_st,
                    long long v_sh, long long v_sp, long long v_st,
                    float scale) {
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* table, const int* lengths, void* out, int slots,
                   int heads, int d, int dv, int page_size, int pages_per_slot,
                   long long k_sh, long long k_sp, long long k_st,
                   long long v_sh, long long v_sp, long long v_st, float scale,
                   cudaStream_t stream) {
  const dim3 grid(heads, slots);
  const size_t smem = sizeof(float) * kWarps * (2 + dv);
  paged_decode_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, lengths, static_cast<T*>(out), heads, d,
      dv, page_size, pages_per_slot, k_sh, k_sp, k_st, v_sh, v_sp, v_st,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ff_paged_decode(int device, int dtype, const void* q,
                               const void* k, const void* v, const void* table,
                               const void* lengths, void* out, int slots,
                               int heads, int d, int dv, int page_size,
                               int pages_per_slot, long long k_sh,
                               long long k_sp, long long k_st, long long v_sh,
                               long long v_sp, long long v_st, float scale,
                               void* stream) {
  if (d < 1 || dv < 1 || d > 32 * kLaneVals || dv > 32 * kLaneVals ||
      slots < 1 || heads < 1 || slots > 65535 || page_size < 1 ||
      pages_per_slot < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ff::kF32:
      err = launch<float>(q, k, v, tb, ln, out, slots, heads, d, dv, page_size,
                          pages_per_slot, k_sh, k_sp, k_st, v_sh, v_sp, v_st,
                          scale, st);
      break;
    case ff::kF16:
      err = launch<__half>(q, k, v, tb, ln, out, slots, heads, d, dv,
                           page_size, pages_per_slot, k_sh, k_sp, k_st, v_sh,
                           v_sp, v_st, scale, st);
      break;
    case ff::kBF16:
      err = launch<__nv_bfloat16>(q, k, v, tb, ln, out, slots, heads, d, dv,
                                  page_size, pages_per_slot, k_sh, k_sp, k_st,
                                  v_sh, v_sp, v_st, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
