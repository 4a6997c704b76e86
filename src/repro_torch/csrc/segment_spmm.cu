// ELL segment-SpMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segment_spmm/kernel.py::segment_spmm_pallas
// (body _spmm_kernel). Called by GIN's full-graph forward, one launch per
// layer, and by its backward on the transposed table (the gradient of an
// ELL SpMM over feat is the same SpMM over the transposed adjacency), so
// one kernel serves both directions with no atomics.
//
//   out[i] = Σ_{n = 0..Dmax-1, ids[i,n] >= 0} w[i,n] · feat[min(ids, M-1)]
//   w = weights[i,n] (fp32), or 1 without weights
//
// The sum is taken in fp32, sequentially over n = 0, 1, ..., Dmax-1, then
// cast to feat's dtype. A weighted step is one fused multiply-add,
// acc = fma(row, w, acc) (__fmaf_rn): XLA compiles the Pallas body's
// acc + row * w to exactly that. An unweighted step is acc + row
// (__fadd_rn, so no contraction can change it). That is the arithmetic of
// the Pallas body and of the plain version (kernels/segment_spmm/ref.py),
// so kernel == plain bitwise. A padded id (any negative) may stand
// anywhere in a row and reads no row: its Pallas term row·0 is ±0, which
// leaves an fp32 sum unchanged.
//
// Bound on an H100: HBM bytes. Per call it must read the ids (4 bytes
// each), the weights when given, each referenced feat row once, and write
// each output row once. In practice each feat row is gathered once per
// edge (about 25 times on ogb_products) from a table larger than the
// 50 MB L2, so the bytes that really move are ~nnz·d·elem.
// Design against that: the Pallas body's sequential grid with a VMEM
// (R, d) scratch became one warp per output row, lanes along d: a
// neighbour row is read as contiguous 128-byte spans, up to kColsPerLane
// independent loads in flight per lane. The warp loads 32 of its row's
// ids (and weights) at once, one per lane, and broadcasts them in order
// with __shfl_sync, so the Dmax loop stays in order and warp-uniform. Each
// lane keeps kColsPerLane fp32 register accumulators; columns past d (d =
// 100 on ogb_products) are masked. No partial sum is written to memory
// and no atomics are used.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;         // output rows (warps) per block
constexpr int kColsPerLane = 4;   // a pass covers 32 * 4 = 128 columns
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kWarps * 32)
    segment_spmm_kernel(const int32_t* __restrict__ ids,
                        const T* __restrict__ weights,
                        const T* __restrict__ feat, int64_t rows,
                        T* __restrict__ out, int64_t n, int64_t dmax,
                        int64_t d) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // row is warp-uniform: whole warps leave
  const int32_t* row_ids = ids + row * dmax;
  const T* row_w = kWeighted ? weights + row * dmax : nullptr;
  T* out_row = out + row * d;
  for (int64_t c0 = 0; c0 < d; c0 += 32 * kColsPerLane) {
    float acc[kColsPerLane];
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) acc[q] = 0.0f;
    for (int64_t base = 0; base < dmax; base += 32) {
      const int64_t k = base + lane;
      const int32_t my_id = k < dmax ? row_ids[k] : -1;
      const float my_w = (kWeighted && k < dmax) ? to_f32(row_w[k]) : 0.0f;
      const int span = static_cast<int>(dmax - base < 32 ? dmax - base : 32);
      for (int j = 0; j < span; ++j) {
        const int32_t id = __shfl_sync(kFull, my_id, j);
        const float w = kWeighted ? __shfl_sync(kFull, my_w, j) : 0.0f;
        if (id < 0) continue;  // warp-uniform: the id is broadcast
        const int64_t r = id < rows ? static_cast<int64_t>(id) : rows - 1;
        const T* src = feat + r * d;
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) {
          const int64_t c = c0 + q * 32 + lane;
          if (c < d) {
            const float v = to_f32(src[c]);
            acc[q] = kWeighted ? __fmaf_rn(v, w, acc[q])
                               : __fadd_rn(acc[q], v);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) {
      const int64_t c = c0 + q * 32 + lane;
      if (c < d) out_row[c] = from_f32<T>(acc[q]);
    }
  }
}

template <typename T>
int launch(const void* ids_v, const void* weights_v, const void* feat_v,
           int64_t rows, void* out_v, int64_t n, int64_t dmax, int64_t d,
           int weighted, void* stream_v) {
  const auto* ids = static_cast<const int32_t*>(ids_v);
  const auto* weights = static_cast<const T*>(weights_v);
  const auto* feat = static_cast<const T*>(feat_v);
  auto* out = static_cast<T*>(out_v);
  const auto stream = static_cast<cudaStream_t>(stream_v);
  const auto blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  if (weighted) {
    segment_spmm_kernel<T, true><<<blocks, kWarps * 32, 0, stream>>>(
        ids, weights, feat, rows, out, n, dmax, d);
  } else {
    segment_spmm_kernel<T, false><<<blocks, kWarps * 32, 0, stream>>>(
        ids, weights, feat, rows, out, n, dmax, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int segment_spmm_f32(const void* ids, const void* weights,
                                const void* feat, int64_t rows, void* out,
                                int64_t n, int64_t dmax, int64_t d,
                                int weighted, void* stream) {
  return launch<float>(ids, weights, feat, rows, out, n, dmax, d, weighted,
                       stream);
}

extern "C" int segment_spmm_bf16(const void* ids, const void* weights,
                                 const void* feat, int64_t rows, void* out,
                                 int64_t n, int64_t dmax, int64_t d,
                                 int weighted, void* stream) {
  return launch<__nv_bfloat16>(ids, weights, feat, rows, out, n, dmax, d,
                               weighted, stream);
}
